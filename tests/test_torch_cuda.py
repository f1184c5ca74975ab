"""The two hand-written CUDA kernels against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and skips without one.

The port runs without JAX, and so does this file; it also holds the
seeded input generators that ``test_torch_kernels.py`` shares. On the
card, run it without the JAX-only ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: float64 1e-12 (same algorithm, summation order only). float32
kernel A 2e-5 relative to max|L^{-1}| (the kernel sums the row-inverse
products in another order than the plain version). float32 kernel B 1e-4
absolute (FMA contraction in the kernel's dot products; Dykstra contracts,
so the differences stay at a few ulps of the O(1) coordinates).
"""

import numpy as np
import pytest
import torch

from boundplanner_tpu_torch.ops import cuda_proj
from boundplanner_tpu_torch.ops.linalg import kkt_inverse, kkt_inverse_plain


def spd(rng, bsz, n):
    a = rng.normal(size=(bsz, n, n))
    return a @ a.transpose(0, 2, 1) + n * np.eye(n)


def tick_batch(rng, scenes=2, links=6, n_obs=16, n_active=4):
    """A tick's fold: scenes x links x obstacles problems, active boxes with
    9 zero-padded rows, inactive obstacles (a = 0), all b shifted by -0.001
    as `set_finder.find_set_line` does."""
    count = scenes * links * n_obs
    a = np.zeros((count, 15, 3))
    b = np.full((count, 15), 10.0)
    p0 = np.zeros((count, 3))
    p1 = np.zeros((count, 3))
    for i in range(count):
        if i % n_obs < n_active:
            center = rng.uniform(-0.5, 0.5, 3)
            half = rng.uniform(0.05, 0.2, 3)
            a[i, :6] = np.vstack([np.eye(3), -np.eye(3)])
            b[i, :6] = np.concatenate([center + half, -(center - half)])
        if i % n_obs == 0:
            s0 = rng.uniform(-0.8, 0.8, 3)
            s1 = s0 + rng.uniform(-0.2, 0.2, 3)
        p0[i], p1[i] = s0, s1
    return a, b - 0.001, p0, p1


@pytest.fixture
def cuda_device():
    """The card, or a skip: these tests compare a CUDA kernel with its
    plain version and cannot run without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [128, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_chol_inverse_matches_plain(cuda_device, bsz, dtype):
    ks = torch.from_numpy(spd(np.random.default_rng(bsz), bsz, 136)).to(cuda_device, dtype)
    before = kkt_inverse.launches
    got = kkt_inverse(ks)
    assert kkt_inverse.launches == before + 1
    ref = kkt_inverse_plain(ks)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert (torch.triu(got, 1) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("count", [12288, 1])
def test_cuda_line_polytope_matches_plain(cuda_device, count):
    a, b, p0, p1 = tick_batch(np.random.default_rng(count), scenes=128, links=6)
    args = [torch.from_numpy(np.ascontiguousarray(x[:count], dtype=np.float32)).to(cuda_device)
            for x in (a, b, p0, p1)]
    before = cuda_proj.line_polytope_projection.launches
    got = cuda_proj.line_polytope_projection(*args)
    assert cuda_proj.line_polytope_projection.launches == before + 1
    ref = cuda_proj.line_polytope_projection_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_seg_poly_closest_dispatch(cuda_device):
    """On the card, float32 runs kernel B and float64 the exact IPM (which
    launches kernel A, never kernel B)."""
    a, b, p0, p1 = (torch.from_numpy(x).to(cuda_device)
                    for x in tick_batch(np.random.default_rng(2), scenes=1))
    before = cuda_proj.line_polytope_projection.launches
    cuda_proj.seg_poly_closest(a.float(), b.float(), p0.float(), p1.float())
    assert cuda_proj.line_polytope_projection.launches == before + 1
    cuda_proj.seg_poly_closest(a, b, p0, p1)
    assert cuda_proj.line_polytope_projection.launches == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input(cuda_device):
    k = torch.eye(8, device=cuda_device)[None].repeat(2, 1, 1)
    with pytest.raises(ValueError):
        kkt_inverse(k.transpose(1, 2))                     # not contiguous
    with pytest.raises(TypeError):
        kkt_inverse(k.half())
    a = torch.zeros(4, 17, 3, device=cuda_device)
    with pytest.raises(ValueError):                         # more than 16 rows
        cuda_proj.line_polytope_projection(
            a, a[..., 0], a[:, 0], a[:, 0])
    a = a[:, :15].double().contiguous()
    with pytest.raises(TypeError):                          # kernel B is float32 only
        cuda_proj.line_polytope_projection(
            a, a[..., 0].contiguous(), a[:, 0].contiguous(), a[:, 0].contiguous())
