"""The two hand-written kernels' plain PyTorch versions against the Pallas
kernels they replace (run in interpret mode, as tests/test_pallas_*.py do),
and the CPU side of the device dispatch rules. The kernels themselves are
held against their plain versions on the card by ``test_torch_cuda.py``.

Kernel A: ``ops.linalg.kkt_inverse`` (L^{-1} of SPD matrices) vs
``pallas_chol.cholesky_inverse(interpret=True, interleave=True)``, the
schedule the JAX package runs, and vs its three other schedules.
Kernel B: ``ops.cuda_proj.line_polytope_projection`` vs
``pallas_proj.line_polytope_projection(interpret=True)``.

Tolerances: float64 1e-12 (same algorithm, summation order only). float32
kernel A 2e-5 relative to max|L^{-1}|: the row-inverse sums run in another
order than the Pallas kernel's, and the error grows with n and the
condition number (measured below 4e-6 at n = 136). float32 kernel B 1e-5:
Dykstra contracts, so the order differences stay at a few ulps of the
O(1) coordinates.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from boundplanner_tpu.ops.pallas_chol import cholesky_inverse
from boundplanner_tpu.ops import pallas_proj
from boundplanner_tpu_torch.ops import cuda_proj
from boundplanner_tpu_torch.ops.linalg import chol_inverse_smem, kkt_inverse, kkt_inverse_plain
from test_torch_cuda import planner_batch, spd, tick_batch

torch.set_num_threads(1)


# ---------------------------------------------------------------- kernel A


@pytest.mark.parametrize("n", [16, 40, 136])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_chol_inverse_matches_pallas(n, dtype):
    ks = spd(np.random.default_rng(n), 4, n).astype(dtype)
    ref = np.asarray(cholesky_inverse(jnp.asarray(ks), interpret=True, interleave=True))
    got = kkt_inverse(torch.from_numpy(ks)).numpy()       # CPU -> plain version
    tol = 1e-12 if dtype == "float64" else 2e-5
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)
    assert np.all(np.triu(got, 1) == 0.0)                  # exactly lower-triangular


SCHEDULES = {
    "rank1_full": dict(two_d=False, rank2=False),
    "rank1_2d": dict(two_d=True, rank2=False),
    "rank2": dict(rank2=True),
    "interleave": dict(interleave=True),
}


@pytest.mark.parametrize("n", [8, 16, 24])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_plain_chol_inverse_matches_pallas_schedules(schedule, n):
    """Every schedule of the one TPU function (`pallas_chol.py` `_kernel`
    full and two_d, `_kernel_r2`, `_kernel_il`) computes the L^{-1} that
    kernel A's plain version computes: kernel A is the counterpart of all
    four. float64, the tolerance of the test above."""
    ks = spd(np.random.default_rng(100 + n), 3, n)
    ref = np.asarray(cholesky_inverse(jnp.asarray(ks), interpret=True, **SCHEDULES[schedule]))
    got = kkt_inverse(torch.from_numpy(ks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert np.all(np.triu(ref, 1) == 0.0) and np.all(np.triu(got, 1) == 0.0)


@pytest.mark.parametrize("n,itemsize,size", [(136, 4, 87584), (136, 8, 170816),
                                             (3, 4, 1328), (226, 4, 232448)])
def test_chol_inverse_smem_counts_padded_layout(n, itemsize, size):
    """The wrapper's shared-memory check counts kernel A's padded layout:
    rows of ceil8(n) + 16 bytes, the 8-wide panel, the row block in rows
    of 8 + 16 bytes, the next diagonal block's factor and inverse."""
    assert chol_inverse_smem(n, itemsize) == size


def test_chol_inverse_smem_limit_in_float64():
    """n = 160 fits one block's 227 KB in float64 and n = 161 does not:
    past it the wrapper refuses a CUDA tensor."""
    assert chol_inverse_smem(160, 8) <= 232448 < chol_inverse_smem(161, 8)


def test_plain_chol_inverse_non_pd_clamp_matches_pallas():
    """Non-PD inputs. Where the pivot clamp sqrt(max(d, 1e-30)) keeps the
    factor finite (negative or zero pivots over zero columns), both give
    the same finite values. Where the clamped pivots overflow (indefinite
    with off-diagonal mass) or the input holds a NaN, the two schedules
    spread non-finite values over different entries, but every such
    matrix is non-finite in both: that per-matrix flag is what the IPM's
    finite-step mask reads (`ops/qp.py:343-354`)."""
    rng = np.random.default_rng(7)
    ks = spd(rng, 6, 16) - 40.0 * np.eye(16)               # 0, 3: overflow
    ks[1] = np.diag(np.r_[1.0, -1.0, np.ones(14)])         # one negative pivot
    ks[2] = 0.0                                            # every pivot clamped
    ks[4] = np.eye(16)
    ks[4][3, 3] = np.nan                                   # NaN input
    ks[5] = 0.0
    ks[5][:8, :8] = spd(rng, 1, 8)[0]                      # rank-deficient PSD
    ref = np.asarray(cholesky_inverse(jnp.asarray(ks), interpret=True, interleave=True))
    got = kkt_inverse(torch.from_numpy(ks)).numpy()
    flags = lambda x: np.isfinite(x).all(axis=(1, 2))
    np.testing.assert_array_equal(flags(got), flags(ref))
    np.testing.assert_array_equal(flags(ref), [False, True, True, False, False, True])
    clamp = [1, 2, 5]
    np.testing.assert_allclose(got[clamp], ref[clamp], rtol=1e-12, atol=0)
    assert np.abs(got[2]).max() == pytest.approx(1e15)     # 1 / sqrt(1e-30)


def test_kkt_inverse_cpu_takes_plain_without_launch():
    ks = torch.from_numpy(spd(np.random.default_rng(1), 3, 8))
    before = kkt_inverse.launches
    np.testing.assert_array_equal(kkt_inverse(ks).numpy(), kkt_inverse_plain(ks).numpy())
    assert kkt_inverse.launches == before


# ---------------------------------------------------------------- kernel B


def make_batch(rng, bsz=24, r_rows=15):
    """The problems of tests/test_pallas_proj.py."""
    a = np.zeros((bsz, r_rows, 3))
    b = 10.0 * np.ones((bsz, r_rows))
    p0 = np.zeros((bsz, 3))
    p1 = np.zeros((bsz, 3))
    for i in range(bsz):
        center = rng.uniform(-0.5, 0.5, 3)
        half = rng.uniform(0.1, 0.3, 3)
        eye = np.eye(3)
        a[i, :6] = np.vstack([eye, -eye])
        b[i, :6] = np.concatenate([center + half, -(center - half)])
        p0[i] = center + rng.uniform(0.5, 1.0, 3) * rng.choice([-1, 1], 3)
        p1[i] = p0[i] + rng.uniform(-0.5, 0.5, 3)
    return a, b, p0, p1


def inside_case():
    eye = np.eye(3)
    return (np.vstack([eye, -eye])[None], np.ones((1, 6)) * 0.5,
            np.array([[-1.0, 0.0, 0.0]]), np.array([[1.0, 0.0, 0.0]]))


CASES = {
    "pallas_test_batch": lambda: make_batch(np.random.default_rng(0)),
    "inside_segment": inside_case,
    "tick_fold": lambda: tick_batch(np.random.default_rng(3)),
    "planner_fold": lambda: planner_batch(np.random.default_rng(5), 2),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_line_polytope_matches_pallas(case, dtype):
    args = [np.ascontiguousarray(x, dtype=dtype) for x in CASES[case]()]
    xj, phij, dj = (np.asarray(t) for t in pallas_proj.line_polytope_projection(
        *map(jnp.asarray, args), interpret=True))
    xt, phit, dt = (t.numpy() for t in cuda_proj.line_polytope_projection(
        *map(torch.from_numpy, args)))                    # CPU -> plain version
    tol = 1e-12 if dtype == "float64" else 1e-5
    for j, t in ((xj, xt), (phij, phit), (dj, dt)):
        np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def test_seg_poly_closest_f64_matches_jax_ipm():
    """Off the card (and in f64 anywhere) both packages run the exact
    25-iteration IPM; the port's batched IPM matches JAX's vmapped one."""
    a, b, p0, p1 = tick_batch(np.random.default_rng(4), scenes=1)
    xj, phij = pallas_proj.seg_poly_closest(*map(jnp.asarray, (a, b, p0, p1)))
    xt, phit = cuda_proj.seg_poly_closest(*map(torch.from_numpy, (a, b, p0, p1)))
    # 25 IPM iterations through explicit inverses; where the segment runs
    # parallel to a face the closest pair is not unique and phi sits in a
    # flat valley, so summation-order differences grow to ~2e-8 there
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-7)
    np.testing.assert_allclose(phit.numpy(), np.asarray(phij), rtol=0, atol=1e-7)


def test_seg_poly_closest_cpu_f32_takes_ipm():
    args = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
            for x in make_batch(np.random.default_rng(5), bsz=6)]
    before = cuda_proj.line_polytope_projection.launches
    x, phi = cuda_proj.seg_poly_closest(*args)
    x_ipm, phi_ipm = cuda_proj._seg_closest_ipm(*args)
    np.testing.assert_array_equal(x.numpy(), x_ipm.numpy())
    np.testing.assert_array_equal(phi.numpy(), phi_ipm.numpy())
    assert cuda_proj.line_polytope_projection.launches == before

