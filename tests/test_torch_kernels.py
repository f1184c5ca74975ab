"""The hand-written kernels' plain PyTorch versions against the Pallas
kernels they replace (run in interpret mode, as tests/test_pallas_*.py do),
and the CPU side of the device dispatch rules. The kernels themselves are
held against their plain versions on the card by ``test_torch_cuda.py``.

Kernel A: ``ops.linalg.kkt_inverse`` (L^{-1} of SPD matrices) vs
``pallas_chol.cholesky_inverse(interpret=True, interleave=True)``, the
schedule the JAX package runs, and vs its three other schedules.
Kernel B: ``ops.cuda_proj.line_polytope_projection`` vs
``pallas_proj.line_polytope_projection(interpret=True)``, and a scalar
emulation of the CUDA kernel's control flow (no-op rows dropped, exits at
both fixed points) against the plain version by value: the shortcuts the
kernel takes change no output.

Tolerances: float64 1e-12 (same algorithm, summation order only). float32
kernel A 2e-5 relative to max|L^{-1}|: the row-inverse sums run in another
order than the Pallas kernel's, and the error grows with n and the
condition number (measured below 4e-6 at n = 136). float32 kernel B 1e-5:
Dykstra contracts, so the order differences stay at a few ulps of the
O(1) coordinates.

Kernel C (``ops.linalg.kkt_gram``, the dense IPM's KKT matrix) replaces no
Pallas kernel: on the CPU it is today's expression bit for bit; its input
checks, its launch geometry and ``solve_qp``'s rule for taking it are
tested here.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from boundplanner_tpu.ops.pallas_chol import cholesky_inverse
from boundplanner_tpu.ops import pallas_proj
from boundplanner_tpu_torch.ops import cuda_proj
from boundplanner_tpu_torch.ops import linalg
from boundplanner_tpu_torch.ops.linalg import chol_inverse_smem, kkt_inverse, kkt_inverse_plain
from boundplanner_tpu_torch.ops.proj_chain import replay
from test_torch_cuda import EDGE_FINITE, edge_batch, planner_batch, spd, tick_batch

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
    "edge_cases": edge_batch,
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


def kernel_b_emulation(a, b, p0, p1):
    """Kernel B's control flow (``csrc/line_polytope.cu``), one problem at
    a time in scalars of the inputs' dtype: the no-op zero rows dropped
    (a = +-0, b NaN or >= -1e26), each Dykstra call stopped after its
    first sweep that leaves y and every correction unchanged by value, the
    outer loop stopped once an iteration returns its input by value. Each
    kept row's arithmetic is the plain version's (sums left to right, IEEE
    division, the kernel's clamp). Returns (x (P, 3), phi (P,), row
    corrections per problem (P,))."""
    dt = a.dtype.type
    zero, one, floor = dt(0), dt(1), dt(1e-12)
    dot = lambda u, v: (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]
    xs, phis, chains = [], [], []
    for a_p, b_p, s0, s1 in zip(a, b, p0, p1):
        rows = [(a_r, b_r) for a_r, b_r in zip(a_p, b_p)
                if not (a_r[0] == 0 and a_r[1] == 0 and a_r[2] == 0 and not b_r < -1e26)]
        norms = [n2 if n2 > floor else floor for n2 in (dot(a_r, a_r) for a_r, _ in rows)]
        d = [s1[i] - s0[i] for i in range(3)]
        dd = dot(d, d)
        denom = dd if dd > floor else floor
        chain = 0

        def dykstra(y):
            nonlocal chain
            e = [[zero] * 3 for _ in rows]
            for _ in range(cuda_proj.DYKSTRA_SWEEPS):
                before, same = list(y), True
                for k, ((a_r, b_r), n2) in enumerate(zip(rows, norms)):
                    w = [y[i] + e[k][i] for i in range(3)]
                    viol = (dot(a_r, w) - b_r) / n2
                    t = viol if viol > zero else zero
                    s = [t * a_r[i] for i in range(3)]
                    same = same and all(s[i] == e[k][i] for i in range(3))
                    e[k] = s
                    y = [w[i] - s[i] for i in range(3)]
                    chain += 1
                if same and all(y[i] == before[i] for i in range(3)):
                    break
            return y

        def seg_phi(x):
            phi = dot([x[i] - s0[i] for i in range(3)], d) / denom
            return zero if phi < zero else (one if phi > one else phi)

        x = dykstra(list(s0))
        for _ in range(cuda_proj.OUTER_ITERS):
            phi = seg_phi(x)
            z = dykstra([s0[i] + phi * d[i] for i in range(3)])
            fixed = all(z[i] == x[i] for i in range(3))
            x = z
            if fixed:
                break
        xs.append(x)
        phis.append(seg_phi(x))
        chains.append(chain)
    return np.array(xs, dtype=dt), np.array(phis, dtype=dt), np.array(chains)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernel_b_shortcuts_equal_plain_by_value(case, dtype):
    """Dropping the no-op rows and stopping at both fixed points changes
    no output by value: the emulation of kernel B's control flow gives the
    plain version's x, phi and dist (same NaNs), while it runs fewer row
    corrections than the full 11 x 4 x R chain."""
    args = [np.ascontiguousarray(x, dtype=dtype) for x in CASES[case]()]
    with np.errstate(invalid="ignore", over="ignore"):
        x, phi, chain = kernel_b_emulation(*args)
    ta = [torch.from_numpy(t) for t in args]
    xp, phip, dp = cuda_proj.line_polytope_projection_plain(*ta)
    seg = ta[2] + torch.from_numpy(phi)[:, None] * (ta[3] - ta[2])
    dist = torch.linalg.vector_norm(torch.from_numpy(x) - seg, dim=-1)   # the plain's norm
    np.testing.assert_array_equal(x, xp.numpy())
    np.testing.assert_array_equal(phi, phip.numpy())
    np.testing.assert_array_equal(dist.numpy(), dp.numpy())
    count, rows = args[1].shape
    assert chain.sum() < (1 + cuda_proj.OUTER_ITERS) * cuda_proj.DYKSTRA_SWEEPS * rows * count
    if case == "edge_cases":
        finite = np.isfinite(x).all(axis=1) & np.isfinite(phi) & np.isfinite(dist.numpy())
        assert finite.tolist() == EDGE_FINITE[dtype]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_proj_chain_replay_matches_emulation(case, dtype):
    """``ops.proj_chain.replay`` (vectorized, used to count the chain on a
    fleet's tick) runs the same control flow as the scalar emulation: the
    same x and phi by value and the same row corrections per problem."""
    args = [np.ascontiguousarray(x, dtype=dtype) for x in CASES[case]()]
    with np.errstate(invalid="ignore", over="ignore"):
        x, phi, chain = kernel_b_emulation(*args)
    xr, phir, counts = replay(*args)
    np.testing.assert_array_equal(xr, x)
    np.testing.assert_array_equal(phir, phi)
    np.testing.assert_array_equal(counts["chain"], chain)


def test_zero_row_with_huge_negative_b_gives_nan():
    """A zero row with b = -1e30 is no no-op in float32: -b / 1e-12
    overflows to inf and inf * 0 is NaN, in the Pallas kernel, the plain
    version and the kernel's control flow alike (the kernel keeps the
    row). At b = -1e25 the same row changes nothing."""
    a, b, p0, p1 = (np.ascontiguousarray(x[:2], dtype=np.float32) for x in edge_batch())
    b[0, 6] = -1e25                       # problem 0: the same rows at b = -1e25
    a[0, 7], b[0, 7] = 0.0, 10.0
    b[1, 6] = -1e30
    xj, phij, dj = (np.asarray(t) for t in pallas_proj.line_polytope_projection(
        *map(jnp.asarray, (a, b, p0, p1)), interpret=True))
    xt, phit, dt = (t.numpy() for t in cuda_proj.line_polytope_projection_plain(
        *map(torch.from_numpy, (a, b, p0, p1))))
    with np.errstate(invalid="ignore", over="ignore"):
        xe, phie, _ = kernel_b_emulation(a, b, p0, p1)
    for out in ((xj, phij, dj), (xt, phit, dt), (xe, phie)):
        assert all(np.isfinite(o[0]).all() for o in out)
        assert all(np.isnan(o[1]).all() for o in out)


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



# ---------------------------------------------------------------- kernel C


def gram_case(rng, bsz=2, m=40, n=70):
    g = torch.from_numpy(rng.normal(size=(bsz, m, n)))
    w = torch.from_numpy(10.0 ** rng.uniform(-6.0, 6.0, size=(bsz, m)))
    p = torch.from_numpy(spd(rng, bsz, n))
    return p, g, w


def test_kkt_gram_cpu_is_the_dense_expression_without_launch():
    p, g, w = gram_case(np.random.default_rng(2))
    before = linalg.kkt_gram.launches
    got = linalg.kkt_gram(p, g, w, 1e-10)
    eye = torch.eye(70, dtype=torch.float64)
    assert torch.equal(got, p + (g.mT * w[..., None, :]) @ g + 1e-10 * eye)
    assert linalg.kkt_gram.launches == before


def test_kkt_gram_cpu_takes_the_jacobian_layout():
    """G as the dense route's forward-mode Jacobian lays it out (strides
    (m, 1, B m)): the same expression on the same tensor."""
    p, g, w = gram_case(np.random.default_rng(5))
    g = g.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert g.stride() == (40, 1, 80)
    eye = torch.eye(70, dtype=torch.float64)
    assert torch.equal(linalg.kkt_gram(p, g, w, 1e-10),
                       p + (g.mT * w[..., None, :]) @ g + 1e-10 * eye)


@pytest.mark.parametrize("case", ["g_no_unit_stride", "p_not_contiguous", "w_float32",
                                  "all_float32", "g_shape", "w_shape"])
def test_kkt_gram_raises_on_bad_input(case):
    p, g, w = gram_case(np.random.default_rng(3), n=40, m=40)
    error = {"w_float32": TypeError, "all_float32": TypeError}.get(case, ValueError)
    strided = torch.zeros(2, 40, 80, dtype=torch.float64)[..., ::2]
    strided.copy_(g)
    args = {"g_no_unit_stride": (p, strided, w),
            "p_not_contiguous": (p.transpose(1, 2), g, w),
            "w_float32": (p, g, w.float()),
            "all_float32": (p.float(), g.float(), w.float()),
            "g_shape": (p, g[:, :, :39].contiguous(), w),
            "w_shape": (p, g, w[:, :39].contiguous())}[case]
    with pytest.raises(error):
        linalg.kkt_gram(*args, 1e-10)


@pytest.mark.parametrize("n", [1, 8, 64, 100, 136, 137, 200])
def test_gram_tiles_cover_the_lower_triangle(n):
    """The 16 x 8 tiles with 8 j <= 16 i + 15 are as many as `gram_tiles`
    counts and hold every entry on or below the diagonal."""
    tiles = [(i, j) for i in range(-(-n // 16)) for j in range(-(-n // 8))
             if 8 * j <= 16 * i + 15]
    assert len(tiles) == linalg.gram_tiles(n)
    covered = {(16 * i + a, 8 * j + b) for i, j in tiles for a in range(16) for b in range(8)}
    assert all((r, c) in covered for r in range(n) for c in range(r + 1))


@pytest.mark.parametrize("bsz,m,n", [(128, 2439, 136), (1, 2439, 136), (4, 2439, 136),
                                     (64, 2439, 136), (3, 17, 100), (3, 2440, 64),
                                     (1, 1, 64), (2, 0, 64), (1, 5000, 300)])
def test_kkt_gram_splits_cover_the_rows(bsz, m, n):
    """Splits of the rows: a whole number of 32-row stages each, none
    empty, all of them covered; split only where one block a scene and
    tile group leaves SMs idle, into no more ranges than 64-row ones."""
    splits, rows = linalg.kkt_gram_splits(bsz, m, n, 132)
    assert rows % 32 == 0 and (splits - 1) * rows < max(m, 1) <= splits * rows
    blocks = bsz * -(-linalg.gram_tiles(n) // 96)
    if splits > 1:
        assert splits * blocks <= 132 and splits <= -(-m // 64)


def test_kkt_gram_splits_at_the_cells_batches():
    """One pass at the f64 fleet's batch of 128; the arm's batch of 1
    splits its 2,439 rows 39 ways."""
    assert linalg.kkt_gram_splits(128, 2439, 136, 132) == (1, 2464)
    assert linalg.kkt_gram_splits(1, 2439, 136, 132) == (39, 64)


def test_solve_qp_takes_kkt_gram_dense_f64_from_64_variables(monkeypatch):
    """``solve_qp`` builds its KKT matrix through `kkt_gram` once per IPM
    iteration on the dense route in float64 with n >= 64; not with bf16
    directions, in float32, below 64 variables, nor on the structured
    route (a float64 tick of the flat structured configuration)."""
    import dataclasses
    import os

    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops import qp
    from boundplanner_tpu_torch.parallel import batch
    from boundplanner_tpu_torch.parallel.fleet_cache import load, to_torch, tree_map

    calls = []

    def counted(*args):
        calls.append(args[1].shape)
        return linalg.kkt_gram(*args)

    monkeypatch.setattr(qp, "kkt_gram", counted)
    rng = np.random.default_rng(4)

    def taken(n, dtype, **kw):
        p, g, _ = gram_case(rng, m=90, n=n)
        q = torch.from_numpy(rng.normal(size=(2, n)))
        h = torch.from_numpy(rng.uniform(0.5, 1.5, size=(2, 90)))
        calls.clear()
        qp.solve_qp(*(t.to(dtype) for t in (p, q, g, h)), iters=3, **kw)
        return len(calls)

    assert taken(70, torch.float64) == 3
    assert taken(64, torch.float64) == 3
    assert taken(63, torch.float64) == 0
    assert taken(70, torch.float32) == 0
    assert taken(70, torch.float32, lowp=True) == 0
    payload = load(os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl"))
    inputs = to_torch(tree_map(lambda a: np.asarray(a)[:1],
                               (payload["carry"], payload["q0"], payload["obs"])),
                      "cpu", torch.float64)
    model = FleetMPC(dataclasses.replace(perf_mpc_params(), sqp_iters=1, qp_iters=2),
                     device="cpu", dtype=torch.float64)
    calls.clear()
    batch.fleet_rollout(*inputs, model, 1)
    assert model.cfg.struct_ocp and not calls
