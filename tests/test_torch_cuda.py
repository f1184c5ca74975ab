"""The three hand-written CUDA kernels against their plain PyTorch versions,
and the tick's, the rollout step's and the planner's CUDA graphs against
their eager routes, on the card (with a probe of the conditional node
that the rollout step's retry is captured into). Every test here needs a CUDA device and skips without one.

The port runs without JAX, and so does this file; it also holds the
seeded input generators that ``test_torch_kernels.py`` shares. On the
card, run it without the JAX-only ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q

Tolerances: float64 1e-12 (same algorithm, summation order only). float32
kernel A 2e-5 relative to max|L^{-1}| (the blocked kernel applies each
pivot's update with one rounding (FMA), multiplies by the pivot's
reciprocal, and sums the inverse's products in another order than the
plain version). Non-PD batches: the same finite/non-finite flag per
matrix, and the same values where the clamp keeps a matrix finite. float32 kernel B 1e-4
absolute where finite, and the same non-finite entries (FMA contraction in
the kernel's dot products; Dykstra contracts, so the differences stay at a
few ulps of the O(1) coordinates). float64 kernel C elementwise 1e-12 x
(|P| + |G|^T |w| |G| + reg): the same products, summed in another order.
"""

import os
import threading

import numpy as np
import pytest
import torch

from boundplanner_tpu_torch.ops import _build, cuda_proj
from boundplanner_tpu_torch.ops.linalg import kkt_gram, kkt_gram_plain, kkt_inverse, kkt_inverse_plain


def spd(rng, bsz, n):
    a = rng.normal(size=(bsz, n, n))
    return a @ a.transpose(0, 2, 1) + n * np.eye(n)


def non_pd_batch(rng, n):
    """Six matrices that are not positive definite (those of
    ``test_torch_kernels.py``'s clamp test, at any n >= 8): 0 and 3
    indefinite with off-diagonal mass (the clamped pivots overflow), 1 one
    negative pivot, 2 all zero (every pivot clamped), 4 a NaN on the
    diagonal, 5 rank-deficient PSD. Matrices 1, 2 and 5 stay finite."""
    ks = spd(rng, 6, n) - 2.5 * n * np.eye(n)
    ks[1] = np.diag(np.r_[1.0, -1.0, np.ones(n - 2)])
    ks[2] = 0.0
    ks[4] = np.eye(n)
    ks[4][3, 3] = np.nan
    ks[5] = 0.0
    ks[5][:8, :8] = spd(rng, 1, 8)[0]
    return ks


NON_PD_FINITE = [False, True, True, False, False, True]


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


def planner_batch(rng, calls):
    """The planner's `find_set_line` fold: per coalesced call the 16
    obstacle slots of fleet draw 1 + call % 8 (seed 7: floor and 3 boxes
    inflated by the planner's 0.08, 12 inactive slots), all b shifted by
    -0.001, and one segment inside the fleet's workspace."""
    from boundplanner_tpu_torch.parallel.fleet import random_scene
    from boundplanner_tpu_torch.planner.set_finder import build_obstacle_arrays

    a, b, p0, p1 = [], [], [], []
    for call in range(calls):
        obstacles, _ = random_scene(np.random.default_rng(7 + 1000 * (1 + call % 8)), 3)
        arr = build_obstacle_arrays(obstacles, 0.08)
        s0, s1 = rng.uniform((-0.14, -1.0, 0.0), (1.0, 0.38, 1.0), (2, 3))
        a.append(arr.a)
        b.append(arr.b - 0.001)
        p0.append(np.tile(s0, (len(arr.b), 1)))
        p1.append(np.tile(s1, (len(arr.b), 1)))
    return tuple(np.concatenate(x) for x in (a, b, p0, p1))


def edge_batch():
    """Five edge cases of kernel B's row rule and exits (those of
    ``chip_smoke.py``), R = 8, a box in rows 0-5 unless said, rows 6-7
    zero: 0 zero rows with b = -3 and -1e25 (no-ops, dropped; row 7 is
    a = (-0, 0, -0)); 1 a zero row with b = -1e30 (kept: in float32
    -b / 1e-12 overflows and inf * 0 gives NaN); 2 a NaN in p0; 3 an
    all-zero problem (a = 0, b = 0, p0 = p1 = 0); 4 a segment through the
    box (``test_torch_kernels.inside_case``)."""
    eye = np.eye(3)
    center, half = np.array([0.2, -0.1, 0.3]), np.array([0.15, 0.1, 0.2])
    a = np.zeros((5, 8, 3))
    b = np.full((5, 8), 10.0 - 0.001)
    a[[0, 1, 2, 4], :6] = np.vstack([eye, -eye])
    b[[0, 1, 2], :6] = np.concatenate([center + half, -(center - half)])
    b[4, :6] = 0.5
    b[0, 6:] = (-3.0, -1e25)
    a[0, 7] = (-0.0, 0.0, -0.0)
    b[1, 6] = -1e30
    b[3] = 0.0
    p0 = np.array([[1.0, 0.5, 0.9]] * 3 + [[0.0] * 3, [-1.0, 0.0, 0.0]])
    p1 = np.array([[0.8, -0.6, 1.2]] * 3 + [[0.0] * 3, [1.0, 0.0, 0.0]])
    p0[2, 0] = np.nan
    return a, b, p0, p1


# which edge problems end finite (x, phi and dist): in float64 the b = -1e30
# row's t = 1e42 stays finite, so only the NaN in p0 spreads
EDGE_FINITE = {"float32": [True, False, False, True, True],
               "float64": [True, True, False, True, True]}


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
@pytest.mark.parametrize("bsz,n", [(64, n) for n in (3, 4, 8, 12, 16, 20, 24)]
                         + [(1, 3), (1024, 3), (1280, 4)])
def test_cuda_chol_inverse_planner_shapes(cuda_device, bsz, n):
    """Kernel A at the planner's QP sizes and batches, f32: projection 3
    (alone, or 16 per call x 64 coalesced calls), feasibility and line
    projection 4 (the EE fit: 20 per call x 64), the via-rotation SQP
    4 nr_via up to 24."""
    ks = torch.from_numpy(spd(np.random.default_rng(n), bsz, n)).to(cuda_device, torch.float32)
    got = kkt_inverse(ks)
    ref = kkt_inverse_plain(ks)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()
    assert (torch.triu(got, 1) == 0).all()
    eye = torch.eye(n, device=cuda_device)
    res_k = (got @ ks @ got.mT - eye).abs().max().item()
    res_p = (ref @ ks @ ref.mT - eye).abs().max().item()
    assert res_k <= max(4.0 * res_p, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 12, 20, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_chol_inverse_ragged_n(cuda_device, n, dtype):
    """n not divisible by 8: the ragged last panel, and (n = 3, 12, 20)
    rows that are not 16-byte aligned in device memory (scalar load path)."""
    ks = torch.from_numpy(spd(np.random.default_rng(n), 16, n)).to(cuda_device, dtype)
    got = kkt_inverse(ks)
    ref = kkt_inverse_plain(ks)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert (torch.triu(got, 1) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 136])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_chol_inverse_non_pd_pattern(cuda_device, n, dtype):
    """The IPM's finite-step mask reads whether a factor is finite: the
    blocked kernel must flag the same matrices as the plain version (where
    inside a non-finite matrix the inf and NaN land may differ), and agree
    with it where the pivot clamp keeps a matrix finite."""
    ks = torch.from_numpy(non_pd_batch(np.random.default_rng(7), n)).to(cuda_device, dtype)
    got = kkt_inverse(ks)
    ref = kkt_inverse_plain(ks)
    torch.cuda.synchronize()
    flags = lambda x: torch.isfinite(x).all(dim=(1, 2)).tolist()
    assert flags(got) == flags(ref) == NON_PD_FINITE
    ok = [i for i, f in enumerate(NON_PD_FINITE) if f]
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    assert (got[ok] - ref[ok]).abs().max().item() <= tol * ref[ok].abs().max().item()
    assert (torch.triu(got[ok], 1) == 0).all()


@pytest.mark.cuda
def test_cuda_concurrent_first_launch_builds_once(cuda_device, tmp_path, monkeypatch):
    """8 threads make their first kkt_inverse call at once, from an empty
    build directory: the library is built once (one compile per source and
    a link, which leave no objects behind), loads once, and every thread's
    result is right."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIB", None)
    nvcc_calls = []
    real_nvcc = _build._nvcc
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc_calls.append(1) or real_nvcc())
    ks = torch.from_numpy(spd(np.random.default_rng(5), 4, 16)).to(cuda_device, torch.float32)
    barrier = threading.Barrier(8)
    out, errors = [None] * 8, []

    def first_launch(i):
        try:
            barrier.wait()
            out[i] = kkt_inverse(ks)
        except BaseException as err:  # reported below
            errors.append(err)

    threads = [threading.Thread(target=first_launch, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert len(nvcc_calls) == 1
    lib = os.path.basename(_build.library_path())
    assert sorted(os.listdir(tmp_path)) == [lib, lib + ".log"]
    ref = kkt_inverse_plain(ks)
    for got in out:
        assert (got - ref).abs().max().item() <= 2e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fold,count", [("tick", 12288), ("tick", 1),
                                        ("planner", 16), ("planner", 1024), ("edge", 5)])
def test_cuda_line_polytope_matches_plain(cuda_device, fold, count):
    """The tick's fold (scenes x links x obstacles), the planner's (16
    obstacle slots per coalesced `find_set_line` call) and the edge cases
    of the kernel's row rule and exits: the same finite entries as the
    plain version, and agreement where finite."""
    if fold == "tick":
        a, b, p0, p1 = tick_batch(np.random.default_rng(count), scenes=128, links=6)
    elif fold == "planner":
        a, b, p0, p1 = planner_batch(np.random.default_rng(count), count // 16)
    else:
        a, b, p0, p1 = edge_batch()
    args = [torch.from_numpy(np.ascontiguousarray(x[:count], dtype=np.float32)).to(cuda_device)
            for x in (a, b, p0, p1)]
    before = cuda_proj.line_polytope_projection.launches
    got = cuda_proj.line_polytope_projection(*args)
    assert cuda_proj.line_polytope_projection.launches == before + 1
    ref = cuda_proj.line_polytope_projection_plain(*args)
    torch.cuda.synchronize()
    finite = torch.isfinite(ref[0]).all(dim=-1) & torch.isfinite(ref[1]) & torch.isfinite(ref[2])
    assert finite.tolist() == (EDGE_FINITE["float32"] if fold == "edge" else [True] * count)
    for g, r in zip(got, ref):
        assert torch.equal(torch.isfinite(g), torch.isfinite(r))
        ok = torch.isfinite(r)
        assert (g[ok] - r[ok]).abs().max().item() <= 1e-4


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


def gram_inputs(rng, bsz, m, n, dev, layout="row"):
    """Kernel C's inputs: G standard normal, row-major or (``"col"``) in the
    dense route's layout, the forward-mode Jacobian's strides (m, 1, B m);
    P symmetric positive definite; weights log-uniform over 1e-14 .. 1e12
    with exact 0, 1e-14 and 1e12 entries, as late IPM iterations hold
    them."""
    g = rng.normal(size=(bsz, m, n))
    w = 10.0 ** rng.uniform(-14.0, 12.0, size=(bsz, m))
    w.reshape(-1)[:3] = (0.0, 1e-14, 1e12)
    p = spd(rng, bsz, n) / n
    p, g, w = (torch.from_numpy(a).to(dev) for a in (p, g, w))
    if layout == "col":
        g = g.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    return p, g, w


def gram_bound(p, g, w, reg):
    """1e-12 x (|P| + |G|^T |w| |G| + reg): the summation order's reach."""
    return 1e-12 * (p.abs() + (g.abs().mT * w.abs()[..., None, :]) @ g.abs() + reg)


# the cells' shapes, ragged ones, and n = 160 (two tile groups a scene)
GRAM_SHAPES = ([(b, 2439, 136, layout) for b in (1, 4, 128) for layout in ("col", "row")]
               + [(3, m, n, layout) for n in (64, 100, 136) for m in (1, 17, 2439, 2440)
                  for layout in ("col", "row")]
               + [(3, 2439, 160, layout) for layout in ("col", "row")])


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,m,n,layout", GRAM_SHAPES)
def test_cuda_kkt_gram_matches_plain(cuda_device, bsz, m, n, layout):
    p, g, w = gram_inputs(np.random.default_rng(m + n + bsz), bsz, m, n, cuda_device, layout)
    before = kkt_gram.launches
    got = kkt_gram(p, g, w, 1e-10)
    assert kkt_gram.launches == before + 1
    ref = kkt_gram_plain(p, g, w, 1e-10)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= gram_bound(p, g, w, 1e-10)).all()
    assert torch.equal(got, got.mT)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 128])
def test_cuda_kkt_gram_bitwise_repeat_and_graph(cuda_device, bsz):
    """Two launches agree bit for bit, and so does a launch captured in a
    CUDA graph and replayed (batch 1 splits the rows and sums the partials
    in a second pass; batch 128 takes one pass)."""
    p, g, w = gram_inputs(np.random.default_rng(bsz), bsz, 2439, 136, cuda_device, "col")
    first = kkt_gram(p, g, w, 1e-10)
    second = kkt_gram(p, g, w, 1e-10)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        kkt_gram(p, g, w, 1e-10)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = kkt_gram.launches
    with torch.cuda.graph(graph, stream=side):
        captured = kkt_gram(p, g, w, 1e-10)
    assert kkt_gram.launches == before + 1
    captured.fill_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, captured)


@pytest.mark.cuda
def test_cuda_kkt_gram_dispatch(cuda_device):
    """``solve_qp`` launches kernel C once per IPM iteration on the dense
    route in float64 with n >= 64, and never with bf16 directions, in
    float32, below 64 variables or on the structured route."""
    import dataclasses

    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops import qp
    from boundplanner_tpu_torch.parallel import batch

    rng = np.random.default_rng(3)

    def launches(n, dtype, **kw):
        p, g, _ = gram_inputs(rng, 2, 300, n, cuda_device)
        q = torch.from_numpy(rng.normal(size=(2, n))).to(cuda_device)
        h = torch.from_numpy(rng.uniform(0.5, 1.5, size=(2, 300))).to(cuda_device)
        before = kkt_gram.launches
        sol = qp.solve_qp(*(t.to(dtype) for t in (p, q, g, h)), iters=4, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(sol.x).all()
        return kkt_gram.launches - before

    assert launches(136, torch.float64) == 4
    assert launches(64, torch.float64) == 4
    assert launches(63, torch.float64) == 0
    assert launches(136, torch.float32) == 0
    assert launches(136, torch.float32, lowp=True) == 0
    model = FleetMPC(dataclasses.replace(perf_mpc_params(), sqp_iters=1, qp_iters=2),
                     device=cuda_device, dtype=torch.float64, graph=False)
    before = kkt_gram.launches
    batch.fleet_rollout(*step_inputs(cuda_device, torch.float64), model, 1)
    torch.cuda.synchronize()
    assert model.cfg.struct_ocp and kkt_gram.launches == before


STRAIGHT_Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])


def straight_reference(node):
    """The straight-line scene of tests/test_mpc.py from the node's pose."""
    from scipy.spatial.transform import Rotation as R

    p0 = node.p0.copy()
    r0 = R.from_rotvec(p0[3:]).as_matrix()
    erb = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
    return ([p0[:3].copy(), p0[:3] + np.array([0.0, -0.25, 0.0])], [r0, r0],
            [np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [erb],
            [np.zeros((15, 3))], [np.ones(15)], [[0.7, -0.2, 0.0, 0.9, 0.0, 0.4]])


def counted_step(node):
    kkt_inverse.launches = 0
    cuda_proj.line_polytope_projection.launches = 0
    node.step()
    return kkt_inverse.launches, cuda_proj.line_polytope_projection.launches


@pytest.mark.cuda
def test_cuda_node_f64_matches_cpu(cuda_device):
    """MPCNode in f64 on the card (dense route, reduced budget) against the
    CPU over 2 ticks; each step launches kernel A sqp x qp + 25 times (the
    SQP's IPM, then the link sets' projection IPM), kernel C sqp x qp
    times and kernel B never."""
    from boundplanner_tpu_torch.config import MPCParams
    from boundplanner_tpu_torch.mpc import MPCNode

    cfg = MPCParams(sqp_iters=2, qp_iters=6, line_search_steps=2)
    card, cpu = (MPCNode(STRAIGHT_Q0, cfg, device=d) for d in (cuda_device, "cpu"))
    for node in (card, cpu):
        node.update_reference(*straight_reference(node))
    for _ in range(2):
        before = kkt_gram.launches
        assert counted_step(card) == (2 * 6 + 25, 0)
        assert kkt_gram.launches == before + 2 * 6     # the SQP's dense KKT matrices
        cpu.step()
        for key in ("q", "dq", "p_lie"):
            np.testing.assert_allclose(getattr(card, key), getattr(cpu, key), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_cuda_node_f32_perf_launches(cuda_device):
    """The 10 Hz configuration in f32: 12 kernel A and 1 kernel B launches
    per step, no kernel C, finite state."""
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc import MPCNode

    node = MPCNode(STRAIGHT_Q0, perf_mpc_params(), device=cuda_device, dtype=torch.float32)
    node.update_reference(*straight_reference(node))
    before = kkt_gram.launches
    for _ in range(2):
        assert counted_step(node) == (12, 1)
    assert kkt_gram.launches == before
    assert np.isfinite(node.q).all() and node.mpc.phi_current[0] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["iiwa14", "gen3"])
def test_cuda_robot_model_matches_cpu(cuda_device, robot):
    from scipy.spatial.transform import Rotation as R
    from boundplanner_tpu_torch.robot.model import RobotModel

    card, cpu = RobotModel(robot, device=cuda_device), RobotModel(robot, device="cpu")
    q, dq = np.random.default_rng(3).normal(size=(2, 7))
    for a, b in zip(card.forward_kinematics(q, dq), cpu.forward_kinematics(q, dq)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    pose = cpu.fk(STRAIGHT_Q0 + 0.1)
    pd, rd = pose[:3], R.from_rotvec(pose[3:]).as_matrix()
    np.testing.assert_allclose(card.inverse_kinematics(pd, rd, STRAIGHT_Q0),
                               cpu.inverse_kinematics(pd, rd, STRAIGHT_Q0), rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_cuda_checkpoint_resume(cuda_device, tmp_path):
    """A carry saved on the card and loaded back steps exactly as the
    uninterrupted one."""
    from boundplanner_tpu_torch.checkpoint import load_carry, save_carry
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc import BoundMPC, MPCNode

    node = MPCNode(STRAIGHT_Q0, perf_mpc_params(), device=cuda_device, dtype=torch.float32)
    args = straight_reference(node)
    node.update_reference(*args)
    node.step()
    save_carry(tmp_path / "carry.npz", node.mpc.carry)
    twin = BoundMPC(*args, p0=node.p0, params=node.params, device=cuda_device,
                    dtype=torch.float32)
    twin.carry = load_carry(tmp_path / "carry.npz", device=cuda_device, dtype=torch.float32)
    meas = (node.q, node.dq, node.ddq, node.p_lie, node.v, node.jerk, node.qf)
    out_a, out_b = node.mpc.step(*meas), twin.step(*meas)
    for key in out_a[0]:
        np.testing.assert_array_equal(out_b[0][key], out_a[0][key])


@pytest.mark.cuda
def test_cuda_graph_replay_equals_eager(cuda_device):
    """The tick's CUDA graph against the eager route on the card: 2 scenes
    of `.fleet_cache/test8.pkl` for 3 ticks of the perf configuration in
    f32, bit for bit. A 1-tick rollout captures the graph first, so all
    3 ticks replay it; the bookkeeping counts 12 / 1 launches a tick."""
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import fleet_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch, tree_map

    payload = load(os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl"))
    inputs = to_torch(tree_map(lambda a: np.asarray(a)[:2],
                               (payload["carry"], payload["q0"], payload["obs"])),
                      cuda_device, torch.float32)
    eager = FleetMPC(perf_mpc_params(), device=cuda_device, graph=False)
    graph = FleetMPC(perf_mpc_params(), device=cuda_device)
    assert graph.graph is True
    ref = to_numpy(fleet_rollout(*inputs, eager, 3))
    fleet_rollout(*inputs, graph, 1)
    (runner,) = graph.graphs.values()
    kkt_inverse.launches = 0
    cuda_proj.line_polytope_projection.launches = 0
    got = to_numpy(fleet_rollout(*inputs, graph, 3))
    assert runner.replays == 3 and runner.launches == [12, 1, 0]
    assert (kkt_inverse.launches, cuda_proj.line_polytope_projection.launches) == (36, 3)
    out_got, out_ref = [], []
    tree_map(out_got.append, got)
    tree_map(out_ref.append, ref)
    for g, r in zip(out_got, out_ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.cuda
def test_cuda_graph_first_difference_finds_none(cuda_device):
    """The diagnostic that names the first op where a replay parts from the
    eager route (`mpc.graph.first_difference`, run by `chip_smoke.py` when
    the routes differ) runs on the card and finds no difference on one
    tick of 2 scenes."""
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC, mpc_tick
    from boundplanner_tpu_torch.mpc.graph import first_difference
    from boundplanner_tpu_torch.parallel.batch import _plant_measurement
    from boundplanner_tpu_torch.parallel.fleet_cache import load, to_torch, tree_map

    payload = load(os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl"))
    carry, q0, obs = to_torch(tree_map(lambda a: np.asarray(a)[:2],
                                       (payload["carry"], payload["q0"], payload["obs"])),
                              cuda_device, torch.float32)
    model = FleetMPC(perf_mpc_params(), device=cuda_device, graph=False)
    zeros = torch.zeros_like(q0)
    meas = _plant_measurement(q0, zeros, zeros, zeros, q0, model.st.chain)
    before = (kkt_inverse.launches, cuda_proj.line_polytope_projection.launches)
    assert first_difference(lambda c, m, o: mpc_tick(c, m, o, model.cfg, model.st),
                            (carry, meas, obs)) is None
    # the eager run launched once more, the capture not at all
    assert (kkt_inverse.launches, cuda_proj.line_polytope_projection.launches) == (
        before[0] + 12, before[1] + 1)


@pytest.mark.cuda
def test_cuda_if_node_probe(cuda_device):
    """`mpc.graph.device_cond` under a capture: the branch is captured
    into a graph of its own and added as an IF node (``csrc/graph_cond.cu``);
    a tensor allocated inside the branch comes from the branch graph's
    private pool; a replay whose predicate is false leaves the branch's
    outputs as they were, one whose predicate is true runs it; the
    branch's launches of kernel A are taken off the count and kept apart
    (``branch_launches``), not added by a replay."""
    from boundplanner_tpu_torch.mpc import graph as graph_mod

    x = torch.zeros(4, device=cuda_device)
    k = torch.from_numpy(spd(np.random.default_rng(11), 2, 16).astype(np.float32)).to(cuda_device)
    out = torch.zeros(4, device=cuda_device)
    inv = torch.zeros_like(k)
    ptrs = []

    def fn(x, k):
        pred = x.sum() > 0

        def body():
            tmp = x * 2 + 1
            ptrs.append(tmp.data_ptr())
            out.copy_(tmp)
            inv.copy_(kkt_inverse(k))

        graph_mod.device_cond(pred, body)
        return out * 1

    runner = graph_mod.Graph(fn, (x, k))
    runner(x, k)           # warm-up (the branch runs) and capture
    assert runner.launches == [0, 0, 0] and runner.branch_launches == [1, 0, 0]
    (branch,) = runner.branches
    pool = tuple(branch.pool())
    captured = ptrs[-1]
    seg = [s for s in torch.cuda.memory_snapshot()
           if s["address"] <= captured < s["address"] + s["total_size"]]
    assert len(seg) == 1 and tuple(seg[0]["segment_pool_id"]) == pool, seg
    before = kkt_inverse.launches
    out.fill_(-1.0)
    inv.fill_(-1.0)
    got = runner(torch.zeros_like(x), k)
    assert (got == -1).all() and (inv == -1).all()
    got = runner(torch.ones_like(x), k)
    assert (got == 3).all()
    np.testing.assert_allclose(inv.cpu().numpy(), kkt_inverse(k).cpu().numpy(), rtol=0,
                               atol=1e-5 * float(inv.abs().max()))
    assert kkt_inverse.launches == before + 1   # the check's own call


def step_inputs(dev, dtype=torch.float32):
    """Scenes 0-1 of `.fleet_cache/test8.pkl` in ``dtype`` on ``dev`` from
    a rest state 0.3 rad (seeded) off their start."""
    from boundplanner_tpu_torch.parallel.fleet_cache import load, to_torch, tree_map

    payload = load(os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl"))
    carry, q0, obs = tree_map(lambda a: np.asarray(a)[:2],
                              (payload["carry"], payload["q0"], payload["obs"]))
    q0 = q0 + 0.3 * np.random.default_rng(4).normal(size=q0.shape)
    return to_torch((carry, q0, obs), dev, dtype)


# perf, and 4 escalation lanes at a base budget of 1 SQP x 2 IPM iterations
# (which the perturbed lanes fail) with a retry at the same budget and a
# streak limit of 1: a lane that fails again is not retried on the next
# tick, so the branch runs on some ticks and not on others
STEP_CONFIGS = {"perf": {}, "esc4": dict(esc_lanes=4, sqp_iters=1, qp_iters=2,
                                          esc_sqp_iters=1, esc_qp_iters=2,
                                          esc_streak_limit=1)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_cuda_step_graph_equals_eager(cuda_device, name):
    """The rollout's step graph (the plant step, the tick and the retry
    under its IF node, one replay a tick) against the eager route on the
    card: 2 scenes x 3 ticks in f32, bit for bit, after a 1-tick rollout
    that captures it; the bookkeeping counts the tick's launches on every
    replay and the retry's once per fired tick, and the graph's count of
    fired ticks equals the eager route's host count (some ticks fired,
    some not)."""
    import dataclasses

    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel import batch
    from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, tree_map

    cfg = dataclasses.replace(perf_mpc_params(), **STEP_CONFIGS[name])
    inputs = step_inputs(cuda_device)
    eager = FleetMPC(cfg, device=cuda_device, graph=False)
    graph = FleetMPC(cfg, device=cuda_device)
    batch._escalate_failed_lanes.retries = 0
    ref = to_numpy(batch.fleet_rollout(*inputs, eager, 3))
    fired = batch._escalate_failed_lanes.retries
    batch.fleet_rollout(*inputs, graph, 1)
    (runner,) = graph.graphs.values()
    kkt_inverse.launches = 0
    cuda_proj.line_polytope_projection.launches = 0
    batch._escalate_failed_lanes.retries = 0
    got = to_numpy(batch.fleet_rollout(*inputs, graph, 3))
    per_tick = cfg.sqp_iters * cfg.qp_iters
    assert runner.replays == 3 and runner.launches == [per_tick, 1, 0]
    assert batch._escalate_failed_lanes.retries == fired
    if cfg.esc_lanes:
        assert 0 < fired < 3, fired
        assert runner.branch_launches == [cfg.esc_sqp_iters * cfg.esc_qp_iters, 1, 0]
    else:
        assert fired == 0
    assert (kkt_inverse.launches, cuda_proj.line_polytope_projection.launches) == (
        3 * per_tick + fired * cfg.esc_sqp_iters * cfg.esc_qp_iters, 3 + fired)
    out_got, out_ref = [], []
    tree_map(out_got.append, got)
    tree_map(out_ref.append, ref)
    for g, r in zip(out_got, out_ref):
        np.testing.assert_array_equal(g, r)


# a cold step graph's first tick is its warm-up, which runs the retry
# whatever its predicate: at a streak limit of 0 no lane is eligible, so
# the retry never fires; at STEP_CONFIGS' esc4 budget every perturbed lane
# fails the first tick, so it fires there
COLD_CONFIGS = {"never_fires": dict(esc_lanes=4, esc_streak_limit=0),
                "fires_first": STEP_CONFIGS["esc4"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(COLD_CONFIGS))
def test_cuda_cold_step_graph_counts_the_warm_up_retry(cuda_device, name):
    """A cold step-graph rollout (2 scenes x 3 ticks, f32): the warm-up's
    retry counts its launches where it ran, fired or not, and a run that
    fired nothing goes to ``_escalate_failed_lanes.idle_runs``; the
    replays add the retry's launches once per later fired tick. So the
    counts hold what the card ran: the tick's launches on every tick, the
    retry's on every fired tick and on an idle warm-up run."""
    import dataclasses

    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel import batch

    cfg = dataclasses.replace(perf_mpc_params(), **COLD_CONFIGS[name])
    inputs = step_inputs(cuda_device)
    esc = batch._escalate_failed_lanes
    esc.retries = esc.idle_runs = 0
    batch.fleet_rollout(*inputs, FleetMPC(cfg, device=cuda_device, graph=False), 3)
    fired = esc.retries
    kkt_inverse.launches = 0
    cuda_proj.line_polytope_projection.launches = 0
    esc.retries = esc.idle_runs = 0
    batch.fleet_rollout(*inputs, FleetMPC(cfg, device=cuda_device), 3)
    assert esc.retries == fired
    assert (fired, esc.idle_runs) == ((0, 1) if name == "never_fires" else (fired, 0))
    assert fired or name == "never_fires"
    runs = fired + esc.idle_runs
    assert (kkt_inverse.launches, cuda_proj.line_polytope_projection.launches) == (
        3 * cfg.sqp_iters * cfg.qp_iters + runs * cfg.esc_sqp_iters * cfg.esc_qp_iters,
        3 + runs)


PLANNER_KEYS = ("fsap", "fsap_mid", "fsl", "mvie", "feas", "fit_ee", "proj", "via_rot_2",
                "spath")


@pytest.fixture(scope="module")
def planner_key_inputs():
    """Each planner key's inputs at width 2 on the card: fleet draw 1 (seed
    7) planned eagerly in f32, each key's first two direct calls stacked
    (the first twice where it had one; "fsap" takes "fsap_mid"'s), and two
    random roadmaps' adjacency for "spath"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.parallel.fleet import DEMO_Q0, plan_scene, random_scene
    from boundplanner_tpu_torch.planner import planner as planner_mod
    from boundplanner_tpu_torch.planner.device_search import NO_EDGE, shortest_path_device
    from boundplanner_tpu_torch.utils.tree import tree_map

    dev = torch.device("cuda", 0)
    calls, real = {}, planner_mod.device_call

    def recording(key, fn, inputs, graph):
        calls.setdefault(key, (fn, []))[1].append(tree_map(torch.clone, inputs))
        return real(key, fn, inputs, graph)

    obstacles, goal = random_scene(np.random.default_rng(7 + 1000), 3)
    planner_mod.device_call = recording
    try:
        assert plan_scene(DEMO_Q0, goal, obstacles, 8, perf_mpc_params(), np.float32,
                          device=dev, plan_dtype=torch.float32, graph=False) is not None
    finally:
        planner_mod.device_call = real
    calls["fsap"] = (planner_mod.planner_kernels(20)["fsap"], calls["fsap_mid"][1])
    out = {key: (fn, tree_map(lambda a, b: torch.cat([a, b]), args[0], args[min(1, len(args) - 1)]))
           for key, (fn, args) in calls.items()}
    rng = np.random.default_rng(3)
    adj = np.full((2, 64, 64), NO_EDGE, np.float32)
    for b, n in enumerate((10, 30)):
        for _ in range(3 * n):
            u, v = rng.integers(0, n, 2)
            adj[b, u, v] = adj[b, v, u] = rng.uniform(0.1, 2.0)
    out["spath"] = (shortest_path_device, (torch.from_numpy(adj).to(dev),))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("key", PLANNER_KEYS)
def test_cuda_planner_graph_equals_eager(cuda_device, planner_key_inputs, key):
    """Each planner key's CUDA graph against its eager call on the card, at
    width 2, bit for bit: the first call (eager warm-up on the side stream,
    then the capture) and a replay; the replay adds the eager call's
    counted kernels' launches to the counts, and the eager call neither waits
    for the card nor copies from the host
    (``set_sync_debug_mode("error")``)."""
    from boundplanner_tpu_torch.mpc.graph import WRAPPERS, Graph
    from boundplanner_tpu_torch.utils.tree import to_numpy, tree_map

    fn, inputs = planner_key_inputs[key]
    counts = lambda: tuple(w.launches for w in WRAPPERS)
    torch.cuda.synchronize()
    c0 = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ref = fn(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager_launches = tuple(b - a for a, b in zip(c0, counts()))
    ref = to_numpy(ref)
    runner = Graph(fn, inputs)
    first = to_numpy(runner(*inputs))
    c1 = counts()
    got = to_numpy(runner(*inputs))
    assert runner.replays == 1 and tuple(runner.launches) == eager_launches
    assert tuple(b - a for a, b in zip(c1, counts())) == eager_launches
    assert (sum(eager_launches) > 0) == (key != "spath"), eager_launches
    for tree in (first, got):
        got_leaves, ref_leaves = [], []
        tree_map(got_leaves.append, tree)
        tree_map(ref_leaves.append, ref)
        assert len(got_leaves) == len(ref_leaves)
        for g, r in zip(got_leaves, ref_leaves):
            np.testing.assert_array_equal(g, r)
