#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``boundplanner_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --only-runtime [--out DIR]
    python3 chip_smoke.py --compare-kernel-b SOURCE [--out DIR]
    python3 chip_smoke.py --compare-builders [--out DIR]
    python3 chip_smoke.py --only-solver-configs [--out DIR]
    python3 chip_smoke.py --only-gates [--out DIR]

The second form runs only the runtime phases (13-15 below); the fifth only
builds, then runs kernel A at the retry's shape, kernel B's folds and the
solver configurations of phase 5 (~2 min); the last only builds, then
runs kernel A at the probe's shape, kernel B's folds, the main path's 20
ticks (uncounted, for gate 4's first ticks), the e2e plan and the f32
runtime of phase 14, then phase 19 (~4 min). The third
only builds, then times kernel B of SOURCE (another
tree's ``csrc/line_polytope.cu``, same C entry) against this tree's in
turns (SOURCE, this, this, SOURCE) at kernel B's folds, and checks that
both give the same outputs by value; it exits non-zero where they differ.
The fourth only builds, then plans the fleet of phase 9 with the threaded
and the phase-synchronous builder in turns (threaded, sync, sync,
threaded): each run's plans/s, kept draws, broker counters and launches,
and sound corridors (asserted).

Phases (each asserts; any failure exits non-zero):

1. the card's name and power limit (nvidia-smi); build both CUDA kernels
   from ``boundplanner_tpu_torch/csrc`` with nvcc (one per source, in
   parallel);
2. kernel A (Cholesky + inverse) against its plain PyTorch version on the
   card, at the fleet's shapes (128, 136, 136) and (1, 136, 136) in f32,
   (2, 136, 136) in f64, (64, 136, 136) in f32 (one rank's block of the
   sharded rollouts) and (4, 136, 136) in f32 (the escalation retry's
   sub-batch), and on batches of non-PD matrices at n = 136 in f32 and f64
   (the same finite flag per matrix as the plain version);
3. kernel B (segment-polytope projection) against its plain version at
   the tick's shapes, P = 12288 and P = 1, R = 15, with zero-padded rows
   and inactive obstacles, and at the planner's, P = 16 and P = 1024 (one
   and 64 coalesced `find_set_line` calls on fleet draws), one arm's tick
   (P = 96), the escalation retry's (P = 384: 4 lanes x 96), the
   escalation probe's (P = 288: 3 scenes x 96), on the inputs
   of the cached fleet's first tick ("tick_real", P = 12288), and on five
   edge cases of its row rule and exits (the same finite pattern as the
   plain version, and agreement where finite);
4. a small f64 rollout on the card against the same rollout on the CPU;
5. the main path: the cached 128-scene fleet, ``FleetMPC(perf_mpc_params())``
   -> ``chunked_rollout`` for 20 ticks in f32 (warm-up, then timed), with
   the kernels' launch counts, fleet quality and single-scene tick latency;
   then the scene and tick of its worst attempted violation, that scene's
   inputs before the tick saved (``--out``) and the tick replayed on the
   card at batch 128 and at batch 1; then the same fleet's quality with a
   kernel's route swapped (kernel A
   again, its plain version, kernel A in f64, kernel B's plain version);
   then the solver configurations (``solver_configs``: the chunked Grams,
   the factored link rows, the dense tail, ADMM, the frozen KKT factor,
   the paired warm start, 4 escalation lanes) on the same fleet for 10
   ticks each, with their launches, quality and wall time, each also run
   2 scenes x 2 ticks in f64 on the card against the CPU;
6. kernel A against its plain version at the planner's shapes, f32:
   batch 64 at n = 3, 4, 8, 12, 16, 20, 24, and (1, 3, 3), (1024, 3, 3),
   (1280, 4, 4);
7. the planner in f64: one fleet draw (seed 7, draw 1) planned by
   ``parallel.fleet.plan_scene`` on the CPU and on the card, same carry;
8. the batched shortest path (``planner.device_search``) on the card: 128
   random roadmaps padded to 64 junctions against the host Dijkstra;
9. the planner path: ``parallel.fleet.build_fleet_threaded`` plans a
   fleet of 2 scenes in f32 on the card through the broker (seed 7, 3
   obstacles, 2 threads; the cached fleet was built with 8), with its rate, the
   draws it kept, the broker's counters, both kernels' launches, the
   corridor invariants of every scene, and how its scenes compare with the
   cached JAX-built ones;
10. the process-pool builder ``parallel.fleet.build_fleet_mp``: 8 scenes
    (the same settings) planned by the default 4 spawned workers on the
    card (``fleet.CARD_PROCS``), both kernels' launches in every worker,
    sound corridors;
11. that fleet rolled out for 20 ticks through the MPC on the card;
12. the multi-device tier: 2 ranks of ``parallel.dryrun`` started by
    ``parallel.distributed.launch`` over gloo on this card, 64 scenes
    each for 10 ticks, the dry-run bars on identical global diagnostics,
    each rank equal by value to one process at chunk 64, 120 / 10
    launches per rank; then ``dryrun_multichip`` over ``make_mesh()``;
13. the single-arm runtime (also alone: ``--only-runtime``): the
    tests/test_e2e.py scene planned on the card in f64, then ``MPCNode``
    with ``MPCParams()`` in f64 (the first 3 ticks also on the CPU) toward
    the path end, with kernel A's (1, 136, 136) and (96, 4, 4) f64 rows;
14. the same plan through ``MPCNode`` with ``perf_mpc_params()`` in f32,
    the 10 Hz loop, with ``t_comp``/``t_loop`` percentiles;
15. IK on the card against the CPU, and a checkpoint saved and resumed on
    the card;
16. the edges: the error-bound families (``mpc/bounds.py``) and the rest of
    ``ops/linalg.py`` on the card in f64 against the CPU (1e-10), and the
    FLOP model (``mpc/flops.py``): MFLOP per solve and the achieved GFLOP/s
    of the main path and the runtime (reported);
17. the phase-synchronous builder ``parallel.fleet.build_fleet_sync`` with
    the settings of phase 9 (2 scenes, 2 workers, f32): sound corridors,
    both kernels launched, the threaded build's q0 and obstacle arrays;
    its rate beside phase 9's and the broker's widths;
18. the port's examples on the card, in this process: ``rviz_bringup`` (3
    ticks; its telemetry validates against the port's IDL),
    ``boundplanner_with_mpc_example`` (3 ticks, the EE outside every box)
    and ``fleet_example`` (one scene, 5 ticks), with their launches;
19. the JAX package's quality gates (``boundplanner_tpu_torch.gates``;
    run after phase 15): kernel A at (3, 136, 136) f32; gate 4, the cached
    fleet for 50 ticks through ``chunked_rollout`` and ``rollout_diag``
    (600 / 50 launches each, success >= 0.90, the first 20 ticks equal to
    phase 5's records by value, the two loops' records equal; the worst 3
    scenes' chronologies and scene 43's last tick reported, the records
    saved with ``--out``); gate 2, scene 43 alone for 30 ticks (360 / 30
    launches, kernel B at P = 96, the bar "tracks"); the escalation probe,
    scenes 29, 43, 54 for 20 ticks without and with 4 escalation lanes
    (240 / 20, and 240 + 48 / 20 + 1 a fired tick; kernel A at (3, 136,
    136), kernel B at P = 288); gate 1 on phase 14's row (the path end
    within 45 ticks, final error <= 2 mm, the EE outside every original
    box; no fallback is reported, not asserted: f32 basin noise); and
    the e2e scene planned in f64 through a broker with the "spath" key
    (the key served, the host route's vias within 1e-5).

Every kernel row gives the kernel's time (CUDA events), its plain
version's, its bound (the larger of the bytes it must move over 3.35 TB/s
and its operations over the card's peak for their type, 67 TFLOP/s f32 or
34 TFLOP/s f64 outside the tensor cores, which it names as ``bound_by``),
the roofline share (bound over time), and ``library_ms``: for kernel A the
two library calls ``torch.linalg.cholesky_ex`` then
``torch.linalg.solve_triangular(L, I, upper=False)`` at the same shape
(timed here only; the port never calls them), for kernel B null (no
PyTorch call computes a segment-polytope closest pair). Every kernel row
also gives ``launch_only_ms``: its library entry launched straight into a
preallocated output, the kernel's time without the wrapper's host work.
Kernel B's bound counts the rows it keeps (every row but the zero rows
that change nothing) over all 11 x 4 sweeps, not counting off the exits,
which depend on rounding; ``bound_ms_all_rows`` counts every row, as
before the kernel dropped rows. Kernel B's rows also give the row
corrections that each warp's slowest problem runs
(``chain_warp_max_mean``, ``chain_warp_max_max``), replayed on the host by
``ops/proj_chain.py`` (numpy, without the kernel's FMA contraction).

Earlier lines print JSON with the numbers; the line before the last is the
kernels' summary, the last line ``{"ok": true, "device": {...}}``. No JAX
is imported. ``--out DIR`` also writes the results and the compiler's
report there.
"""

import json
import os
import subprocess
import sys
import time

FLEET = os.path.join(".fleet_cache", "fleet_b128_s7_segs4.pkl")
N_TICKS = 20
CHUNK = 128
LATENCY_REPS = 50
PLAN_SEED = 7          # the seed of the cached fleet
# 2 of the cached fleet's 128 scenes on 2 threads: one plan takes ~20 s on
# the card and the host-bound planner threads share one interpreter (every
# thread plans a draw at once: 8 threads and 4 scenes took ~280-300 s,
# PERF.md), and the process-pool and runtime phases need that time. The
# widths are the JAX package's own.
PLAN_SCENES = 2
PLAN_THREADS = 2
# the planned rollout rolls out the process-pool builder's 8 scenes: one
# hard scene failing throughout is an eighth of the ticks (card plans have
# rolled out at 0.875 with one such scene), and a broken port lands near 0
# (PERF.md §2)
PLANNED_FLOOR = 0.75
PLAN_OBSTACLES = 3
PLAN_OBS_INFLATE = 0.08           # BoundPlanner's default obs_size_increase
PLAN_WS_MIN = (-0.14, -1.0, 0.0)  # the fleet's workspace (`plan_scene`)
PLAN_WS_MAX = (1.0, 0.38, 1.0)
# kernel A's planner shapes (batch, n): n = 3 projection QPs (one call, or
# `_polyhedron_once`'s 16 per call x 64 coalesced), n = 4 feasibility and
# line projection (`fit_ee_in_set`: 20 per call x 64), n = 4 nr_via for the
# via-rotation SQP, nr_via = 1 .. 6
PLANNER_CHOL_SHAPES = ([(64, n) for n in (3, 4, 8, 12, 16, 20, 24)]
                       + [(1, 3), (1024, 3), (1280, 4)])
# the single-arm runtime: the tests/test_e2e.py scene (`mpc/e2e.py`),
# planned on the card in f64, then MPCNode ticks toward the path end (f64
# `MPCParams()` and f32 `perf_mpc_params()`), each phase capped in ticks
# and seconds (PERF.md §4). The f64 cap makes room for the solver
# configurations: its ~4.4 s ticks stop short of the path end (~38
# ticks), so the goal bar is asserted on the f32 node, which reaches it
RUNTIME_COMPARE_TICKS = 3         # f64 ticks run on the card and on the CPU
RUNTIME_MAX_TICKS = 60
RUNTIME_F64_CAP_S = 90.0
RUNTIME_F32_CAP_S = 90.0
PROJ_IPM_ITERS = 25               # the f64 link sets' projection IPM (`_seg_closest_ipm`)
# the solver configurations the JAX package also carries, each on
# `perf_mpc_params()` with the fields below, on the cached fleet at its full
# width for SOLVER_TICKS ticks (cut from 20 for time, PERF.md §4). Success is
# held to the main path's floor where the JAX package runs the configuration
# at the perf config's quality, and reported for its measured negatives
# (admm, kkt2, warm_sz). esc4 retries up to 4 failing lanes a tick at the
# escalated budget (6 SQP x 8 IPM iterations, streak limit 3).
SOLVER_TICKS = 10
SOLVER_CONFIGS = {
    "chunked": dict(struct_chunked=True),
    "link": dict(struct_link=True),
    "dense_tail": dict(struct_tail=False),
    "admm": dict(struct_tail=False, qp_solver="admm"),
    "kkt2": dict(kkt_every=2),
    "warm_sz": dict(qp_warm_dual=True, qp_warm_sz=True),
    "esc4": dict(esc_lanes=4),
}
SOLVER_FLOORED = ("chunked", "link", "dense_tail", "esc4")
# the fleet tier: the process-pool builder (MP_SCENES scenes, its default
# count of spawned workers, blocks of MP_BLOCK draws), the batched shortest path
# (SPATH_SCENES roadmaps padded to SPATH_PAD junctions), and the dry run
# over DRYRUN_RANKS ranks sharing the card, SHARD scenes each
MP_SCENES, MP_BLOCK = 8, 2
SPATH_SCENES, SPATH_PAD = 128, 64
DRYRUN_RANKS, DRYRUN_TICKS = 2, 10
SHARD = 64
# the card's published peaks (H100 SXM, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}   # outside the tensor cores
# kernel B's operations per problem (csrc/line_polytope.cu): 17 per row
# correction (w = y + e, a.w - b, / |a|^2, clamp, e = t a, y = w - e), 11
# per segment parameter and 6 per segment point, 6 per row and 9 for the
# setup, 16 for the final distance; the row terms count the kept rows
B_OPS_ROW, B_OPS_PHI, B_OPS_POINT, B_OPS_SETUP_ROW, B_OPS_SETUP, B_OPS_DIST = 17, 11, 6, 6, 9, 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call, timed with CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def spd_batch(rng, bsz, n=136, m=400, dtype="float32"):
    """SPD matrices shaped like the IPM's KKT: G^T diag(w) G + P, with the
    interior-point weights w = z/s spread over four decades."""
    import numpy as np

    g = rng.normal(size=(bsz, m, n)) / np.sqrt(m)
    w = 10.0 ** rng.uniform(-2.0, 2.0, size=(bsz, m))
    k = np.einsum("bmi,bm,bmj->bij", g, w, g) + 1e-2 * np.eye(n)
    return k.astype(dtype)


def non_pd_batch(rng, n):
    """Six matrices that are not positive definite: 0 and 3 indefinite with
    off-diagonal mass (the clamped pivots overflow), 1 one negative pivot,
    2 all zero (every pivot clamped), 4 a NaN on the diagonal, 5
    rank-deficient PSD. Matrices 1, 2 and 5 stay finite."""
    import numpy as np

    def spd(count, size):
        a = rng.normal(size=(count, size, size))
        return a @ a.transpose(0, 2, 1) + size * np.eye(size)

    ks = spd(6, n) - 2.5 * n * np.eye(n)
    ks[1] = np.diag(np.r_[1.0, -1.0, np.ones(n - 2)])
    ks[2] = 0.0
    ks[4] = np.eye(n)
    ks[4][3, 3] = np.nan
    ks[5] = 0.0
    ks[5][:8, :8] = spd(1, 8)[0]
    return ks


NON_PD_FINITE = [False, True, True, False, False, True]


def bound(bytes_moved, ops, dtype):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``bytes_moved`` and does ``ops`` operations of ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_a_row(phase, k, reps):
    """Kernel A on one SPD batch against its plain version: agreement,
    residuals, exact-zero upper triangle, times, bound and library time.
    Bars: the kernel must be as good an inverse factor as the plain
    version (both carry ~cond * eps error at these condition numbers)."""
    import torch
    from boundplanner_tpu_torch.ops import linalg
    from boundplanner_tpu_torch.ops._build import library
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse, kkt_inverse_plain

    bsz, n = k.shape[0], k.shape[-1]
    f32 = k.dtype == torch.float32
    # the library entry launched straight into a preallocated output: the
    # kernel's own time, without the wrapper's host work per call (checks,
    # allocation, stream lookup); not counted as a launch of the path
    entry = getattr(library(), linalg._ENTRY[k.dtype])
    out_bare = torch.empty_like(k)
    bare = (k.data_ptr(), out_bare.data_ptr(), bsz, n,
            torch.cuda.current_stream(k.device).cuda_stream)
    li = kkt_inverse(k)
    lp = kkt_inverse_plain(k)
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    identity = eye.expand_as(k).contiguous()
    library = lambda: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(k)[0], identity,
                                                    upper=False)
    ll = library()
    torch.cuda.synchronize()
    assert torch.isfinite(li).all(), "kernel A: non-finite output"
    assert (torch.triu(li, diagonal=1) == 0).all(), "kernel A: strict upper triangle not exactly 0"
    res_k = (li @ k @ li.mT - eye).abs().amax().item()
    res_p = (lp @ k @ lp.mT - eye).abs().amax().item()
    abs_err = (li - lp).abs().amax().item()
    rel_err = abs_err / lp.abs().amax().item()
    ms = cuda_ms(lambda: kkt_inverse(k), reps)
    launch_only_ms = cuda_ms(lambda: entry(*bare), reps)
    plain_ms = cuda_ms(lambda: kkt_inverse_plain(k), 3)
    library_ms = cuda_ms(library, reps)
    dtype = str(k.dtype).split(".")[-1]
    # K's lower triangle read once (the factorization never reads the
    # upper), L^{-1} written once whole (its upper triangle as zeros)
    bytes_moved = bsz * (n * (n + 1) // 2 + n * n) * k.element_size()
    bound_ms, bound_by = bound(bytes_moved, bsz * 2 * n ** 3 / 3, dtype)
    row = {"phase": phase, "shape": list(k.shape), "dtype": dtype, "max_abs_err": abs_err,
           "max_rel_err": rel_err, "resid_inf_kernel": res_k, "resid_inf_plain": res_p,
           "upper_zero": True, "ms": ms, "launch_only_ms": launch_only_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / ms,
           "library": "torch.linalg.cholesky_ex + torch.linalg.solve_triangular",
           "library_ms": library_ms,
           "library_max_abs_err": (ll - li).abs().amax().item()}
    emit(row)
    assert rel_err < (1e-3 if f32 else 1e-9), f"kernel A disagrees with plain at {row['shape']}: {rel_err}"
    assert res_k <= max(4.0 * res_p, 1e-3 if f32 else 1e-10), f"kernel A residual {res_k} vs {res_p}"
    return row


def phase_kernel_a(rng, dev):
    """Kernel A at the fleet's shapes, and its finite pattern on non-PD
    batches (the IPM's finite-step mask reads it per matrix)."""
    import torch
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse, kkt_inverse_plain

    rows = [kernel_a_row("kernel_a", torch.from_numpy(spd_batch(rng, bsz, dtype=dtype)).to(dev),
                         200)
            for bsz, dtype in ((128, "float32"), (1, "float32"), (2, "float64"))]
    for dtype in (torch.float32, torch.float64):
        k = torch.from_numpy(non_pd_batch(rng, 136)).to(dev, dtype)
        li = kkt_inverse(k)
        lp = kkt_inverse_plain(k)
        torch.cuda.synchronize()
        flags = lambda x: torch.isfinite(x).all(dim=(1, 2)).tolist()
        ok = [i for i, f in enumerate(NON_PD_FINITE) if f]
        err = ((li[ok] - lp[ok]).abs().amax() / lp[ok].abs().amax()).item()
        row = {"phase": "kernel_a_non_pd", "shape": list(k.shape),
               "dtype": str(dtype).split(".")[-1],
               "finite_kernel": flags(li), "finite_plain": flags(lp),
               "max_rel_err_finite": err}
        emit(row)
        assert flags(li) == flags(lp) == NON_PD_FINITE, row
        assert err <= (2e-5 if dtype == torch.float32 else 1e-12), row
    return rows


def projection_batch(rng, count, rows=15, n_active=4, n_obs=16):
    """Problems shaped like the tick's: every 16 obstacles share a segment,
    4 of them active boxes (6 rows + 9 zero rows at b = 10 - 0.001), the
    rest inactive (all rows a = 0, b = 10 - 0.001)."""
    import numpy as np

    a = np.zeros((count, rows, 3))
    b = np.full((count, rows), 10.0 - 0.001)
    p0 = np.zeros((count, 3))
    p1 = np.zeros((count, 3))
    eye = np.eye(3)
    for i in range(count):
        if i % n_obs < n_active:
            center = rng.uniform(-0.5, 0.5, 3)
            half = rng.uniform(0.05, 0.2, 3)
            a[i, :6] = np.vstack([eye, -eye])
            b[i, :6] = np.concatenate([center + half, -(center - half)]) - 0.001
        if i % n_obs == 0:
            s0 = rng.uniform(-0.8, 0.8, 3)
            s1 = s0 + rng.uniform(-0.1, 0.1, 3)
        p0[i], p1[i] = s0, s1
    f = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f(a), f(b), f(p0), f(p1)


def planner_projection_batch(rng, calls):
    """Problems shaped like the planner's `find_set_line` batch: per
    coalesced call the 16 obstacle slots of fleet draw 1 + call % 8 (floor
    and 3 boxes inflated as the planner does, 12 inactive slots at b = 10),
    all b shifted by -0.001, and one segment inside the fleet's workspace."""
    import numpy as np
    from boundplanner_tpu_torch.parallel.fleet import random_scene
    from boundplanner_tpu_torch.planner.set_finder import build_obstacle_arrays

    a, b, p0, p1 = [], [], [], []
    for call in range(calls):
        draw = 1 + call % 8
        obstacles, _ = random_scene(np.random.default_rng(PLAN_SEED + 1000 * draw),
                                    PLAN_OBSTACLES)
        arr = build_obstacle_arrays(obstacles, PLAN_OBS_INFLATE)
        s0, s1 = rng.uniform(PLAN_WS_MIN, PLAN_WS_MAX, (2, 3))
        a.append(arr.a)
        b.append(arr.b - 0.001)
        p0.append(np.tile(s0, (len(arr.b), 1)))
        p1.append(np.tile(s1, (len(arr.b), 1)))
    f = lambda x: np.ascontiguousarray(np.concatenate(x), dtype=np.float32)
    return f(a), f(b), f(p0), f(p1)


def edge_projection_batch():
    """Five edge cases of kernel B's row rule and exits, R = 8, a box in
    rows 0-5 unless said, rows 6-7 zero: 0 zero rows with b = -3 and
    -1e25 (no-ops, dropped; row 7 is a = (-0, 0, -0)); 1 a zero row with
    b = -1e30 (kept: -b / 1e-12 overflows, NaN in the kernel and the
    plain version alike); 2 a NaN in p0; 3 an all-zero problem (a = 0,
    b = 0, p0 = p1 = 0); 4 a segment through the box (the inside case of
    tests/test_torch_kernels.py). Problems 1 and 2 end non-finite."""
    import numpy as np

    eye = np.eye(3)
    box_a = np.vstack([eye, -eye])
    center, half = np.array([0.2, -0.1, 0.3]), np.array([0.15, 0.1, 0.2])
    box_b = np.concatenate([center + half, -(center - half)])
    a = np.zeros((5, 8, 3))
    b = np.full((5, 8), 10.0 - 0.001)
    a[[0, 1, 2, 4], :6] = box_a
    b[[0, 1, 2], :6] = box_b
    b[4, :6] = 0.5
    b[0, 6:] = (-3.0, -1e25)
    a[0, 7] = (-0.0, 0.0, -0.0)
    b[1, 6] = -1e30
    b[3] = 0.0
    p0 = np.array([[1.0, 0.5, 0.9]] * 3 + [[0.0] * 3, [-1.0, 0.0, 0.0]])
    p1 = np.array([[0.8, -0.6, 1.2]] * 3 + [[0.0] * 3, [1.0, 0.0, 0.0]])
    p0[2, 0] = np.nan
    f = lambda x: np.ascontiguousarray(x, dtype=np.float32)
    return f(a), f(b), f(p0), f(p1)


EDGE_FINITE = [True, False, False, True, True]


def real_tick_batch(payload, cfg, dev):
    """The (a, b, p0, p1) that the cached fleet's first tick hands to kernel
    B (its link collision sets), captured on the card in f32."""
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops.proj_chain import capture_tick_inputs
    from boundplanner_tpu_torch.parallel.fleet_cache import to_torch

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    return capture_tick_inputs(carry, q0, obs, FleetMPC(cfg, device=dev, dtype=torch.float32))


def kernel_b_cases(rng, dev, real):
    """(fold, inputs on the card) at kernel B's folds: the tick's and the
    planner's, one arm's tick, the fleet's first tick, the edge cases."""
    import numpy as np
    import torch

    cases = []
    for fold, count in (("tick", 12288), ("tick", 1), ("planner", 16), ("planner", 1024)):
        batch = (projection_batch(rng, count) if fold == "tick"
                 else planner_projection_batch(rng, count // 16))
        cases.append((fold, [torch.from_numpy(x).to(dev) for x in batch]))
    # one arm's tick (6 links x 16 obstacle slots), its own generator so
    # the folds above keep their inputs
    cases.append(("runtime_tick", [torch.from_numpy(x).to(dev) for x in
                                   projection_batch(np.random.default_rng(96), 96)]))
    # the escalation retry's link sets: 4 lanes x 96 problems
    cases.append(("retry_tick", [torch.from_numpy(x).to(dev) for x in
                                 projection_batch(np.random.default_rng(384), 384)]))
    # the escalation probe's tick and retry: 3 scenes x 96 problems
    cases.append(("probe_tick", [torch.from_numpy(x).to(dev) for x in
                                 projection_batch(np.random.default_rng(288), 288)]))
    cases.append(("tick_real", list(real)))
    cases.append(("edge", [torch.from_numpy(x).to(dev) for x in edge_projection_batch()]))
    return cases


def kernel_b_launch_only_ms(entry, args, reps):
    """Kernel B's C entry launched straight into preallocated outputs."""
    import torch

    a = args[0]
    count, rows = a.shape[0], a.shape[1]
    out = (torch.empty_like(args[2]), torch.empty(count, dtype=a.dtype, device=a.device),
           torch.empty(count, dtype=a.dtype, device=a.device))
    bare = (*(t.data_ptr() for t in (*args, *out)), count, rows,
            torch.cuda.current_stream(a.device).cuda_stream)
    return cuda_ms(lambda: entry(*bare), reps)


def phase_kernel_b(rng, dev, real):
    """Kernel B at the tick's shapes (fold "tick"), the planner's (fold
    "planner", P = 16 per coalesced call), the fleet's first tick (fold
    "tick_real") and the edge cases (fold "edge")."""
    import torch
    from boundplanner_tpu_torch.ops._build import library
    from boundplanner_tpu_torch.ops.cuda_proj import (
        DYKSTRA_SWEEPS, OUTER_ITERS, line_polytope_projection, line_polytope_projection_plain)
    from boundplanner_tpu_torch.ops.proj_chain import kept_rows, replay, warp_max

    entry = library().bp_line_polytope_f32
    rows_out = []
    for fold, args in kernel_b_cases(rng, dev, real):
        count, rows = args[0].shape[0], args[0].shape[1]
        out_k = line_polytope_projection(*args)
        out_p = line_polytope_projection_plain(*args)
        torch.cuda.synchronize()
        same_pattern = all(torch.equal(torch.isfinite(u), torch.isfinite(v))
                           for u, v in zip(out_k, out_p))
        finite_k = (torch.isfinite(out_k[0]).all(dim=-1) & torch.isfinite(out_k[1])
                    & torch.isfinite(out_k[2])).tolist()
        err = max(float(torch.where(torch.isfinite(u) & torch.isfinite(v), u - v, 0.0)
                        .abs().amax()) for u, v in zip(out_k, out_p))
        ms = cuda_ms(lambda: line_polytope_projection(*args), 50)
        launch_only_ms = kernel_b_launch_only_ms(entry, args, 50)
        plain_ms = cuda_ms(lambda: line_polytope_projection_plain(*args), 5)
        bytes_moved = sum(t.numel() * t.element_size() for t in (*args, *out_k))
        kept = int(kept_rows(args[0], args[1]).sum())
        # the row corrections of each warp's slowest problem, replayed on
        # the host in numpy (no FMA contraction: the plain version's rounding)
        warps = warp_max(replay(*(t.cpu().numpy() for t in args))[2]["chain"])
        per_problem = (B_OPS_SETUP + OUTER_ITERS * (B_OPS_PHI + B_OPS_POINT) + B_OPS_PHI
                       + B_OPS_DIST)
        per_row = B_OPS_SETUP_ROW + (1 + OUTER_ITERS) * DYKSTRA_SWEEPS * B_OPS_ROW
        bound_ms, bound_by = bound(bytes_moved, count * per_problem + kept * per_row, "float32")
        bound_all, _ = bound(bytes_moved, count * (per_problem + rows * per_row), "float32")
        row = {"phase": "kernel_b", "fold": fold, "problems": count, "rows": rows,
               "kept_rows": kept, "chain_warp_max_mean": float(warps.mean()),
               "chain_warp_max_max": int(warps.max()),
               "max_abs_err": err, "same_finite_pattern": same_pattern,
               "ms": ms, "launch_only_ms": launch_only_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "bound_ms_all_rows": bound_all,
               "roofline_share": bound_ms / ms, "library_ms": None}
        emit(row)
        assert same_pattern, f"kernel B's finite pattern differs from plain ({fold})"
        assert finite_k == (EDGE_FINITE if fold == "edge" else [True] * count), \
            f"kernel B: {finite_k.count(False)} non-finite problems ({fold})"
        # same f32 arithmetic up to FMA contraction in the kernel's sums
        assert err < 1e-4, f"kernel B disagrees with plain ({fold}, P={count}): {err}"
        rows_out.append(row)
    return rows_out


def phase_compare_kernel_b(rng, dev, real, source, out_dir):
    """Kernel B of ``source`` against this tree's, in turns (source, this,
    this, source) at kernel B's folds: the wrapper's time, the bare
    launch's, and whether both give the same outputs by value."""
    import ctypes
    import torch
    from boundplanner_tpu_torch.ops import _build, cuda_proj

    so = os.path.join(_build.BUILD_DIR, "kernel_b_compare.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, source],
                          capture_output=True, text=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nvcc_compare.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    other = ctypes.CDLL(so)
    other.bp_line_polytope_f32.argtypes = list(_build._SIGNATURES["bp_line_polytope_f32"])
    other.bp_line_polytope_f32.restype = ctypes.c_int
    libs = {"source": other, "this": _build.library()}
    cases = kernel_b_cases(rng, dev, real)
    outs = {}
    try:
        for turn, name in enumerate(("source", "this", "this", "source")):
            cuda_proj.library = lambda lib=libs[name]: lib
            for i, (fold, args) in enumerate(cases):
                outs[name, i] = cuda_proj.line_polytope_projection(*args)
                emit({"phase": "kernel_b_compare", "turn": turn, "tree": name, "fold": fold,
                      "problems": args[0].shape[0],
                      "ms": cuda_ms(lambda: cuda_proj.line_polytope_projection(*args), 50),
                      "launch_only_ms": kernel_b_launch_only_ms(
                          libs[name].bp_line_polytope_f32, args, 50)})
    finally:
        cuda_proj.library = _build.library
    torch.cuda.synchronize()
    # equal values and the same NaNs (-0 == +0)
    equal = {f"{fold}:{args[0].shape[0]}": all(
        bool(((u == v) | (u.isnan() & v.isnan())).all())
        for u, v in zip(outs["this", i], outs["source", i]))
        for i, (fold, args) in enumerate(cases)}
    result = {"phase": "kernel_b_compare", "source": source, "equal_by_value": equal}
    emit(result)
    return result


def phase_small_f64(payload, cfg, dev, config="perf"):
    """2 scenes x 2 ticks in f64: the card's route (kernel A in every IPM,
    the exact projection IPM) against the CPU's plain route, for the
    solver configuration named ``config``."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import fleet_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch, tree_map

    small = tree_map(lambda a: np.asarray(a)[:2],
                     (payload["carry"], payload["q0"], payload["obs"]))
    res = {}
    for where in ("cpu", dev):
        c, q, o = to_torch(small, where, torch.float64)
        model = FleetMPC(cfg, device=where, dtype=torch.float64)
        _, recs = fleet_rollout(c, q, o, model, 2)
        res[str(where)] = to_numpy(recs)
    a, b = res["cpu"], res[str(dev)]
    err = max(float(np.max(np.abs(a[k] - b[k]))) for k in ("q", "phi", "p"))
    same = bool(np.array_equal(a["success"], b["success"]))
    row = {"phase": "small_f64_cpu_vs_card", "config": config, "max_abs_err_q_phi_p": err,
           "same_success": same}
    emit(row)
    assert same and err < 1e-6, f"f64 card rollout disagrees with the CPU ({config}): {err}"
    return row


def phase_main(payload, cfg, dev):
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout, fleet_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch, tree_map

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    batch = q0.shape[0]
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)

    chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)  # warm-up
    torch.cuda.synchronize()
    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    t0 = time.perf_counter()
    final, recs = chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chol_inverse": kkt_inverse.launches,
                "line_polytope": line_polytope_projection.launches}

    for k, v in recs.items():
        assert v.shape[:2] == (batch, N_TICKS), (k, v.shape)
        assert torch.isfinite(v.float()).all(), f"non-finite record {k}"
    for leaf in final:
        if isinstance(leaf, torch.Tensor):
            assert torch.isfinite(leaf.float()).all(), "non-finite final carry"
    want_a = cfg.sqp_iters * cfg.qp_iters * N_TICKS * (batch // CHUNK)
    want_b = N_TICKS * (batch // CHUNK)
    assert launches["chol_inverse"] == want_a, (launches, want_a)
    assert launches["line_polytope"] == want_b, (launches, want_b)

    success_rate = float(recs["success"].float().mean())
    max_viol = float(recs["viol"].amax())
    mean_phi = float(recs["phi"][:, -1].mean())

    one = tree_map(lambda t: t[:1], (carry, q0, obs))
    fleet_rollout(*one, model, 1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(LATENCY_REPS):
        t1 = time.perf_counter()
        _, r1 = fleet_rollout(*one, model, 1)
        float(r1["phi"][0, -1])
        lats.append(1e3 * (time.perf_counter() - t1))
    lats = np.asarray(lats)
    result = {
        "phase": "main_path",
        "metric": "boundmpc_solves_per_s_per_chip",
        "workload": f"random_fleet_{batch}",   # bench.py's name for this fleet
        "ticks": N_TICKS,
        "value": batch * N_TICKS / wall,
        "unit": "solves/s",
        "success_rate": success_rate,
        "max_viol": max_viol,
        "mean_phi_final": mean_phi,
        "tick_latency_ms_p50": float(np.percentile(lats, 50)),
        "tick_latency_ms_p95": float(np.percentile(lats, 95)),
        "tick_latency_ms_p99": float(np.percentile(lats, 99)),
        "tick_latency_ms_max": float(np.max(lats)),
        "latency_reps": LATENCY_REPS,
        "wall_s": wall,
        "launches": launches,
    }
    emit(result)
    # sanity floor against a broken port, below the CPU-mesh basin (0.932)
    assert success_rate >= 0.90, f"success_rate {success_rate} < 0.90"
    return result, to_numpy(recs)


def phase_main_routes(payload, cfg, dev):
    """The main path's fleet quality with a kernel's route swapped, in the
    same call: kernel A again (is the rollout repeatable?), its plain
    version (the column-step order of the JAX package's off-TPU path),
    kernel A in f64 with L^{-1} rounded to f32 once, and kernel B's plain
    version (no FMA contraction). Shows whether the f32 fleet's success
    moves with the rounding of L^{-1}, or of the link sets, alone. Quality
    only: these launches are not the main path's counts."""
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops import cuda_proj, qp
    from boundplanner_tpu_torch.ops.cuda_proj import (line_polytope_projection,
                                                      line_polytope_projection_plain)
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse, kkt_inverse_plain
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_torch

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)
    # route name -> (kernel A's route, kernel B's route)
    routes = {"kernel_a_f32": (kkt_inverse, line_polytope_projection),
              "plain_f32": (kkt_inverse_plain, line_polytope_projection),
              "kernel_a_f64": (lambda k: kkt_inverse(k.double()).to(k.dtype),
                               line_polytope_projection),
              "plain_b_f32": (kkt_inverse, line_polytope_projection_plain)}
    row = {"phase": "main_path_routes"}
    try:
        for name, (route_a, route_b) in routes.items():
            qp.kkt_inverse, cuda_proj.line_polytope_projection = route_a, route_b
            t0 = time.perf_counter()
            _, recs = chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)
            torch.cuda.synchronize()
            row[name] = {"success_rate": float(recs["success"].float().mean()),
                         "max_viol": float(recs["viol"].amax()),
                         "mean_phi_final": float(recs["phi"][:, -1].mean()),
                         "wall_s": time.perf_counter() - t0}
    finally:
        qp.kkt_inverse, cuda_proj.line_polytope_projection = (kkt_inverse,
                                                              line_polytope_projection)
    emit(row)
    return row


def solver_launches(cfg, ticks, fired):
    """Kernel A's and B's launches of ``ticks`` fleet ticks under ``cfg``,
    ``fired`` of them escalated: a factorization per IPM iteration, per
    ``kkt_every`` of them when frozen, or one per SQP iteration under ADMM;
    the link sets once per tick and once per retry."""
    def factorizations(sqp, qp):
        return sqp * (1 if cfg.qp_solver == "admm" else -(-qp // cfg.kkt_every))
    want_a = (ticks * factorizations(cfg.sqp_iters, cfg.qp_iters)
              + fired * factorizations(cfg.esc_sqp_iters, cfg.esc_qp_iters))
    return {"chol_inverse": want_a, "line_polytope": ticks + fired}


def phase_solver_configs(payload, dev, main_res):
    """Each of SOLVER_CONFIGS on the cached fleet at full width in f32 for
    SOLVER_TICKS ticks (chunk 128): launches (asserted), finite records,
    quality beside the main path's, wall time; then 2 scenes x 2 ticks of
    it in f64 on the card against the CPU (`phase_small_f64`)."""
    import dataclasses
    import torch
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse
    from boundplanner_tpu_torch.parallel import batch
    from boundplanner_tpu_torch.parallel.fleet_cache import to_torch

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    chunks = q0.shape[0] // CHUNK
    rows = {}
    for name, fields in SOLVER_CONFIGS.items():
        cfg = dataclasses.replace(perf_mpc_params(), **fields)
        model = FleetMPC(cfg, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        kkt_inverse.launches = 0
        line_polytope_projection.launches = 0
        batch._escalate_failed_lanes.retries = 0
        t0 = time.perf_counter()
        final, recs = batch.chunked_rollout(carry, q0, obs, model, SOLVER_TICKS, chunk=CHUNK)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"chol_inverse": kkt_inverse.launches,
                    "line_polytope": line_polytope_projection.launches}
        fired = batch._escalate_failed_lanes.retries
        finite = (all(bool(torch.isfinite(v.float()).all()) for v in recs.values())
                  and all(bool(torch.isfinite(t.float()).all()) for t in final
                          if isinstance(t, torch.Tensor)))
        success = float(recs["success"].float().mean())
        row = {"phase": "solver_configs", "config": name, "fields": fields,
               "ticks": SOLVER_TICKS, "scenes": q0.shape[0], "success_rate": success,
               "success_minus_main": (None if main_res is None
                                      else success - main_res["success_rate"]),
               "max_viol": float(recs["viol"].amax()),
               "mean_phi_final": float(recs["phi"][:, -1].mean()), "wall_s": wall,
               "launches": launches, "want": solver_launches(cfg, SOLVER_TICKS * chunks, fired),
               "escalated_ticks": fired, "finite": finite}
        emit(row)
        assert finite, f"{name}: non-finite records or carry"
        assert launches == row["want"], (name, launches, row["want"])
        if name in SOLVER_FLOORED:
            assert success >= 0.90, f"{name}: success_rate {success} < 0.90"
        row["small_f64"] = phase_small_f64(payload, cfg, dev, name)
        rows[name] = row
    return rows


def phase_kernel_a_planner(rng, dev):
    """Kernel A at the planner's QP sizes and batches (PLANNER_CHOL_SHAPES),
    f32, with the bars of `phase_kernel_a`."""
    import torch

    return [kernel_a_row("kernel_a_planner",
                         torch.from_numpy(spd_batch(rng, bsz, n=n, m=48)).to(dev), 50)
            for bsz, n in PLANNER_CHOL_SHAPES]


def plan_draw(draw, cfg, device, plan_dtype, dtype, broker=None):
    """`plan_scene` of fleet draw ``draw`` (the draw scheme of the cached
    fleet: rng seed PLAN_SEED + 1000 draw, planner seed PLAN_SEED + draw)."""
    import numpy as np
    from boundplanner_tpu_torch.parallel.fleet import DEMO_Q0, plan_scene, random_scene

    obstacles, goal = random_scene(np.random.default_rng(PLAN_SEED + 1000 * draw),
                                   PLAN_OBSTACLES)
    return plan_scene(DEMO_Q0, goal, obstacles, PLAN_SEED + draw, cfg, dtype,
                      broker=broker, device=device, plan_dtype=plan_dtype)


def phase_planner_f64(cfg, dev):
    """Fleet draw 1 planned in f64 on the CPU and on the card (exact
    projection IPM, kernel A in f64): the same via count, and vias, sets
    and every carry leaf within 1e-9."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.utils.tree import tree_map

    out, secs = {}, {}
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        planned = plan_draw(1, cfg, where, torch.float64, np.float64)
        secs[str(where)] = time.perf_counter() - t0
        assert planned is not None, f"draw 1 failed to plan on {where}"
        out[str(where)] = planned[0]
    a, b = out["cpu"], out[str(dev)]
    errs = []
    tree_map(lambda x, y: errs.append(float(np.max(np.abs(np.asarray(x, float)
                                                          - np.asarray(y, float))))), a, b)
    err = max(errs)
    n_via = int(a.path.num_sectors) + 2
    row = {"phase": "planner_f64_cpu_vs_card", "vias_cpu": n_via,
           "vias_card": int(b.path.num_sectors) + 2,
           "max_abs_err_vias": float(np.abs(a.path.p - b.path.p).max()),
           "max_abs_err_sets": float(max(np.abs(a.path.a_set - b.path.a_set).max(),
                                         np.abs(a.path.b_set - b.path.b_set).max())),
           "max_abs_err_carry": err, "seconds_cpu": secs["cpu"], "seconds_card": secs[str(dev)]}
    emit(row)
    assert row["vias_cpu"] == row["vias_card"], row
    assert err <= 1e-9, f"f64 plan on the card disagrees with the CPU: {err}"
    return row


def corridor_ok(carry, obs, i):
    """The invariants of tests/test_planner.py for scene i: both ends of
    every segment inside its set (2e-3), and 25 samples of every segment
    outside every original obstacle."""
    import numpy as np

    path = carry.path
    n_via = int(path.num_sectors[i]) + 2
    p = np.asarray(path.p[i, :n_via], np.float64)
    for s in range(n_via - 1):
        a, b = np.asarray(path.a_set[i, s], np.float64), np.asarray(path.b_set[i, s], np.float64)
        if max(np.max(a @ p[s] - b), np.max(a @ p[s + 1] - b)) >= 2e-3:
            return False
        for t in np.linspace(0.0, 1.0, 25):
            x = (1 - t) * p[s] + t * p[s + 1]
            for o in np.nonzero(obs.mask[i])[0]:
                a_o = np.asarray(obs.a[i, o, :6], np.float64)
                b_o = np.asarray(obs.b[i, o, :6], np.float64)
                if np.max(a_o @ x - b_o) <= -1e-6:
                    return False
    return True


def kept_draws(obs):
    """The fleet draw of each planned scene, found by regenerating draws
    1 .. 4 * scenes (the builder's limit) and matching obstacle arrays."""
    import numpy as np
    from boundplanner_tpu_torch.parallel.fleet import random_scene
    from boundplanner_tpu_torch.planner.set_finder import build_obstacle_arrays

    n = obs.b.shape[0]
    drawn = [build_obstacle_arrays(random_scene(np.random.default_rng(PLAN_SEED + 1000 * d),
                                                PLAN_OBSTACLES)[0], dtype=obs.b.dtype).b
             for d in range(1, 4 * n + 1)]
    return [next((d + 1 for d, b in enumerate(drawn) if np.array_equal(b, obs.b[i])), None)
            for i in range(n)]


def compare_with_cache(carry, obs, payload):
    """Each planned scene against the cached JAX-built scene whose obstacle
    arrays are bit-equal (the same draw): same segment count, via-point
    distance where the count agrees. Reported, not asserted."""
    import numpy as np

    c_obs, c_path = payload["obs"], payload["carry"].path
    same, dists, matched = 0, [], 0
    for i in range(obs.a.shape[0]):
        hits = [j for j in range(c_obs.a.shape[0])
                if np.array_equal(c_obs.a[j], obs.a[i]) and np.array_equal(c_obs.b[j], obs.b[i])]
        if not hits:
            continue
        j = hits[0]
        matched += 1
        if int(c_path.num_sectors[j]) == int(carry.path.num_sectors[i]):
            same += 1
            n_via = int(c_path.num_sectors[j]) + 2
            dists.append(float(np.max(np.linalg.norm(
                np.asarray(c_path.p[j, :n_via], np.float64)
                - np.asarray(carry.path.p[i, :n_via], np.float64), axis=-1))))
    return {"matched_scenes": matched,
            "same_segment_count_share": same / matched if matched else None,
            "via_dist_median": float(np.median(dists)) if dists else None,
            "via_dist_max": float(np.max(dists)) if dists else None}


def phase_plan_fleet(cfg, dev, payload):
    """The planner path on the card: one plan first (its time), then the
    threaded, broker-coalesced fleet builder in f32."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse
    from boundplanner_tpu_torch.parallel.fleet import build_fleet_threaded

    t0 = time.perf_counter()
    one = plan_draw(1, cfg, dev, torch.float32, np.float32)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    emit({"phase": "plan_one", "seconds": one_s, "planned": one is not None})

    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    t0 = time.perf_counter()
    carry, q0, obs, brk = build_fleet_threaded(
        PLAN_SCENES, cfg, seed=PLAN_SEED, n_obstacles=PLAN_OBSTACLES, dtype=np.float32,
        n_threads=PLAN_THREADS, linger=0.030, device=dev, plan_dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chol_inverse": kkt_inverse.launches,
                "line_polytope": line_polytope_projection.launches}
    sound = [corridor_ok(carry, obs, i) for i in range(PLAN_SCENES)]
    draws = kept_draws(obs)
    row = {"phase": "plan_fleet", "scenes": PLAN_SCENES, "wall_s": wall,
           "plans_per_s": PLAN_SCENES / wall, "one_plan_s": one_s,
           "kept_draws": draws, "draws": max(d or 0 for d in draws),
           "broker": {"calls_served": brk.calls_served, "batches_run": brk.batches_run,
                      "coalesced_calls": brk.coalesced_calls},
           "launches": launches, "corridors_sound": sum(sound),
           "segments": [int(n) + 1 for n in carry.path.num_sectors],
           **compare_with_cache(carry, obs, payload)}
    emit(row)
    assert launches["chol_inverse"] > 0 and launches["line_polytope"] > 0, launches
    assert all(sound), f"corridor invariants fail for scenes {[i for i, ok in enumerate(sound) if not ok]}"
    return (carry, q0, obs), row


def phase_planned_rollout(fleet, cfg, dev):
    """The planned fleet through the MPC for N_TICKS ticks on the card."""
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_torch

    carry, q0, obs = to_torch(fleet, dev, torch.float32)
    batch = q0.shape[0]
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)
    t0 = time.perf_counter()
    _, recs = chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for k, v in recs.items():
        assert v.shape[:2] == (batch, N_TICKS), (k, v.shape)
        assert torch.isfinite(v.float()).all(), f"non-finite record {k}"
    row = {"phase": "planned_rollout", "scenes": batch, "ticks": N_TICKS, "wall_s": wall,
           "success_rate": float(recs["success"].float().mean()),
           "success_per_scene": recs["success"].float().mean(dim=1).tolist(),
           "max_viol": float(recs["viol"].amax()),
           "mean_phi_final": float(recs["phi"][:, -1].mean())}
    emit(row)
    assert row["success_rate"] >= PLANNED_FLOOR, \
        f"planned fleet success_rate {row['success_rate']} < {PLANNED_FLOOR}"
    return row


def phase_kernel_a_shard(dev):
    """Kernel A at (SHARD, 136, 136) f32: the tick of one rank's (or one
    device's) block of the sharded rollouts, with the bars of
    `phase_kernel_a` (its own seed, so the other phases' inputs stay)."""
    import numpy as np
    import torch

    k = spd_batch(np.random.default_rng(SHARD), SHARD, dtype="float32")
    return kernel_a_row("kernel_a_shard", torch.from_numpy(k).to(dev), 200)


def phase_kernel_a_retry(dev):
    """Kernel A at (4, 136, 136) f32: the escalation retry's sub-batch of
    ``esc_lanes=4`` (the ``esc4`` solver configuration), with the bars of
    `phase_kernel_a` (its own seed)."""
    import numpy as np
    import torch

    esc = SOLVER_CONFIGS["esc4"]["esc_lanes"]
    k = spd_batch(np.random.default_rng(esc), esc, dtype="float32")
    return kernel_a_row("kernel_a_retry", torch.from_numpy(k).to(dev), 200)


def phase_worst_tick(payload, cfg, dev, out_dir):
    """The main path's worst attempted violation: the fleet rolled out again
    tick by tick (chunk 128, as the main path: the same records), the
    scene and tick of the largest ``viol`` found, and that scene's carry,
    measurement and obstacles before that tick saved (``--out DIR``,
    ``worst_tick_carry.npz`` in the checkpoint format and
    ``worst_tick_inputs.npz``), then the tick replayed on the card at
    batch 128 (the same inputs: the same outputs) and at batch 1."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.checkpoint import save_carry
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import _plant_measurement
    from boundplanner_tpu_torch.utils.integration import integrate_jerk_step
    from boundplanner_tpu_torch.utils.tree import to_numpy, to_torch, tree_map

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    assert q0.shape[0] == CHUNK
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)
    # `batch.fleet_rollout`'s loop, keeping each tick's carry and measurement
    zeros = torch.zeros_like(q0)
    carry_i, q, dq, ddq, jerk, qf = carry, q0, zeros, zeros, zeros, q0
    before, viols, oks = [], [], []
    with torch.no_grad():
        for _ in range(N_TICKS):
            meas = _plant_measurement(q, dq, ddq, jerk, qf, model.st.chain)
            before.append((carry_i, meas))
            carry_i, out = model.tick(carry_i, meas, obs)
            u0, u1 = out["dddq"][:, 0], out["dddq"][:, 1]
            q, dq, ddq = integrate_jerk_step(q, dq, ddq, u0, u1, cfg.dt)
            jerk, qf = u1, out["q"][:, -1]
            viols.append(out["viol"])
            oks.append(out["success"])
    recs = {"viol": torch.stack(viols, 1), "success": torch.stack(oks, 1)}
    viol = recs["viol"].float()
    flat = int(torch.argmax(viol))
    scene, tick = divmod(flat, N_TICKS)
    carry_t, meas_t = before[tick]
    with torch.no_grad():
        _, out_all = model.tick(carry_t, meas_t, obs)
        one = lambda tree: tree_map(lambda t: t[scene:scene + 1], tree)
        _, out_one = model.tick(one(carry_t), one(meas_t), one(obs))
    row = {"phase": "worst_tick", "scene": scene, "tick": tick,
           "viol": float(viol[scene, tick]), "success": bool(recs["success"][scene, tick]),
           "viol_replay_batch128": float(out_all["viol"][scene]),
           "viol_replay_batch1": float(out_one["viol"][0]),
           "success_replay_batch1": bool(out_one["success"][0]),
           "viol_ticks_of_scene": viol[scene].tolist()}
    emit(row)
    assert row["viol_replay_batch128"] == row["viol"], row
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        drop = lambda tree: to_numpy(tree_map(lambda t: t[scene], tree))
        save_carry(os.path.join(out_dir, "worst_tick_carry.npz"), drop(carry_t))
        arrays = {f"meas.{k}": v for k, v in drop(meas_t).items()}
        arrays.update({f"obs.{k}": v for k, v in drop(obs)._asdict().items()})
        np.savez(os.path.join(out_dir, "worst_tick_inputs.npz"), scene=scene, tick=tick,
                 viol_card=row["viol"], viol_card_batch1=row["viol_replay_batch1"], **arrays)
    return row


def random_roadmap(rng, n_junctions):
    """A SetRoadmap with random positive weights over a random connected
    topology (dummy junctions: only the adjacency matters for search)."""
    import numpy as np
    from boundplanner_tpu_torch.planner.roadmap import Junction, SetRoadmap

    rm = SetRoadmap(w_size=0.0, w_bias=0.0, c_fit=0.0)
    for _ in range(n_junctions):
        rm.junctions.append(Junction(a=np.zeros((1, 3)), b=np.zeros(1), owners=(0, 0),
                                     anchor=np.zeros(3), via=np.zeros(4), fits=True))
        rm._adj.append({})
    order = rng.permutation(n_junctions)
    for i in range(1, n_junctions):
        u, v = int(order[i]), int(order[rng.integers(0, i)])
        rm._adj[u][v] = rm._adj[v][u] = float(rng.uniform(0.1, 2.0))
    for _ in range(2 * n_junctions):
        u, v = (int(x) for x in rng.integers(0, n_junctions, 2))
        if u != v:
            rm._adj[u][v] = rm._adj[v][u] = float(rng.uniform(0.1, 2.0))
    return rm


def phase_device_search(dev):
    """The batched min-plus shortest path on the card: 128 random roadmaps
    padded to 64 junctions in one call, each path's cost equal to the host
    Dijkstra's (rtol 1e-5), and the call's wall beside the host's."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.planner.device_search import fleet_shortest_paths

    rng = np.random.default_rng(64)
    rms = [random_roadmap(rng, int(rng.integers(4, SPATH_PAD + 1))) for _ in range(SPATH_SCENES)]
    cost = lambda rm, path: sum(rm._adj[u][v] for u, v in zip(path, path[1:]))
    paths = fleet_shortest_paths(rms, n_pad=SPATH_PAD, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fleet_shortest_paths(rms, n_pad=SPATH_PAD, device=dev)
    call_ms = 1e3 * (time.perf_counter() - t0) / 3
    t0 = time.perf_counter()
    host = [rm.shortest_path() for rm in rms]
    host_ms = 1e3 * (time.perf_counter() - t0)
    rel = max(abs(cost(rm, p) - cost(rm, h)) / cost(rm, h) for rm, p, h in zip(rms, paths, host))

    row = {"phase": "device_search", "roadmaps": SPATH_SCENES, "n_pad": SPATH_PAD,
           "max_rel_cost_err": rel, "call_wall_ms": call_ms, "host_dijkstra_wall_ms": host_ms}
    emit(row)
    assert rel <= 1e-5, row
    return row


def phase_fleet_mp(cfg, dev):
    """The process-pool builder on the card: MP_SCENES scenes (seed 7, 3
    boxes + floor, f32) planned by the builder's default count of spawned
    workers on a card (`fleet.CARD_PROCS`) in blocks of
    MP_BLOCK draws, each worker planning on the card with its own context.
    Both kernels must have run in the workers, and every corridor must be
    sound."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.parallel.fleet import build_fleet_mp

    carry, q0, obs, info = build_fleet_mp(
        MP_SCENES, cfg, n_obstacles=PLAN_OBSTACLES, seed=PLAN_SEED, dtype=np.float32,
        block=MP_BLOCK, device=dev, plan_dtype=torch.float32, timeout=900)
    sound = [corridor_ok(carry, obs, i) for i in range(MP_SCENES)]
    workers = info["launches"]["per_worker"]
    row = {"phase": "fleet_mp", "scenes": MP_SCENES, "procs": info["n_procs"], "block": MP_BLOCK,
           "draws": info["draws"], "planned": info["planned"], "wall_s": info["wall_s"],
           "plans_per_s": info["plans_per_s"], "kept_draws": kept_draws(obs),
           "launches": {k: info["launches"][k] for k in ("chol_inverse", "line_polytope")},
           "launches_per_worker": {str(pid): n for pid, n in workers.items()},
           "corridors_sound": sum(sound),
           "segments": [int(n) + 1 for n in carry.path.num_sectors]}
    emit(row)
    assert all(n["chol_inverse"] > 0 and n["line_polytope"] > 0 for n in workers.values()), \
        f"a worker planned without both kernels: {workers}"
    assert all(sound), f"corridor invariants fail for scenes {[i for i, ok in enumerate(sound) if not ok]}"
    return (carry, q0, obs), row


def phase_multi_gpu(payload, cfg, dev):
    """The multi-device tier on one card: the launcher starts 2 ranks of
    ``python -m boundplanner_tpu_torch.parallel.dryrun`` over gloo (both on
    this card); each rolls out its 64 of the cached fleet's 128 scenes for
    10 ticks and asserts the dry-run bars on the global diagnostics, which
    must be the same on both ranks. Each rank's phi per tick and final q
    must equal one process's ``chunked_rollout`` at chunk 64 by value, and
    its launches be 12 of kernel A and 1 of kernel B per tick. Then
    ``dryrun_multichip`` in this process over ``make_mesh()`` (this card),
    the same by value as ``chunked_rollout`` at chunk 128."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel import distributed as dist
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout
    from boundplanner_tpu_torch.parallel.dryrun import dryrun_multichip
    from boundplanner_tpu_torch.utils.tree import to_torch

    t0 = time.perf_counter()
    results = dist.launch([sys.executable, "-m", "boundplanner_tpu_torch.parallel.dryrun",
                           "--ticks", str(DRYRUN_TICKS), "--backend", "gloo"],
                          nproc=DRYRUN_RANKS, timeout=600)
    launch_s = time.perf_counter() - t0
    ranks = sorted((json.loads(next(ln for ln in out.splitlines()
                                     if ln.startswith("DRYRUN_RESULT "))[len("DRYRUN_RESULT "):])
                    for _, out in results), key=lambda r: r["rank"])
    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)
    per = q0.shape[0] // DRYRUN_RANKS
    refs = {}
    for chunk in (per, q0.shape[0]):
        _, recs = chunked_rollout(carry, q0, obs, model, DRYRUN_TICKS, chunk=chunk)
        refs[chunk] = (recs["phi"].cpu().numpy(), recs["q"][:, -1].cpu().numpy())
    phi = np.concatenate([np.asarray(r["phi"], np.float32) for r in ranks])
    q = np.concatenate([np.asarray(r["q"], np.float32) for r in ranks])
    t0 = time.perf_counter()
    mesh = dryrun_multichip(n_ticks=DRYRUN_TICKS)
    mesh_s = time.perf_counter() - t0
    want = {"chol_inverse": cfg.sqp_iters * cfg.qp_iters * DRYRUN_TICKS,
            "line_polytope": DRYRUN_TICKS}
    row = {"phase": "multi_gpu", "ranks": DRYRUN_RANKS, "backend": "gloo",
           "scenes_per_rank": per, "ticks": DRYRUN_TICKS, "launch_wall_s": launch_s,
           "diag": ranks[0]["diag"], "diag_equal_on_ranks": all(r["diag"] == ranks[0]["diag"]
                                                                for r in ranks),
           "launches_per_rank": [r["launches"] for r in ranks], "launches_want": want,
           "max_abs_err_phi_vs_chunked": float(np.abs(phi - refs[per][0]).max()),
           "max_abs_err_q_vs_chunked": float(np.abs(q - refs[per][1]).max()),
           "mesh_devices": mesh["shards"], "mesh_wall_s": mesh_s, "mesh_diag": mesh["diag"],
           "mesh_max_abs_err_phi_vs_chunked": float(np.abs(mesh["phi"] - refs[128][0]).max())}
    emit(row)
    assert [r["lo"] for r in ranks] == [i * per for i in range(DRYRUN_RANKS)], ranks
    assert row["diag_equal_on_ranks"], [r["diag"] for r in ranks]
    assert all(r["launches"] == want for r in ranks), row["launches_per_rank"]
    assert np.array_equal(phi, refs[per][0]) and np.array_equal(q, refs[per][1]), row
    assert np.array_equal(mesh["phi"], refs[128][0]) and np.array_equal(mesh["q"], refs[128][1]), row
    return row


def node_invariants(node, obs_orig):
    """The EE outside every original obstacle (the bar of tests/test_e2e.py),
    q and dq within their limits, every value finite."""
    import numpy as np

    p = node.p_lie[:3]
    for a, b in obs_orig:
        assert np.max(a @ p - b) > -1e-5, f"EE inside an obstacle at tick {node.k_current}"
    rm = node.robot_model
    assert np.all(node.q < rm.q_lim_upper + 1e-6) and np.all(node.q > rm.q_lim_lower - 1e-6), \
        f"joint limit at tick {node.k_current}: {node.q}"
    assert np.all(np.abs(node.dq) < rm.dq_lim_upper + 1e-6), f"velocity limit: {node.dq}"
    for x in (node.q, node.dq, node.ddq, node.p_lie, node.v):
        assert np.isfinite(x).all(), f"non-finite node state at tick {node.k_current}"


def step_counted(node):
    """One node step with the kernels' counts set to 0 just before it;
    returns (kernel A launches, kernel B launches) of the step."""
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse

    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    node.step()
    return kkt_inverse.launches, line_polytope_projection.launches


def drive_to_end(node, obs_orig, want, cap_s, launches):
    """Step ``node`` on the card toward its path end (RUNTIME_MAX_TICKS and
    ``cap_s`` seconds at most), asserting each step's launches ``want``
    (kernel A, kernel B) and the invariants; adds to ``launches``. Returns
    (why it stopped, the EE's least box margin over the ticks)."""
    from boundplanner_tpu_torch.gates import drive_node

    def step(n):
        got = step_counted(n)
        assert got == want, f"launches per step {got}, expected {want}"
        launches[0] += got[0]
        launches[1] += got[1]
        node_invariants(n, obs_orig)

    return drive_node(node, obs_orig, RUNTIME_MAX_TICKS, cap_s, step)


def node_summary(phase, node, goal, launches, want, stop):
    """The row of a runtime phase: progress, goal error, fails, why the
    drive stopped and the EE's least box margin (``stop``, from
    `drive_to_end`), timings."""
    import numpy as np
    from boundplanner_tpu_torch.gates import node_row

    tel = node.telemetry.arrays()
    pct = lambda key, q: float(np.percentile(tel[key], q))
    failed = np.flatnonzero(~tel["success"].astype(bool))
    return {"phase": phase, **node_row(node, goal, *stop),
            "success_share": float(tel["success"].mean()),
            "failed_tick_viols": {int(t): float(tel["viol"][t]) for t in failed},
            "max_viol": float(tel["viol"].max()),
            **{f"t_comp_ms_{name}": 1e3 * pct("t_comp", q)
               for name, q in (("p50", 50), ("p95", 95), ("p99", 99), ("max", 100))},
            **{f"t_loop_ms_{name}": 1e3 * pct("t_loop", q)
               for name, q in (("p50", 50), ("p95", 95), ("p99", 99), ("max", 100))},
            "period_ms": 1e3 * node.dt,
            "launches": {"chol_inverse": launches[0], "line_polytope": launches[1]},
            "launches_per_step": {"chol_inverse": want[0], "line_polytope": want[1]}}


def phase_runtime_f64(dev, rng, plan):
    """The reference's configuration: ``MPCNode(q0)`` with ``MPCParams()``
    in f64 on the card. The first RUNTIME_COMPARE_TICKS ticks also run on
    the CPU (q and p_lie within 1e-6, dq 1e-5); then on toward the path
    end (there, the JAX e2e test's goal and fail bars). Every
    step launches kernel A sqp x qp + 25 times (the SQP's IPM, then the
    f64 link sets' projection IPM) and kernel B never."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.config import MPCParams
    from boundplanner_tpu_torch.mpc import MPCNode

    q0, args, obs_orig, goal, _ = plan
    cfg = MPCParams()
    want = (cfg.sqp_iters * cfg.qp_iters + PROJ_IPM_ITERS, 0)
    card = MPCNode(q0, device=dev)
    cpu = MPCNode(q0, device="cpu")
    assert card.mpc.cfg == cfg and card.dtype == torch.float64
    for node in (card, cpu):
        node.update_reference(*args)
    launches = [0, 0]
    errs = []
    for _ in range(RUNTIME_COMPARE_TICKS):
        got = step_counted(card)
        assert got == want, f"launches per step {got}, expected {want}"
        launches[0] += got[0]
        launches[1] += got[1]
        cpu.step()
        errs.append({k: float(np.abs(getattr(card, k) - getattr(cpu, k)).max())
                     for k in ("q", "dq", "p_lie")})
        node_invariants(card, obs_orig)
    stop = drive_to_end(card, obs_orig, want, RUNTIME_F64_CAP_S, launches)
    row = {**node_summary("runtime_f64", card, goal, launches, want, stop),
           "card_vs_cpu_ticks": RUNTIME_COMPARE_TICKS, "card_vs_cpu_max_abs_err": errs,
           "kernel_a": kernel_a_row("runtime_f64_kkt",
                                    torch.from_numpy(spd_batch(rng, 1, dtype="float64")).to(dev),
                                    100),
           "kernel_a_projection": kernel_a_row(
               "runtime_f64_projection",
               torch.from_numpy(spd_batch(rng, 96, n=4, m=17, dtype="float64")).to(dev), 100)}
    emit(row)
    # the dense IPM amplifies f64 rounding ~1e3-fold a tick in this closed
    # loop: two exact factorization routes on the CPU drift as far apart
    # (dq 2e-9, 8e-7, 4e-6 over 3 ticks; `python -m
    # boundplanner_tpu_torch.mpc.e2e --device cpu`), so dq is held at 1e-5,
    # q and the pose at 1e-6
    for tick, err in enumerate(errs, 1):
        assert err["q"] < 1e-6 and err["p_lie"] < 1e-6 and err["dq"] < 1e-5, \
            f"f64 node on the card disagrees with the CPU at tick {tick}: {err}"
    if row["stopped_by"] == "path_end":
        assert row["goal_err_m"] < 0.02, f"final EE error {row['goal_err_m']}"
        assert row["fails"] <= 2, f"{row['fails']} failed ticks"
    return row


def phase_runtime_f32(dev, plan):
    """The single-arm 10 Hz loop: the same plan, ``MPCNode`` with
    ``perf_mpc_params()`` in f32 on the card, to the path end. Every step
    launches kernel A sqp x qp times and kernel B once. Returns the row and
    the node."""
    import torch
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.mpc import MPCNode

    q0, args, obs_orig, goal, _ = plan
    cfg = perf_mpc_params()
    want = (cfg.sqp_iters * cfg.qp_iters, 1)
    node = MPCNode(q0, params=cfg, device=dev, dtype=torch.float32)
    node.update_reference(*args)
    launches = [0, 0]
    stop = drive_to_end(node, obs_orig, want, RUNTIME_F32_CAP_S, launches)
    row = node_summary("runtime_f32", node, goal, launches, want, stop)
    emit(row)
    if row["stopped_by"] == "path_end":
        assert row["goal_err_m"] < 0.02, f"final EE error {row['goal_err_m']} (f32)"
        assert row["fails"] <= 2, f"{row['fails']} failed ticks (f32)"
    return row, node


def phase_runtime_parts(dev, plan, node):
    """IK on the card against the CPU (f64, 1e-9); and ``save_carry`` of
    the f32 node's carry on the card, ``load_carry`` into a fresh
    ``BoundMPC``, one more step of both: equal outputs and carries."""
    import tempfile

    import numpy as np
    import torch
    from scipy.spatial.transform import Rotation as R
    from boundplanner_tpu_torch.checkpoint import load_carry, save_carry
    from boundplanner_tpu_torch.mpc import BoundMPC
    from boundplanner_tpu_torch.robot.model import RobotModel
    from boundplanner_tpu_torch.utils.tree import to_numpy, tree_map

    q0 = plan[0]
    target = RobotModel(device="cpu").fk(q0 + np.array([0.2, -0.1, 0.15, 0.1, -0.2, 0.1, 0.3]))
    pd, rd = target[:3], R.from_rotvec(target[3:]).as_matrix()
    q_card = RobotModel(device=dev).inverse_kinematics(pd, rd, q0)
    q_cpu = RobotModel(device="cpu").inverse_kinematics(pd, rd, q0)
    ik_err = float(np.abs(q_card - q_cpu).max())

    mpc = node.mpc
    twin = BoundMPC(*plan[1], p0=node.p0, params=node.params, device=dev, dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_carry(os.path.join(tmp, "carry.npz"), mpc.carry)
        twin.carry = load_carry(os.path.join(tmp, "carry.npz"), device=dev, dtype=torch.float32)
    meas = (node.q, node.dq, node.ddq, node.p_lie, node.v, node.jerk, node.qf)
    out_a, out_b = mpc.step(*meas), twin.step(*meas)
    resume_err = max(float(np.abs(out_a[0][k] - out_b[0][k]).max()) for k in out_a[0])
    carry_a, carry_b = [], []
    tree_map(lambda x: carry_a.append(x), to_numpy(mpc.carry))
    tree_map(lambda x: carry_b.append(x), to_numpy(twin.carry))
    carry_equal = all(np.array_equal(x, y) for x, y in zip(carry_a, carry_b))
    row = {"phase": "runtime_parts", "ik_card_vs_cpu_max_abs_err": ik_err,
           "ik_reach_err_m": float(np.abs(RobotModel(device="cpu").fk_pos(q_card) - pd).max()),
           "resume_max_abs_err": resume_err, "resume_carry_equal": carry_equal}
    emit(row)
    assert ik_err < 1e-9, f"IK on the card disagrees with the CPU: {ik_err}"
    assert resume_err == 0.0 and carry_equal, f"resumed step differs: {resume_err}"
    return row


def run_runtime(dev):
    """The single-arm runtime phases on one f64 plan of the e2e scene."""
    import numpy as np
    from boundplanner_tpu_torch.mpc.e2e import plan_e2e

    plan = plan_e2e(dev)
    emit({"phase": "runtime_plan", **plan[4], "vias": len(plan[1][0])})
    rt64 = phase_runtime_f64(dev, np.random.default_rng(5), plan)
    rt32, node32 = phase_runtime_f32(dev, plan)
    parts = phase_runtime_parts(dev, plan, node32)
    return rt64, rt32, parts, plan


# the edges phase: the bound families' test cases (tests/test_bounds.py)
BOUND_CASES = [
    ("compute_bound_params", (0.3, 1.7, 0.05, 0.12, 0.4, 0.45)),
    ("compute_bound_params_four", (0.1, 2.0, 0.02, 0.3, 0.7, 0.2, 0.5)),
    ("compute_bound_params_six", (0.3, 1.7, 0.05, 0.12, 99.0, 0.45)),
    ("compute_bound_params_three", (0.2, 1.1, 0.04, 0.2, 0.3, -0.8)),
]
EDGE_TOL = 1e-10
# --compare-builders: (scenes, workers) of each in-turns comparison
COMPARE_FLEETS = ((2, 2), (4, 4))
EXAMPLE_TICKS = 3        # the examples' MPC ticks (rviz_bringup, planner + MPC)
FLEET_EXAMPLE_TICKS = 5


def card_vs_cpu(fn, dev):
    """max |fn(card) - fn(cpu)| and max |fn(cpu)| over fn's tensors."""
    import torch

    def flat(out):
        return torch.stack(out, -1) if isinstance(out, tuple) else out

    card, cpu = flat(fn(dev)).cpu(), flat(fn(torch.device("cpu")))
    assert card.shape == cpu.shape, (card.shape, cpu.shape)
    return float((card - cpu).abs().max()), float(cpu.abs().max())


def phase_edges(dev, card, main_res, rt64, rt32):
    """The bound families and the rest of ``ops/linalg.py`` on the card in
    f64 against the same calls on the CPU (EDGE_TOL, relative to the
    largest value where it exceeds 1); the FLOP model's MFLOP per solve and
    the achieved GFLOP/s of the main path and the runtime (reported)."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.config import MPCParams, perf_mpc_params
    from boundplanner_tpu_torch.mpc import bounds
    from boundplanner_tpu_torch.mpc.flops import solve_flops
    from boundplanner_tpu_torch.ops import linalg

    f64 = torch.float64
    rng = np.random.default_rng(23)
    errs = {}
    for name, args in BOUND_CASES:
        errs[name] = card_vs_cpu(lambda d: getattr(bounds, name)(*args, device=d), dev)
    phi0 = rng.uniform(0.0, 1.0, 64)
    seg = (phi0, phi0 + rng.uniform(0.5, 2.0, 64), *rng.uniform(0.0, 0.5, (4, 64)))
    errs["compute_bound_params_batched_64"] = card_vs_cpu(
        lambda d: bounds.compute_bound_params(*(torch.as_tensor(x) for x in seg), device=d), dev)
    grid = np.linspace(0.0, 2.0, 33)
    errs["fourth_order_error_bound"] = card_vs_cpu(
        lambda d: bounds.fourth_order_error_bound(grid, *BOUND_CASES[1][1], device=d), dev)

    g = rng.normal(size=(4, 136, 136))
    a = g @ g.transpose(0, 2, 1) + 136 * np.eye(136)
    l = np.linalg.cholesky(a)
    b = rng.normal(size=(4, 136))
    on = lambda x, d: torch.as_tensor(x, dtype=f64, device=d)
    for name, fn in (
            ("solve_lower", lambda d: linalg.solve_lower(on(l, d), on(b, d))),
            ("solve_upper_t", lambda d: linalg.solve_upper_t(on(l, d), on(b, d))),
            ("chol_solve", lambda d: linalg.chol_solve(on(l, d), on(b, d))),
            ("spd_solve", lambda d: linalg.spd_solve(on(a, d), on(b, d))),
            ("blocked_cholesky", lambda d: linalg.blocked_cholesky(on(a, d), nb=34)),
            ("blocked_invert_lower", lambda d: linalg.blocked_invert_lower(on(l, d), nb=34))):
        errs[name] = card_vs_cpu(fn, dev)

    flops_perf = solve_flops(perf_mpc_params())
    flops_dense = solve_flops(MPCParams())
    solves = {"main_path": (flops_perf, main_res["value"]),
              "runtime_f32": (flops_perf, 1e3 / rt32["t_comp_ms_p50"]),
              "runtime_f64": (flops_dense, 1e3 / rt64["t_comp_ms_p50"])}
    row = {"phase": "edges", "card": card,
           "max_abs_err_card_vs_cpu": {k: v[0] for k, v in errs.items()},
           "mflop_per_solve": {"perf_flat": flops_perf["total"] / 1e6,
                               "default_dense": flops_dense["total"] / 1e6},
           "mflop_per_solve_parts_perf": {k: v / 1e6 for k, v in flops_perf.items()},
           "achieved_gflop_per_s": {k: f["total"] * rate / 1e9
                                    for k, (f, rate) in solves.items()},
           "solves_per_s": {k: rate for k, (_, rate) in solves.items()}}
    emit(row)
    for name, (err, scale) in errs.items():
        assert err <= EDGE_TOL * max(1.0, scale), f"{name} on the card disagrees: {err}"
    return row


def phase_sync_fleet(cfg, dev, plan_row, threaded):
    """The phase-synchronous builder on the card (f32) with the settings of
    `phase_plan_fleet`: sound corridors, both kernels launched, q0 and the
    obstacle arrays those of the threaded build's draws; its rate beside
    the threaded builder's from the same run and the broker's widths
    (reported; plan values are not compared: width-2 f32 batches may plan
    differently, fault (e))."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse
    from boundplanner_tpu_torch.parallel.fleet import build_fleet_sync

    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    t0 = time.perf_counter()
    carry, q0, obs, brk = build_fleet_sync(
        PLAN_SCENES, cfg, seed=PLAN_SEED, n_obstacles=PLAN_OBSTACLES, dtype=np.float32,
        n_workers=PLAN_THREADS, device=dev, plan_dtype=torch.float32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chol_inverse": kkt_inverse.launches,
                "line_polytope": line_polytope_projection.launches}
    sound = [corridor_ok(carry, obs, i) for i in range(PLAN_SCENES)]
    draws = kept_draws(obs)
    _, t_q0, t_obs = threaded
    t_draws = plan_row["kept_draws"]
    same = {d: all(np.array_equal(getattr(obs, f)[i], getattr(t_obs, f)[t_draws.index(d)])
                   for f in obs._fields)
            for i, d in enumerate(draws) if d in t_draws}
    row = {"phase": "sync_fleet", "scenes": PLAN_SCENES, "workers": PLAN_THREADS,
           "wall_s": wall, "plans_per_s": PLAN_SCENES / wall,
           "threaded_plans_per_s": plan_row["plans_per_s"],
           "kept_draws": draws, "threaded_kept_draws": t_draws,
           "broker": brk.stats, "launches": launches, "corridors_sound": sum(sound),
           "segments": [int(n) + 1 for n in carry.path.num_sectors]}
    emit(row)
    assert launches["chol_inverse"] > 0 and launches["line_polytope"] > 0, launches
    assert all(sound), f"corridor invariants fail for scenes {[i for i, ok in enumerate(sound) if not ok]}"
    assert None not in draws, f"a scene is no draw of the draw scheme: {draws}"
    assert np.array_equal(q0, t_q0), "q0 differs from the threaded build's"
    assert same and all(same.values()), f"obstacle arrays differ from the threaded build's: {same}"
    return row


def phase_compare_builders(cfg, dev):
    """The threaded (`build_fleet_threaded`, linger 30 ms) and the
    phase-synchronous (`build_fleet_sync`) builders in turns (threaded,
    sync, sync, threaded) on fleets of `phase_plan_fleet`'s settings, f32,
    at each (scenes, workers) of COMPARE_FLEETS."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.parallel.fleet import build_fleet_sync, build_fleet_threaded

    common = dict(seed=PLAN_SEED, n_obstacles=PLAN_OBSTACLES, dtype=np.float32, device=dev,
                  plan_dtype=torch.float32)
    rows = []
    for scenes, workers in COMPARE_FLEETS:
        builders = {
            "threaded": lambda: build_fleet_threaded(scenes, cfg, n_threads=workers,
                                                     linger=0.030, **common),
            "sync": lambda: build_fleet_sync(scenes, cfg, n_workers=workers, **common),
        }
        for turn, name in enumerate(("threaded", "sync", "sync", "threaded")):
            (carry, _, obs, brk), wall, launches = counted(builders[name])
            sound = [corridor_ok(carry, obs, i) for i in range(scenes)]
            batches = brk.batches_run
            row = {"phase": "compare_builders", "turn": turn, "builder": name,
                   "scenes": scenes, "workers": workers, "wall_s": wall,
                   "plans_per_s": scenes / wall, "kept_draws": kept_draws(obs),
                   "calls_served": brk.calls_served, "batches_run": batches,
                   "mean_width": brk.calls_served / batches if batches else 0.0,
                   "launches": launches, "corridors_sound": sum(sound)}
            emit(row)
            assert all(sound), f"{name}: corridor invariants fail"
            rows.append(row)
    return rows


def recording_publisher():
    """A headless `ros_compat.RosPublisher` that keeps each tick's record
    and payload."""
    from boundplanner_tpu_torch.ros_compat import RosPublisher

    class Recording(RosPublisher):
        def __init__(self):
            super().__init__()
            self.ticks = []

        def publish_tick(self, record):
            msg = super().publish_tick(record)
            self.ticks.append((record, msg))
            return msg

    return Recording()


def typed_payload(record):
    """`ros_compat.to_mpc_data_msg` into attribute-bag message classes,
    returned as the payload dict of the fields it set."""
    from boundplanner_tpu_torch.ros_compat import to_mpc_data_msg

    class Vector:
        def __init__(self, x=()):
            self.x = list(x)

    class MPCData:
        def __init__(self):
            object.__setattr__(self, "fields", {})

        def __setattr__(self, key, value):
            self.fields[key] = value

    msg = to_mpc_data_msg({"MPCData": MPCData, "Vector": Vector}, record)
    unwrap = lambda v: (v.x if isinstance(v, Vector) else
                        [e.x for e in v] if isinstance(v, list) and v and isinstance(v[0], Vector)
                        else v)
    return {k: unwrap(v) for k, v in msg.fields.items()}


def counted(fn):
    """fn() with the kernels' counts set to 0 just before it; returns
    (result, seconds, {kernel: launches})."""
    import torch
    from boundplanner_tpu_torch.ops.cuda_proj import line_polytope_projection
    from boundplanner_tpu_torch.ops.linalg import kkt_inverse

    kkt_inverse.launches = 0
    line_polytope_projection.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {"chol_inverse": kkt_inverse.launches,
                                           "line_polytope": line_polytope_projection.launches}


def phase_examples(dev):
    """The port's examples on the card, in this process: ``rviz_bringup``
    (EXAMPLE_TICKS ticks; its JSON and typed telemetry validate against the
    port's IDL), ``boundplanner_with_mpc_example`` (EXAMPLE_TICKS ticks: a
    finite EE trajectory outside every box of the scene) and
    ``fleet_example`` (one scene, FLEET_EXAMPLE_TICKS ticks), each with its
    kernel launches."""
    import numpy as np
    from boundplanner_tpu_torch import idl
    from boundplanner_tpu_torch.examples import (boundplanner_with_mpc_example,
                                                 fleet_example, rviz_bringup)
    from boundplanner_tpu_torch.examples.scene import example_obstacles

    schema = idl.load_msg("MPCData")
    pub = recording_publisher()
    ticks, rviz_s, rviz_launches = counted(
        lambda: rviz_bringup.main(max_ticks=EXAMPLE_TICKS, device=dev, pub=pub))
    assert ticks == EXAMPLE_TICKS, f"rviz_bringup published {ticks} ticks"
    for record, msg in pub.ticks:
        assert set(msg) <= set(schema), set(msg) - set(schema)
        # the JSON transport flattens phi, dphi and fails to scalars
        idl.validate(schema, {k: v for k, v in msg.items() if k not in ("phi", "dphi", "fails")})
        idl.validate(schema, typed_payload(record))
        assert np.isfinite(msg["q"]).all()

    (traj, p_via), mpc_s, mpc_launches = counted(
        lambda: boundplanner_with_mpc_example.main(max_ticks=EXAMPLE_TICKS, device=dev))
    assert traj.shape == (EXAMPLE_TICKS, 3) and np.isfinite(traj).all(), traj
    for ob in example_obstacles():
        inside = np.all((traj > np.asarray(ob[:3]) + 1e-5) & (traj < np.asarray(ob[3:]) - 1e-5),
                        axis=1)
        assert not inside.any(), f"EE inside the box {ob}"

    fleet, fleet_s, fleet_launches = counted(
        lambda: fleet_example.main(batch=1, ticks=FLEET_EXAMPLE_TICKS, device=dev))
    assert np.isfinite(fleet["success_rate"]) and np.isfinite(fleet["mean_phi_final"]), fleet

    by_example = {"rviz_bringup": rviz_launches,
                  "boundplanner_with_mpc_example": mpc_launches,
                  "fleet_example": fleet_launches}
    total = {k: sum(v[k] for v in by_example.values()) for k in ("chol_inverse", "line_polytope")}
    row = {"phase": "examples", "rviz_ticks": ticks, "rviz_s": rviz_s,
           "planner_mpc_ticks": int(traj.shape[0]), "planner_mpc_s": mpc_s,
           "planner_mpc_vias": len(p_via), "fleet": fleet, "fleet_s": fleet_s,
           "launches": total, "launches_by_example": by_example}
    emit(row)
    assert total["chol_inverse"] > 0 and total["line_polytope"] > 0, total
    return row


# the JAX package's quality gates on the card (`boundplanner_tpu_torch.gates`,
# PERF.md §4): gate 4, 128 scenes x 50 ticks (`bench.py 128 50`) with the
# worst scenes' chronologies; gate 2, scene 43 alone for 30 ticks; the
# escalation probe on scenes 29, 43, 54 (cut from 50 ticks to 20 for time);
# gate 1 on the runtime_f32 row; the planner's "spath" route
GATE_LONG_TICKS, GATE_TOP = 50, 3
GATE_SCENE, GATE_SCENE_TICKS = 43, 30
GATE_PROBE_SCENES, GATE_PROBE_TICKS = (29, 43, 54), 20


class shapes_seen:
    """Records the leading shapes of the matrices that the tick hands to
    kernel A (at ``ops.qp.kkt_inverse``) and of the problems it hands to
    kernel B (at ``planner.set_finder.seg_poly_closest``, for a CUDA f32
    batch, which kernel B runs) while ``run(fn)`` runs ``fn``; the calls
    still go to the counting wrappers."""

    def run(self, fn):
        import torch
        from boundplanner_tpu_torch.ops import qp
        from boundplanner_tpu_torch.planner import set_finder

        self.a, self.b = set(), set()
        real_a, real_b = qp.kkt_inverse, set_finder.seg_poly_closest

        def rec_a(k):
            self.a.add(tuple(k.shape))
            return real_a(k)

        def rec_b(a, *args):
            if a.is_cuda and a.dtype == torch.float32:
                self.b.add(a.shape[0])
            return real_b(a, *args)

        qp.kkt_inverse, set_finder.seg_poly_closest = rec_a, rec_b
        try:
            return fn()
        finally:
            qp.kkt_inverse, set_finder.seg_poly_closest = real_a, real_b


def phase_gates_long(payload, cfg, dev, main_recs, out_dir):
    """Gate 4: the cached fleet for GATE_LONG_TICKS ticks in f32 (chunk
    128) through ``chunked_rollout``, then through ``gates.rollout_diag``:
    600 / 50 launches each, success >= 0.90, the first N_TICKS ticks equal
    by value to the main path's records (``main_recs``), the diagnostic
    loop's phi / success / viol equal to the rollout's. Reports the
    chronologies of the GATE_TOP worst scenes and scene 43's last tick;
    saves the records (``--out``)."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch import gates

    (summary, recs, diag), _, launches = counted(
        lambda: gates.long_horizon(payload, GATE_LONG_TICKS, GATE_TOP, CHUNK, dev,
                                   torch.float32, watch=(GATE_SCENE,)))
    want = solver_launches(cfg, GATE_LONG_TICKS * (len(payload["q0"]) // CHUNK), 0)
    same20 = None
    if main_recs is not None:
        same20 = {k: bool(np.array_equal(recs[k][:, :N_TICKS], main_recs[k]))
                  for k in ("phi", "success", "viol")}
    for chron in summary["worst"]:
        emit({"phase": "gates_long_chronology", **chron})
    row = {"phase": "gates_long", **{k: v for k, v in summary.items() if k != "worst"},
           "worst_scenes": [c["scene"] for c in summary["worst"]],
           "first_ticks_equal_main": same20, "launches": launches, "want": want}
    emit(row)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, "gates_long.npz"),
                 **{f"rollout.{k}": v for k, v in recs.items()},
                 **{f"diag.{k}": v for k, v in diag.items()})
    assert summary["launches_rollout"] == want, (summary["launches_rollout"], want)
    assert summary["launches_diag"] == want, (summary["launches_diag"], want)
    assert launches == {k: 2 * n for k, n in want.items()}, launches
    assert all(summary["diag_equal"].values()), summary["diag_equal"]
    assert same20 is None or all(same20.values()), f"first {N_TICKS} ticks differ: {same20}"
    assert summary["success_rate"] >= 0.90, f"success_rate {summary['success_rate']} < 0.90"
    return row


def phase_gates_scene43(payload, cfg, dev):
    """Gate 2: scene 43 alone (batch 1) for GATE_SCENE_TICKS ticks in f32:
    12 / 1 launches a tick, kernel B at P = 96, and the JAX gate's bar
    "tracks" (phi never decreases, viol < 0.01, no 3 failed ticks in a
    row)."""
    import torch
    from boundplanner_tpu_torch import gates

    seen = shapes_seen()
    res, secs, launches = counted(lambda: seen.run(
        lambda: gates.scene_replay(payload, GATE_SCENE, GATE_SCENE_TICKS, dev,
                                   torch.float32)))
    want = solver_launches(cfg, GATE_SCENE_TICKS, 0)
    row = {"phase": "gates_scene43", **res, "wall_s": secs, "launches": launches, "want": want,
           "kernel_a_shapes": sorted(seen.a), "kernel_b_problems": sorted(seen.b)}
    emit(row)
    assert launches == want, (launches, want)
    assert seen.a == {(1, 136, 136)} and seen.b == {96}, (seen.a, seen.b)
    assert res["tracks"], (f"scene {GATE_SCENE} does not track: monotone "
                           f"{res['phi_monotone']}, viol < 1 cm {res['viol_under_1cm']}, "
                           f"longest fail run {res['longest_fail_run']}")
    return row


def phase_gates_probe(payload, cfg, dev):
    """The escalation probe: scenes 29, 43, 54 together for
    GATE_PROBE_TICKS ticks in f32, without escalation (240 / 20 launches)
    and with 4 lanes at 6 x 8 (240 + 48 a fired tick / 20 + 1 a fired
    tick; the retry is min(4, 3) = 3 lanes wide: kernel A at (3, 136,
    136), kernel B at P = 288). Per-scene rows are reported."""
    import dataclasses
    import torch
    from boundplanner_tpu_torch import gates

    seen = shapes_seen()
    rows, secs, launches = counted(lambda: seen.run(
        lambda: gates.probe_escalation(payload, GATE_PROBE_SCENES, GATE_PROBE_TICKS,
                                       device=dev, dtype=torch.float32)))
    for arm in rows:
        arm_cfg = dataclasses.replace(cfg, esc_lanes=arm["esc_lanes"],
                                      esc_sqp_iters=arm["esc"][0], esc_qp_iters=arm["esc"][1])
        arm["want"] = solver_launches(arm_cfg, GATE_PROBE_TICKS, arm["escalated_ticks"])
    row = {"phase": "gates_probe", "scenes": list(GATE_PROBE_SCENES),
           "ticks": GATE_PROBE_TICKS, "arms": rows, "wall_s": secs, "launches": launches,
           "kernel_a_shapes": sorted(seen.a), "kernel_b_problems": sorted(seen.b)}
    emit(row)
    for arm in rows:
        assert arm["launches"] == arm["want"], (arm["arm"], arm["launches"], arm["want"])
    assert rows[0]["escalated_ticks"] == 0, rows[0]
    assert launches == {k: sum(a["launches"][k] for a in rows) for k in launches}, launches
    assert seen.a == {(3, 136, 136)} and seen.b == {288}, (seen.a, seen.b)
    return row


def phase_gates_obstacle(rt32):
    """Gate 1 on the runtime_f32 row (no new run): the path end within 45
    ticks, the final EE error <= 2 mm, the EE outside every original box
    on every tick (asserted), and no fallback (reported: in f32 a tick
    near the 1e-4 violation bar falls either side of it with the rounding;
    the JAX package's own gate falls back once on the CPU, at 1.23e-4,
    PERF.md §6). A row that stopped short of the path end (its tick or
    second cap) fails, named as such."""
    from boundplanner_tpu_torch import gates

    passed, bars = gates.obstacle_gate(rt32)
    row = {"phase": "gates_obstacle", "passed": passed, "bars": bars,
           **{k: rt32[k] for k in ("ticks", "stopped_by", "path_end_reached", "fails",
                                   "failed_tick_viols", "goal_err_m", "min_box_margin_m")}}
    emit(row)
    assert rt32["stopped_by"] == "path_end", \
        f"runtime_f32 stopped by its {rt32['stopped_by']} cap before the path end: no gate"
    missed = [name for name, ok in bars.items() if not ok and name != "no_fallbacks"]
    assert not missed, f"obstacle gate missed: {bars}"
    return row


def phase_spath_plan(dev, plan):
    """The planner's "spath" route: the e2e scene planned once in f64 on
    the card through a `BatchBroker` with ``device_search=True``: the key
    served, the host route's (``plan``) via count and vias within 1e-5,
    each plan's roadmap-search time."""
    import numpy as np
    import torch
    from boundplanner_tpu_torch.mpc.e2e import plan_e2e
    from boundplanner_tpu_torch.parallel.broker import BatchBroker, register_planner_kernels

    brk = BatchBroker(linger=0.0, device=dev, dtype=torch.float64)
    register_planner_kernels(brk, device_search=True)
    routed = plan_e2e(dev, broker=brk)
    vias, host_vias = np.asarray(routed[1][0]), np.asarray(plan[1][0])
    same_count = vias.shape == host_vias.shape
    err = float(np.abs(vias - host_vias).max()) if same_count else None
    row = {"phase": "device_search_plan", "spath_calls": brk.calls_by_key.get("spath", 0),
           "vias": len(vias), "host_vias": len(host_vias), "via_max_abs_err": err,
           "seconds": routed[4]["seconds"], "comp_time_path_s": routed[4]["comp_time_path"],
           "host_seconds": plan[4]["seconds"],
           "host_comp_time_path_s": plan[4]["comp_time_path"]}
    emit(row)
    assert row["spath_calls"] > 0, brk.calls_by_key
    assert same_count and err <= 1e-5, row
    return row


def main_path_records(payload, cfg, dev):
    """The main path's N_TICKS-tick records (``--only-gates``: gate 4's
    first ticks are held to them), as numpy."""
    import torch
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel.batch import chunked_rollout
    from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch

    carry, q0, obs = to_torch((payload["carry"], payload["q0"], payload["obs"]),
                              dev, torch.float32)
    model = FleetMPC(cfg, device=dev, dtype=torch.float32)
    return to_numpy(chunked_rollout(carry, q0, obs, model, N_TICKS, chunk=CHUNK)[1])


def phase_kernel_a_probe(dev):
    """Kernel A at (3, 136, 136) f32: the escalation probe's tick and
    retry (3 scenes; the retry min(4, 3) lanes wide), with the bars of
    `phase_kernel_a` (its own seed)."""
    import numpy as np
    import torch

    n = len(GATE_PROBE_SCENES)
    k = spd_batch(np.random.default_rng(1000 + n), n, dtype="float32")
    return kernel_a_row("kernel_a_probe", torch.from_numpy(k).to(dev), 200)


def gate_launches(rows, kernel):
    """A kernel's launches in each gate run (the kernels' summary line)."""
    return {"launches_gates_long": rows["long"]["launches"][kernel],
            "launches_gates_scene43": rows["scene43"]["launches"][kernel],
            "launches_gates_probe": {a["arm"]: a["launches"][kernel]
                                     for a in rows["probe"]["arms"]}}


def run_gates(payload, cfg, dev, main_recs, rt32, plan, out_dir):
    """The gates phase (also alone: ``--only-gates``)."""
    long_row = phase_gates_long(payload, cfg, dev, main_recs, out_dir)
    scene = phase_gates_scene43(payload, cfg, dev)
    probe = phase_gates_probe(payload, cfg, dev)
    spath = phase_spath_plan(dev, plan)
    obstacle = phase_gates_obstacle(rt32)
    return {"long": long_row, "scene43": scene, "probe": probe, "obstacle": obstacle,
            "spath_plan": spath}


def main(argv):
    t_start = time.perf_counter()
    out_dir = compare_b = None
    if "--out" in argv:
        out_dir = argv[argv.index("--out") + 1]
    if "--compare-kernel-b" in argv:
        compare_b = os.path.abspath(argv[argv.index("--compare-kernel-b") + 1])
    compare_builders = "--compare-builders" in argv
    only_runtime = "--only-runtime" in argv
    only_solver_configs = "--only-solver-configs" in argv
    only_gates = "--only-gates" in argv
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "boundplanner_tpu_torch")):
        print("chip_smoke: boundplanner_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card", file=sys.stderr)
        return 2
    os.chdir(root)
    sys.path.insert(0, root)

    import numpy as np
    from boundplanner_tpu_torch.config import perf_mpc_params
    from boundplanner_tpu_torch.ops import _build
    from boundplanner_tpu_torch.parallel.fleet_cache import load

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    path, build_s = _build.build()
    _build.library()
    emit({"phase": "build", "seconds": build_s, "library": os.path.relpath(path, root)})

    if only_runtime:
        run_runtime(dev)
        return 0
    if only_gates:
        from boundplanner_tpu_torch.mpc.e2e import plan_e2e

        cfg = perf_mpc_params()
        payload = load(FLEET)
        phase_kernel_a_probe(dev)
        phase_kernel_b(np.random.default_rng(0), dev, real_tick_batch(payload, cfg, dev))
        # the main path's 20 ticks (uncounted), for gate 4's first ticks
        main_recs = main_path_records(payload, cfg, dev)
        plan = plan_e2e(dev)
        emit({"phase": "runtime_plan", **plan[4], "vias": len(plan[1][0])})
        rt32, _ = phase_runtime_f32(dev, plan)
        res = run_gates(payload, cfg, dev, main_recs, rt32, plan, out_dir)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "gates.json"), "w") as f:
                json.dump({"card": card, "runtime_f32": rt32, **res}, f, indent=1)
        return 0
    cfg = perf_mpc_params()
    if compare_builders:
        rows = phase_compare_builders(cfg, dev)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "compare_builders.json"), "w") as f:
                json.dump({"card": card, "rows": rows}, f, indent=1)
        return 0
    payload = load(FLEET)
    real = real_tick_batch(payload, cfg, dev)
    if compare_b:
        result = phase_compare_kernel_b(np.random.default_rng(0), dev, real, compare_b, out_dir)
        return 0 if all(result["equal_by_value"].values()) else 1

    rng = np.random.default_rng(0)
    if only_solver_configs:
        phase_kernel_a_retry(dev)
        phase_kernel_b(rng, dev, real)
        solver = phase_solver_configs(payload, dev, None)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "solver_configs.json"), "w") as f:
                json.dump({"card": card, "solver_configs": solver}, f, indent=1)
        return 0
    a = phase_kernel_a(rng, dev)
    a_shard = phase_kernel_a_shard(dev)
    a_retry = phase_kernel_a_retry(dev)
    b_all = phase_kernel_b(rng, dev, real)
    b = b_all[0]
    phase_small_f64(payload, cfg, dev)
    main_res, main_recs = phase_main(payload, cfg, dev)
    phase_worst_tick(payload, cfg, dev, out_dir)
    routes = phase_main_routes(payload, cfg, dev)
    solver = phase_solver_configs(payload, dev, main_res)
    a_plan = phase_kernel_a_planner(rng, dev)
    phase_planner_f64(cfg, dev)
    spath = phase_device_search(dev)
    threaded, plan = phase_plan_fleet(cfg, dev, payload)
    fleet, mp_row = phase_fleet_mp(cfg, dev)
    rollout = phase_planned_rollout(fleet, cfg, dev)
    multi = phase_multi_gpu(payload, cfg, dev)
    rt64, rt32, parts, e2e_plan = run_runtime(dev)
    a_probe = phase_kernel_a_probe(dev)
    gate_rows = run_gates(payload, cfg, dev, main_recs, rt32, e2e_plan, out_dir)
    edges = phase_edges(dev, card, main_res, rt64, rt32)
    sync = phase_sync_fleet(cfg, dev, plan, threaded)
    examples = phase_examples(dev)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "roofline_share",
            "library_ms")
    summary = lambda row: {k: row[k] for k in keys}
    kernels = {"kernels": [
        {"name": "chol_inverse", "route": "cuda",
         "source": "boundplanner_tpu_torch/csrc/chol_inverse.cu",
         "replaces": "boundplanner_tpu/ops/pallas_chol.py:386",
         "launches": main_res["launches"]["chol_inverse"],
         "launches_plan_fleet": plan["launches"]["chol_inverse"],
         "launches_fleet_mp": mp_row["launches"]["chol_inverse"],
         "launches_multi_gpu_per_rank": [r["chol_inverse"] for r in multi["launches_per_rank"]],
         "launches_runtime_f64": rt64["launches"]["chol_inverse"],
         "launches_runtime_f32": rt32["launches"]["chol_inverse"],
         "launches_sync_fleet": sync["launches"]["chol_inverse"],
         "launches_examples": examples["launches"]["chol_inverse"],
         "launches_examples_by_example": {name: n["chol_inverse"] for name, n
                                          in examples["launches_by_example"].items()},
         "launches_solver_configs": {name: r["launches"]["chol_inverse"]
                                     for name, r in solver.items()},
         **gate_launches(gate_rows, "chol_inverse"),
         **summary(a[0]), "launch_only_ms": a[0]["launch_only_ms"],
         "library": a[0]["library"],
         "shapes": [{"shape": r["shape"], "dtype": r["dtype"], **summary(r),
                     "launch_only_ms": r["launch_only_ms"]}
                    for r in a + [a_shard, a_retry, a_probe] + a_plan + [rt64["kernel_a"],
                                                       rt64["kernel_a_projection"]]]},
        {"name": "line_polytope", "route": "cuda",
         "source": "boundplanner_tpu_torch/csrc/line_polytope.cu",
         "replaces": "boundplanner_tpu/ops/pallas_proj.py:95",
         "launches": main_res["launches"]["line_polytope"],
         "launches_plan_fleet": plan["launches"]["line_polytope"],
         "launches_fleet_mp": mp_row["launches"]["line_polytope"],
         "launches_multi_gpu_per_rank": [r["line_polytope"] for r in multi["launches_per_rank"]],
         "launches_runtime_f64": rt64["launches"]["line_polytope"],
         "launches_runtime_f32": rt32["launches"]["line_polytope"],
         "launches_sync_fleet": sync["launches"]["line_polytope"],
         "launches_examples": examples["launches"]["line_polytope"],
         "launches_examples_by_example": {name: n["line_polytope"] for name, n
                                          in examples["launches_by_example"].items()},
         "launches_solver_configs": {name: r["launches"]["line_polytope"]
                                     for name, r in solver.items()},
         **gate_launches(gate_rows, "line_polytope"),
         **summary(b), "launch_only_ms": b["launch_only_ms"],
         "bound_ms_all_rows": b["bound_ms_all_rows"],
         "library": None,
         "shapes": [{"fold": r["fold"], "problems": r["problems"], **summary(r),
                     "launch_only_ms": r["launch_only_ms"],
                     "bound_ms_all_rows": r["bound_ms_all_rows"]} for r in b_all]},
    ]}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump({"card": card, "main": main_res, "main_routes": routes,
                       "solver_configs": solver, "plan_fleet": plan,
                       "device_search": spath, "fleet_mp": mp_row, "planned_rollout": rollout,
                       "multi_gpu": multi, "runtime_f64": rt64, "runtime_f32": rt32,
                       "runtime_parts": parts, "edges": edges, "sync_fleet": sync,
                       "examples": examples, "gates": gate_rows, **kernels}, f, indent=1)
        with open(path + ".log") as src, open(os.path.join(out_dir, "nvcc.log"), "w") as dst:
            dst.write(src.read())
    emit({"phase": "script", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
