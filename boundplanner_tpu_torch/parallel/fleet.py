"""Randomized-scene fleets: plan on the host over device kernels, stack,
roll out batched (port of ``boundplanner_tpu/parallel/fleet.py``:
``random_scene``, ``plan_scene`` and the builders ``build_fleet``,
``build_fleet_threaded``, ``build_fleet_sync`` and ``build_fleet_mp``).

Scenes differ in goal and obstacle layout. Each scene's planning (the
irregular graph search) runs on the host, its numeric leaves as torch on
the planner's device and dtype; the resulting carries and obstacle arrays
(numpy leaves) stack into the batched trees that
`parallel.batch.chunked_rollout` consumes after `utils.tree.to_torch`.

The draw scheme is the JAX package's: draw ``d`` samples its scene from
``np.random.default_rng(seed + 1000 * d)`` and plans with planner seed
``seed + d``, so port-built and JAX-built fleets match scene by scene.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as SciRotation

from ..config import MPCParams
from ..mpc.bound_mpc import init_carry
from ..path.reference_path import build_path
from ..planner.planner import BoundPlanner
from ..planner.roadmap import PlanningError
from ..planner.set_finder import build_obstacle_arrays
from ..robot import kinematics as kin
from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.tree import to_numpy, tree_stack

DEFAULT_ER_BOUND = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
# the demo start configuration (`boundplanner_tpu/demo.py`)
DEMO_Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])


def random_scene(rng: np.random.Generator, n_obstacles: int = 3):
    """A randomized tabletop scene: floor + boxes, random goal offset."""
    obstacles = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0]]  # floor
    for _ in range(n_obstacles):
        c = rng.uniform([0.3, -0.6, 0.05], [0.7, 0.1, 0.5])
        h = rng.uniform(0.03, 0.1, 3)
        obstacles.append(list(np.concatenate([c - h, c + h])))
    goal = rng.uniform([0.35, -0.55, 0.15], [0.6, -0.2, 0.6])
    return obstacles, goal


def plan_scene(q0, goal, obstacles, seed: int, cfg: MPCParams, dtype=np.float32,
               broker=None, device=DEFAULT_DEVICE, plan_dtype=torch.float32):
    """Plan one scene; returns (carry, obstacle arrays) with numpy leaves in
    ``dtype``, or None when the planner finds no path.

    ``plan_dtype`` is the precision of the planning (the JAX package plans
    in its global dtype: float32 without x64); ``dtype`` that of the carry
    and obstacle arrays it builds."""
    device = checked_device(device)
    chain = kin.Chain().to(device, plan_dtype)
    q = torch.as_tensor(np.asarray(q0, np.float64), dtype=plan_dtype, device=device)
    pose0 = to_numpy(kin.fk_pose(q, chain))
    p0 = pose0[:3]
    r0 = SciRotation.from_rotvec(pose0[3:]).as_matrix()
    r1 = SciRotation.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=[1.0, 0.38, 1.0],
        workspace_min=[-0.14, -1.0, 0.0],
        seed=seed,
        broker=broker,
        device=device,
        dtype=plan_dtype,
    )
    try:
        p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(
            p0.copy(), np.asarray(goal, float).copy(), r0, r1
        )
    except PlanningError:
        return None
    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    erb = [DEFAULT_ER_BOUND] * len(bp1_list)
    path = build_path(
        p_via, r_via, bp1_list, br1, erb, a_sets, b_sets,
        nr_segs=cfg.nr_segs, dtype=dtype,
    )
    carry = init_carry(path, pose0.astype(dtype), cfg, dtype)
    obs = build_obstacle_arrays(obstacles, dtype=dtype)
    return carry, obs


def _stack_fleet(planned, q0, batch, dtype):
    carry_b = tree_stack([p[0] for p in planned])
    obs_b = tree_stack([p[1] for p in planned])
    q0_b = np.broadcast_to(q0.astype(dtype), (batch, 7)).copy()
    return carry_b, q0_b, obs_b


def build_fleet(batch: int, cfg: MPCParams, q0=None, n_obstacles: int = 3,
                seed: int = 0, dtype=np.float32, device=DEFAULT_DEVICE,
                plan_dtype=torch.float32):
    """Plan ``batch`` randomized scenes one after another and stack them
    (carries, q0s, obstacle arrays). Failed plans are re-drawn."""
    device = checked_device(device)
    rng = np.random.default_rng(seed)
    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    planned = []
    draws = 0
    while len(planned) < batch and draws < batch * 4:
        draws += 1
        obstacles, goal = random_scene(rng, n_obstacles)
        out = plan_scene(q0, goal, obstacles, seed + draws, cfg, dtype,
                         device=device, plan_dtype=plan_dtype)
        if out is not None:
            planned.append(out)
    if len(planned) < batch:
        raise RuntimeError(f"only {len(planned)}/{batch} scenes planned")
    return _stack_fleet(planned, q0, batch, dtype)


def build_fleet_sync(batch: int, cfg: MPCParams, q0=None, n_obstacles: int = 3,
                     seed: int = 0, dtype=np.float32, n_workers: int | None = None,
                     max_batch: int = 256, device=DEFAULT_DEVICE,
                     plan_dtype=torch.float32):
    """Phase-synchronous batched fleet planning: ``n_workers`` threads plan
    draws whose kernel calls meet at a barrier (`sync_broker.PhaseSyncBroker`):
    the moment every worker waits on a kernel result, all pending calls of a
    key run as one batched call. The draw scheme is `build_fleet_threaded`'s
    (draw ``d``: rng seed ``seed + 1000 * d``, planner seed ``seed + d``);
    the first ``batch`` plans to succeed are kept, stacked in draw order.
    Every worker is registered before any starts. A worker's error stops the
    others and is re-raised. Returns (carry_b, q0_b, obs_b, broker);
    ``broker.stats`` gives the widths achieved."""
    from .broker import register_planner_kernels
    from .sync_broker import PhaseSyncBroker

    if n_workers is None:
        n_workers = min(batch, max_batch)
    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    brk = PhaseSyncBroker(max_batch=max_batch, device=device, dtype=plan_dtype)
    register_planner_kernels(brk, max_set_size=20)

    results = {}
    errors = []
    lock = threading.Lock()
    counter = {"draw": 0}

    def worker():
        try:
            while True:
                with lock:
                    if (errors or len(results) >= batch
                            or counter["draw"] >= batch * 4):
                        return
                    counter["draw"] += 1
                    draw = counter["draw"]
                rng_i = np.random.default_rng(seed + 1000 * draw)
                obstacles, goal = random_scene(rng_i, n_obstacles)
                out = plan_scene(q0, goal, obstacles, seed + draw, cfg, dtype,
                                 broker=brk, device=device, plan_dtype=plan_dtype)
                if out is not None:
                    with lock:
                        if len(results) < batch:
                            results[draw] = out
        except Exception as err:   # a device fault: stop every worker, re-raised below
            with lock:
                errors.append(err)
        finally:
            brk.worker_exit()

    # register every worker before any starts, so that no early worker sees
    # a momentarily complete barrier and flushes a narrow batch
    for _ in range(n_workers):
        brk.worker_enter()
    threads = [threading.Thread(target=worker) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)][:batch]
    return (*_stack_fleet(ordered, q0, batch, dtype), brk)


def _mp_worker_init(counter, n_cpus):
    """Pool initializer: one torch thread, and the worker pinned to one core
    so the processes' thread pools do not migrate and contend."""
    torch.set_num_threads(1)
    with counter.get_lock():
        idx = counter.value
        counter.value += 1
    if n_cpus > 0:
        try:
            os.sched_setaffinity(0, {idx % n_cpus})
        except (AttributeError, OSError):  # pragma: no cover - not Linux
            pass


def _mp_plan_block(args):
    """Plan one block of draws in a worker process (top level, for spawn
    pickling). Returns ([(draw, carry, obs)] of the successful draws, this
    block's kernel launches in the worker)."""
    from ..ops.cuda_proj import line_polytope_projection
    from ..ops.linalg import kkt_inverse

    draws, q0, n_obstacles, seed, cfg, dtype_name, device, plan_dtype = args
    dtype = np.dtype(dtype_name).type
    a0, b0 = kkt_inverse.launches, line_polytope_projection.launches
    out = []
    for draw in draws:
        rng_i = np.random.default_rng(seed + 1000 * draw)
        obstacles, goal = random_scene(rng_i, n_obstacles)
        planned = plan_scene(q0, goal, obstacles, seed + draw, cfg, dtype,
                             device=device, plan_dtype=plan_dtype)
        if planned is not None:
            out.append((draw, planned[0], planned[1]))
    return out, {"pid": os.getpid(),
                 "chol_inverse": kkt_inverse.launches - a0,
                 "line_polytope": line_polytope_projection.launches - b0}


# worker processes that share one card by default: the most measured on
# the H100 (chip_smoke.py's fleet_mp phase); each holds its own CUDA context
CARD_PROCS = 4
# what a worker's BLAS and OpenMP pools read at start: one thread each
_MP_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def build_fleet_mp(batch: int, cfg: MPCParams, q0=None, n_obstacles: int = 3,
                   seed: int = 0, dtype=np.float32, n_procs: int | None = None,
                   block: int = 32, pin: bool = True, device=DEFAULT_DEVICE,
                   plan_dtype=torch.float32, timeout: float | None = None):
    """Plan a large fleet on a pool of worker processes, each planning
    unbrokered on ``device`` in ``plan_dtype`` with one torch thread.

    Threads share one interpreter lock, so the scaling axis is processes.
    The draw scheme is `build_fleet_threaded`'s (draw ``d`` samples with
    ``seed + 1000 * d`` and plans with seed ``seed + d``), and the result
    does not depend on scheduling: draws 1..M are planned, M = batch +
    max(min(64, batch), batch // 8), in blocks of ``block`` draws, and the
    first ``batch`` successes in draw order are kept. The pool is a spawn
    context (never fork after CUDA has started); the parent builds the
    kernel library and the geometry library first, so the workers only
    load them. ``n_procs`` defaults to one per host core on the CPU and to
    ``CARD_PROCS`` on a card. ``timeout`` bounds the wait for each block's
    result.

    Returns (carry_b, q0_b, obs_b, info): ``info`` holds ``planned``,
    ``draws``, ``wall_s``, ``plans_per_s``, ``n_procs`` and the workers'
    kernel ``launches`` (totals and ``per_worker`` by process id)."""
    import multiprocessing as mp

    from .. import native_geom
    from ..ops import _build

    device = checked_device(device)
    if device.type == "cuda":
        _build.build()
    native_geom.available()
    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    if not n_procs:
        n_procs = max(1, os.cpu_count() or 2)
        if device.type == "cuda":
            n_procs = min(n_procs, CARD_PROCS)
    n_draws = batch + max(min(64, batch), batch // 8)
    tasks = [(list(range(lo + 1, min(lo + block, n_draws) + 1)), q0, n_obstacles, seed, cfg,
              np.dtype(dtype).name, str(device), plan_dtype)
             for lo in range(0, n_draws, block)]
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    counter = ctx.Value("i", 0)
    # spawned workers read the environment at start: set it for the pool's
    # start only, then restore it for everything else in this process
    saved = {k: os.environ.get(k) for k in _MP_ENV}
    os.environ.update(_MP_ENV)
    try:
        pool_cm = ctx.Pool(processes=n_procs, initializer=_mp_worker_init,
                           initargs=(counter, (os.cpu_count() or 1) if pin else 0))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results = {}
    per_worker = {}
    with pool_cm as pool:
        it = pool.imap_unordered(_mp_plan_block, tasks)
        for _ in tasks:
            blk, launches = it.next(timeout)
            for draw, carry, obs in blk:
                results[draw] = (carry, obs)
            seen = per_worker.setdefault(launches.pop("pid"), {"chol_inverse": 0,
                                                               "line_polytope": 0})
            for key, n in launches.items():
                seen[key] += n
    wall = time.perf_counter() - t0
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)[:batch]]
    info = {
        "planned": len(results),
        "draws": n_draws,
        "wall_s": wall,
        "plans_per_s": len(results) / wall,
        "n_procs": n_procs,
        "launches": {key: sum(w[key] for w in per_worker.values())
                     for key in ("chol_inverse", "line_polytope")}
                    | {"per_worker": per_worker},
    }
    return (*_stack_fleet(ordered, q0, batch, dtype), info)


def build_fleet_threaded(batch: int, cfg: MPCParams, q0=None, n_obstacles: int = 3,
                         seed: int = 0, dtype=np.float32, n_threads: int = 8,
                         linger: float = 0.030, device_search: bool = False,
                         device=DEFAULT_DEVICE, plan_dtype=torch.float32):
    """Like `build_fleet`, but plans scenes on a thread pool whose
    device-kernel calls coalesce through a `broker.BatchBroker` into shared
    batched executions. Scene ``draw`` = 1, 2, ... uses the rng seed
    ``seed + 1000 * draw``; the first ``batch`` plans to succeed (in
    completion order, so the kept draws depend on thread timing) are kept,
    stacked in draw order. ``device_search`` routes the planners' roadmap
    searches through the broker's "spath" key (`register_planner_kernels`).
    Returns (carry_b, q0_b, obs_b, broker): the broker's counters expose
    how much batching was achieved."""
    from .broker import BatchBroker, register_planner_kernels

    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    brk = BatchBroker(linger=linger, device=device, dtype=plan_dtype)
    register_planner_kernels(brk, max_set_size=20, device_search=device_search)

    results = {}
    errors = []
    lock = threading.Lock()
    counter = {"draw": 0}

    def worker():
        try:
            while True:
                with lock:
                    if (errors or len(results) >= batch
                            or counter["draw"] >= batch * 4):
                        return
                    counter["draw"] += 1
                    draw = counter["draw"]
                rng_i = np.random.default_rng(seed + 1000 * draw)
                obstacles, goal = random_scene(rng_i, n_obstacles)
                out = plan_scene(q0, goal, obstacles, seed + draw, cfg, dtype,
                                 broker=brk, device=device, plan_dtype=plan_dtype)
                if out is not None:
                    with lock:
                        if len(results) < batch:
                            results[draw] = out
        except Exception as err:   # a device fault: stop every worker, re-raised below
            with lock:
                errors.append(err)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)][:batch]
    return (*_stack_fleet(ordered, q0, batch, dtype), brk)
