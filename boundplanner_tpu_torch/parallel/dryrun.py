"""The multi-device dry run of the port (after ``dryrun_multichip`` of the
repository's ``__graft_entry__.py``), and the worker that the launcher of
`parallel.distributed` starts for it.

The cached 128-scene fleet's shardable prefix rolls out closed loop for
10 ticks with ``perf_mpc_params()``, fed through
`distributed.global_from_local`: over the ranks of a process group when
one is initialized (each rank its contiguous block, on its own device),
else over the devices of `mesh.make_mesh` in this process. Besides the
fleet diagnostics it measures the executed trajectory's safety: the depth
of the plant's EE point (what ran, not the attempted solve) inside any
obstacle box. Scenes that start clean must never enter a box deeper than
ENTER_BAR; scenes that start inside one (the cached fleet has a few, its
planner having grown the first set from a seed inside a box) must not end
deeper than they started, by more than DIGIN_BAR. On the cached fleet
the bars are asserted: success >= SUCCESS_BAR (the JAX package's bar off
the TPU), entering <= 0.06 m, digging in <= 5e-3 m.

Worker (one per rank, under the launcher)::

    python -m boundplanner_tpu_torch.parallel.distributed --nproc 2 -- \\
        python -m boundplanner_tpu_torch.parallel.dryrun [--device cuda] [--ticks 10]
        [--demo B] [--dtype float32] [--backend gloo]

Each rank prints one line ``DRYRUN_RESULT {json}``: its block, the global
diagnostics, its scenes' phi per tick and final q, its kernel launches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import perf_mpc_params
from ..utils.device import checked_device
from ..utils.tree import to_numpy, tree_map
from . import distributed as dist
from .fleet_cache import cache_path, load
from .mesh import make_mesh, sharded_rollout

SUCCESS_BAR = 0.90
ENTER_BAR = 0.06
DIGIN_BAR = 5e-3
CLEAN_START = 1e-3    # a scene whose EE starts at most this deep starts clean
FLEET_BATCH, FLEET_SEED = 128, 7


def executed_penetration(p, obs) -> tuple:
    """(enter, dig-in) of the executed EE trajectory: ``p`` (B, T, >=3) the
    plant's EE poses, ``obs`` the scenes' obstacle arrays (numpy). A point
    is inside an H-rep box iff every row is negative, so its depth is
    -max_row(a p - b). ``enter``: the deepest point reached by any scene
    that started clean; ``dig-in``: the largest final-minus-start depth of
    the scenes that started inside a box (-inf where no scene counts)."""
    p3 = np.asarray(p, np.float64)[..., :3]
    rows = (np.einsum("bmri,bti->btmr", np.asarray(obs.a, np.float64), p3)
            - np.asarray(obs.b, np.float64)[:, None])
    pen = np.where(np.asarray(obs.mask)[:, None, :], -rows.max(-1), -np.inf)
    d = pen.max(-1)                                          # (B, T)
    clean0 = d[:, 0] <= CLEAN_START
    enter = np.where(clean0, d.max(1), -np.inf).max(initial=-np.inf)
    digin = np.where(~clean0, d[:, -1] - d[:, 0], -np.inf).max(initial=-np.inf)
    return float(enter), float(digin)


def fleet_for(n_shards: int, cfg, demo_batch: int | None = None):
    """(carry, q0, obs) as numpy, its batch, the workload's name: the cached
    fleet's prefix that divides over ``n_shards``, or a deterministic demo
    fleet of ``demo_batch`` scenes."""
    if demo_batch is not None:
        from ..demo import demo_fleet

        carry, obs, q0 = demo_fleet(cfg, demo_batch, dtype=np.float64)
        return (carry, q0, obs), demo_batch, f"demo_fleet_{demo_batch}"
    payload = load(cache_path(FLEET_BATCH, FLEET_SEED, cfg.nr_segs))
    batch = (FLEET_BATCH // n_shards) * n_shards
    take = lambda x: np.asarray(x)[:batch]  # noqa: E731
    fleet = tuple(tree_map(take, payload[k]) for k in ("carry", "q0", "obs"))
    return fleet, batch, f"planner_fleet_b{FLEET_BATCH}_s{FLEET_SEED}[:{batch}]"


def dryrun_multichip(n_devices: int | None = None, n_ticks: int = 10, device=None,
                     dtype=torch.float32, demo_batch: int | None = None) -> dict:
    """Roll the fleet out over every rank of the process group, or over
    ``n_devices`` devices of this process (``device`` given: that device,
    ``n_devices`` times; else the first ``n_devices`` cards), and check it.
    Returns this process's part: its block (``lo``, ``batch``), the global
    ``diag`` (success_rate, max_viol, mean_phi_final, pen_enter,
    pen_digin), and its scenes' ``phi`` (B, T) and final ``q`` (B, 7)."""
    cfg = perf_mpc_params()
    if dist.is_initialized():
        mesh = None
        n_shards = dist.process_count()
        device = dist.local_device() if device is None else checked_device(device)
    else:
        mesh = (make_mesh(n_devices) if device is None
                else [checked_device(device)] * (n_devices or 1))
        n_shards = len(mesh)
    (carry, q0, obs), batch, workload = fleet_for(n_shards, cfg, demo_batch)
    if mesh is None:
        sl = dist.local_batch_slice(batch)
        take = lambda x: np.asarray(x)[sl]  # noqa: E731
        obs = tree_map(take, obs)
        _, recs, diag = dist.distributed_rollout(tree_map(take, carry), q0[sl], obs, cfg,
                                                 n_ticks, device=device, dtype=dtype)
        lo = sl.start
    else:
        fed = dist.global_from_local((carry, q0, obs), mesh[0], dtype)
        _, recs, diag = sharded_rollout(*fed, cfg, n_ticks, mesh)
        recs, lo = to_numpy(recs), 0
    enter, digin = dist.all_reduce(list(executed_penetration(recs["p"], obs)),
                                   torch.distributed.ReduceOp.MAX)
    diag = {**diag, "pen_enter": enter, "pen_digin": digin}
    phi = np.asarray(recs["phi"])
    if phi.shape != (len(phi), n_ticks) or not np.isfinite(phi).all():
        raise AssertionError(f"bad phi records: shape {phi.shape}")
    if not diag["mean_phi_final"] > 0.0:
        raise AssertionError("the closed loop made no path progress")
    if demo_batch is None:
        bars = {"success_rate": diag["success_rate"] >= SUCCESS_BAR,
                "pen_enter": diag["pen_enter"] <= ENTER_BAR,
                "pen_digin": diag["pen_digin"] <= DIGIN_BAR}
        if not all(bars.values()):
            raise AssertionError(f"dry-run bars missed: {bars}, {diag}")
    return {"workload": workload, "batch": batch, "ranks": dist.process_count(),
            "shards": n_shards, "lo": lo, "diag": diag, "phi": phi,
            "q": np.asarray(recs["q"])[:, -1]}


def main(argv=None):
    from ..ops.cuda_proj import line_polytope_projection
    from ..ops.linalg import kkt_inverse

    ap = argparse.ArgumentParser(description="One rank of the multi-device dry run.")
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: cuda device rank %% device_count)")
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--demo", type=int, default=None,
                    help="a demo fleet of this many scenes instead of the cached one")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--backend", default="gloo", choices=dist.BACKENDS)
    args = ap.parse_args(argv)
    dist.initialize(backend=args.backend)
    try:
        kkt_inverse.launches = line_polytope_projection.launches = 0
        res = dryrun_multichip(n_ticks=args.ticks, device=args.device,
                               dtype=getattr(torch, args.dtype), demo_batch=args.demo)
        res.update(rank=dist.process_index(), phi=res["phi"].tolist(), q=res["q"].tolist(),
                   launches={"chol_inverse": kkt_inverse.launches,
                             "line_polytope": line_polytope_projection.launches})
        print("DRYRUN_RESULT " + json.dumps(res), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
