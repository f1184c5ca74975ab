"""Randomized-scene fleet (counterpart of the JAX package's
``examples/fleet_example.py``): plan ``batch`` random scenes on the host
(`parallel.fleet.build_fleet`), then roll the whole fleet out closed-loop
on the device in chunks of ``chunk`` scenes (`parallel.batch.chunked_rollout`).

    python -m boundplanner_tpu_torch.examples.fleet_example [BATCH] [--device cpu] [--ticks N]
"""

import argparse
import time

import numpy as np
import torch

from ..config import MPCParams, perf_mpc_params
from ..mpc.bound_mpc import FleetMPC
from ..parallel.batch import chunked_rollout
from ..parallel.fleet import build_fleet
from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.tree import to_torch


def main(batch: int = 16, ticks: int = 10, chunk: int = 8, device=DEFAULT_DEVICE,
         params: MPCParams | None = None):
    """``params`` defaults to `perf_mpc_params()`; the fleet runs in
    float32. Returns the rollout's summary: success rate, mean final phi,
    solves/s."""
    device = checked_device(device)
    chunk = min(chunk, batch)
    cfg = params or perf_mpc_params()
    print(f"planning {batch} randomized scenes ...")
    t0 = time.time()
    fleet = build_fleet(batch, cfg, n_obstacles=2, seed=0, device=device)
    print(f"planned in {time.time() - t0:.1f}s")

    carry_b, q0_b, obs_b = to_torch(fleet, device, torch.float32)
    model = FleetMPC(cfg, device=device, dtype=torch.float32)
    t0 = time.time()
    _, recs = chunked_rollout(carry_b, q0_b, obs_b, model, ticks, chunk=chunk)
    phi_last = recs["phi"][:, -1].cpu().numpy()
    wall = time.time() - t0
    success = float(np.mean(recs["success"].cpu().numpy()))
    print(f"rolled {batch} scenes x {ticks} ticks in {wall:.2f}s "
          f"({batch * ticks / wall:.0f} solves/s)")
    print(f"success rate: {success:.2f}")
    print(f"mean phi progress: {phi_last.mean():.4f}")
    return {"success_rate": success, "mean_phi_final": float(phi_last.mean()),
            "solves_per_s": batch * ticks / wall}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", type=int, nargs="?", default=16)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.batch, ticks=args.ticks, chunk=args.chunk, device=args.device)
