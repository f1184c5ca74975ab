"""Build, cache and load planner-built fleets without jax
(port of ``cache_path``, ``build_and_save``, ``load`` and ``ensure`` of
``boundplanner_tpu/parallel/fleet_cache.py``).

A cache file (schema ``fleet_cache_v1``) is a pickle of the stacked fleet:
numpy-leaf NamedTuples (carry, obstacle arrays), the start configurations
and the broker's counters. Files written by the JAX package hold its
classes; files written here hold this package's classes of the same field
order. An ``Unpickler`` maps both onto this package's NamedTuples.
``to_torch`` carries the fleet onto a device and dtype; ``to_numpy``
brings any result tree back. Unpickle only cache files this repository's
tools wrote.

CLI:  python -m boundplanner_tpu_torch.parallel.fleet_cache B SEED out.pkl [--device cpu] [--eager]

(the card by default; a run without one exits at once with an error)
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import torch

from ..config import perf_mpc_params
from ..mpc.bound_mpc import MPCCarry
from ..path.reference_path import PathState
from ..planner.set_finder import ObstacleArrays
from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.tree import to_numpy, to_torch, tree_map  # noqa: F401  (re-exported)

SCHEMA = "fleet_cache_v1"

_CLASSES = {
    (f"{pkg}.{mod}", cls.__name__): cls
    for pkg in ("boundplanner_tpu", "boundplanner_tpu_torch")
    for mod, cls in (("mpc.bound_mpc", MPCCarry), ("path.reference_path", PathState),
                     ("planner.set_finder", ObstacleArrays))
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CLASSES:
            return _CLASSES[(module, name)]
        if module.startswith(("boundplanner_tpu", "jax")):
            raise pickle.UnpicklingError(f"unexpected class {module}.{name} in fleet cache")
        return super().find_class(module, name)


def cache_path(batch: int, seed: int, nr_segs: int, root: str | None = None) -> str:
    root = root or os.path.join(os.path.dirname(__file__), "..", "..", ".fleet_cache")
    return os.path.abspath(
        os.path.join(root, f"fleet_b{batch}_s{seed}_segs{nr_segs}.pkl")
    )


def build_and_save(batch: int, seed: int, path: str, n_threads: int = 8,
                   dtype=np.float32, device=DEFAULT_DEVICE, plan_dtype=torch.float32,
                   graph: bool | None = None):
    """Plan the fleet on ``device`` in ``plan_dtype`` (``graph``: the
    planners', `planner.BoundPlanner`) and pickle it.

    Fleets under 512 scenes use the broker-coalesced thread builder
    (`fleet.build_fleet_threaded`, its broker's counters as the stats);
    larger ones the process-pool builder (`fleet.build_fleet_mp`, its
    ``info`` as the stats), whose rate scales with host cores instead of
    one interpreter lock."""
    from .fleet import build_fleet_mp, build_fleet_threaded

    device = checked_device(device)
    cfg = perf_mpc_params()
    if batch >= 512:
        carry_b, q0_b, obs_b, stats = build_fleet_mp(
            batch, cfg, seed=seed, dtype=dtype, device=device, plan_dtype=plan_dtype,
            graph=graph)
    else:
        carry_b, q0_b, obs_b, brk = build_fleet_threaded(
            batch, cfg, seed=seed, dtype=dtype, n_threads=n_threads,
            device=device, plan_dtype=plan_dtype, graph=graph,
        )
        stats = {
            "calls_served": brk.calls_served,
            "batches_run": brk.batches_run,
            "coalesced_calls": brk.coalesced_calls,
        }
    payload = {
        "schema": SCHEMA,
        "batch": batch,
        "seed": seed,
        "nr_segs": cfg.nr_segs,
        "carry": carry_b,
        "q0": q0_b,
        "obs": obs_b,
        "broker_stats": stats,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def load(path: str):
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"unexpected fleet cache schema in {path}")
    return payload


def load_fleet(path: str, device=DEFAULT_DEVICE, dtype=torch.float32):
    """(carry, q0, obs) of a cached fleet as tensors on ``device``."""
    device = checked_device(device)
    payload = load(path)
    return to_torch((payload["carry"], payload["q0"], payload["obs"]), device, dtype)


def ensure(batch: int, seed: int, nr_segs: int, timeout: float = 3600.0,
           device=DEFAULT_DEVICE, graph: bool | None = None):
    """The cached fleet (the payload of `load`), built first on ``device``
    in a subprocess if the file is missing (the subprocess plans with its
    own interpreter and device context, so a caller that holds the card
    for other work is not slowed by the planner's threads; ``graph=False``
    passes ``--eager`` on)."""
    device = checked_device(device)
    path = cache_path(batch, seed, nr_segs)
    if not os.path.exists(path):
        root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
        subprocess.run([sys.executable, "-m", "boundplanner_tpu_torch.parallel.fleet_cache",
                        str(batch), str(seed), path, "--device", str(device)]
                       + (["--eager"] if graph is False else []),
                       check=True, timeout=timeout, cwd=root)
    return load(path)


def main(argv):
    args = list(argv)
    device = DEFAULT_DEVICE
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i : i + 2]
    graph = None
    if "--eager" in args:
        args.remove("--eager")
        graph = False
    b, s, out = int(args[0]), int(args[1]), args[2]
    payload = build_and_save(b, s, out, device=device, graph=graph)
    print(f"fleet cache: {b} scenes -> {out} (broker: {payload['broker_stats']})")


if __name__ == "__main__":
    main(sys.argv[1:])
