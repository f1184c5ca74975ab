"""Scene batching, device meshes, the multi-process tier and the fleet
builders (port of ``boundplanner_tpu/parallel/__init__.py``).

Submodules are imported lazily, as in the JAX package, so that importing
this package stays free of side effects: `parallel.distributed` sets up
its process group before anything else touches the card.
"""

import importlib

__all__ = [
    "batched_mpc_tick",
    "closed_loop_rollout",
    "fleet_rollout",
    "make_batch_scene",
    "make_mesh",
    "shard_batch",
    "sharded_rollout",
    "distributed",
]

_LOCATIONS = {
    "batched_mpc_tick": "batch",
    "closed_loop_rollout": "batch",
    "fleet_rollout": "batch",
    "make_batch_scene": "batch",
    "make_mesh": "mesh",
    "shard_batch": "mesh",
    "sharded_rollout": "mesh",
    "distributed": None,
}


def __getattr__(name):
    if name not in _LOCATIONS:
        raise AttributeError(name)
    mod = _LOCATIONS[name]
    if mod is None:
        return importlib.import_module(f".{name}", __name__)
    return getattr(importlib.import_module(f".{mod}", __name__), name)
