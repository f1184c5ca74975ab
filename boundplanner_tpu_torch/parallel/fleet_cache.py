"""Load the cached planner-built fleets without jax
(port of ``load`` of ``boundplanner_tpu/parallel/fleet_cache.py``).

The pickles (``.fleet_cache/*.pkl``, schema ``fleet_cache_v1``) hold
numpy-leaf NamedTuples of the JAX package; an ``Unpickler`` maps those
three classes onto this package's NamedTuples of the same field order.
``to_torch`` carries the fleet (carry, start configurations, obstacles)
onto a device and dtype; ``to_numpy`` brings any result tree back.
Unpickle only cache files this repository's tools wrote.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ..mpc.bound_mpc import MPCCarry
from ..path.reference_path import PathState
from ..planner.set_finder import ObstacleArrays

SCHEMA = "fleet_cache_v1"

_CLASSES = {
    ("boundplanner_tpu.mpc.bound_mpc", "MPCCarry"): MPCCarry,
    ("boundplanner_tpu.path.reference_path", "PathState"): PathState,
    ("boundplanner_tpu.planner.set_finder", "ObstacleArrays"): ObstacleArrays,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _CLASSES:
            return _CLASSES[(module, name)]
        if module.startswith(("boundplanner_tpu", "jax")):
            raise pickle.UnpicklingError(f"unexpected class {module}.{name} in fleet cache")
        return super().find_class(module, name)


def load(path: str):
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"unexpected fleet cache schema in {path}")
    return payload


def tree_map(fn, tree):
    """Map over the leaves of nested NamedTuples/tuples/lists/dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_torch(tree, device="cpu", dtype=torch.float32):
    """numpy leaves -> tensors on ``device``: floating leaves in ``dtype``,
    integer and bool leaves keep their type."""
    def conv(a):
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, tree)


def to_numpy(tree):
    """tensor leaves -> numpy arrays."""
    return tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tree,
    )


def load_fleet(path: str, device="cpu", dtype=torch.float32):
    """(carry, q0, obs) of a cached fleet as tensors."""
    payload = load(path)
    return to_torch((payload["carry"], payload["q0"], payload["obs"]), device, dtype)
