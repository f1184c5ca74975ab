"""Pytree helpers for nested NamedTuples/tuples/lists/dicts of arrays:
map, stack, and moves between numpy and torch."""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Map over the leaves of one tree, or zip the leaves of several trees
    of the same structure into ``fn``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_stack(trees):
    """Stack the numpy leaves of equally shaped trees on a new leading axis."""
    return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def to_torch(tree, device, dtype=torch.float32):
    """numpy leaves -> tensors on ``device`` (no default: the caller names
    it): floating leaves in ``dtype``, integer and bool leaves keep their
    type."""
    def conv(a):
        a = np.asarray(a)
        # (ascontiguousarray makes 0-d arrays 1-d: keep the shape)
        t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
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


def host_array(v) -> np.ndarray:
    """``v`` as a float64 numpy array: a tensor (on any device, also inside
    a list or tuple) is detached and copied to the host first, where
    ``np.asarray`` alone would fail on a CUDA tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().astype(np.float64)
    if isinstance(v, (list, tuple)):
        return np.asarray([host_array(x) for x in v], dtype=np.float64)
    return np.asarray(v, dtype=np.float64)
