"""Checkpoint / resume of MPC session state
(port of ``boundplanner_tpu/checkpoint.py``).

The whole ``MPCCarry`` (its ``PathState`` included) is written to one
``.npz`` under the JAX package's field names (``path.p``, ``x_prev``, ...)
and format version, so a checkpoint written by either package loads in
the other, bit for bit. A single scene's carry and a batched fleet's
(leading scene axis) are stored alike. A field set that does not match
the schema raises instead of being assigned by position.
"""

from __future__ import annotations

import numpy as np
import torch

from .mpc.bound_mpc import MPCCarry
from .path.reference_path import PathState
from .utils.device import DEFAULT_DEVICE, checked_device
from .utils.tree import to_numpy, to_torch

_FORMAT_VERSION = 2


def _field_names():
    names = []
    for f in MPCCarry._fields:
        if f == "path":
            names.extend(f"path.{pf}" for pf in PathState._fields)
        else:
            names.append(f)
    return names


def save_carry(path, carry: MPCCarry):
    """Serialize an MPCCarry (tensor or numpy leaves) to .npz."""
    carry = to_numpy(carry)
    arrays = {f"path.{pf}": getattr(carry.path, pf) for pf in PathState._fields}
    arrays.update({f: getattr(carry, f) for f in MPCCarry._fields if f != "path"})
    np.savez(path, __version__=_FORMAT_VERSION, **arrays)


def load_carry(path, device=DEFAULT_DEVICE, dtype=torch.float64) -> MPCCarry:
    """Restore an MPCCarry saved by either package's ``save_carry`` as
    tensors on ``device``: floating leaves in ``dtype``, integer and bool
    leaves as stored. Raises ``ValueError`` on another format version or
    field set."""
    device = checked_device(device)
    data = np.load(path)
    version = int(data["__version__"]) if "__version__" in data else 1
    if version != _FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format v{version} != supported v{_FORMAT_VERSION}"
        )
    expected = set(_field_names())
    stored = {k for k in data.files if k != "__version__"}
    if stored != expected:
        missing = sorted(expected - stored)
        extra = sorted(stored - expected)
        raise ValueError(
            f"checkpoint schema mismatch: missing fields {missing}, "
            f"unknown fields {extra}"
        )
    path_state = PathState(**{pf: data[f"path.{pf}"] for pf in PathState._fields})
    rest = {f: data[f] for f in MPCCarry._fields if f != "path"}
    return to_torch(MPCCarry(path=path_state, **rest), device, dtype)
