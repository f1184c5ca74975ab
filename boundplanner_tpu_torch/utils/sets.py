"""Half-space set helpers (host-side numpy; fixed-shape padding for device).
A copy of ``boundplanner_tpu/utils/sets.py``; the native geometry core
is the port's own binding, ``boundplanner_tpu_torch.native_geom``.

Replaces the cddlib-backed helpers of the reference
(`bound_planner/utils/util_functions.py:66-133`). For the axis-aligned box
obstacles the engine actually uses, vertex enumeration is closed form (the
8 corners); general H-rep vertex enumeration / redundancy removal lives in
the native geometry core (``native_geom``) with a numpy
fallback here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import native_geom

PAD_B_VALUE = 10.0  # inactive-row right-hand side, matches `util_functions.py:122`


def normalize_set_size(sets, max_set_size: int = 15):
    """Pad [A, b] pairs to a fixed row count with inactive rows
    (ref `util_functions.py:119-133`). Returns new lists (functional)."""
    out = []
    for a, b in sets:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64).reshape(-1)
        m = a.shape[0]
        if m > max_set_size:
            raise ValueError(f"set size {m} exceeds max set size {max_set_size}")
        a_pad = np.zeros((max_set_size, 3))
        b_pad = PAD_B_VALUE * np.ones(max_set_size)
        a_pad[:m] = a
        b_pad[:m] = b
        out.append([a_pad, b_pad])
    return out


def make_box(lb: Sequence[float], ub: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box as H-rep (ref `BoundPlanner.py:126-129`)."""
    a = np.concatenate((np.eye(3), -np.eye(3)))
    b = np.concatenate((np.asarray(ub, dtype=np.float64), -np.asarray(lb, dtype=np.float64)))
    return a, b


def box_vertices(lb: Sequence[float], ub: Sequence[float]) -> np.ndarray:
    """The 8 corners of an axis-aligned box — the closed form that replaces
    cddlib vertex enumeration for obstacles (ref `util_functions.py:66-79`)."""
    lb = np.asarray(lb, dtype=np.float64)
    ub = np.asarray(ub, dtype=np.float64)
    out = np.empty((8, 3))
    k = 0
    for x in (lb[0], ub[0]):
        for y in (lb[1], ub[1]):
            for z in (lb[2], ub[2]):
                out[k] = (x, y, z)
                k += 1
    return out


def polytope_vertices(a_set: np.ndarray, b_set: np.ndarray, tol: float = 1e-9) -> np.ndarray:
    """Enumerate vertices of {x : A x <= b} in 3D by intersecting all triples
    of active planes (numpy fallback for the native geometry core; replaces
    pycddlib, ref `util_functions.py:66-79`). O(m^3) with m <= ~25."""
    try:
        if native_geom.available():
            return native_geom.polytope_vertices(a_set, b_set, tol)
    except Exception:
        pass
    a = np.asarray(a_set, dtype=np.float64)
    b = np.asarray(b_set, dtype=np.float64).reshape(-1)
    m = a.shape[0]
    verts: List[np.ndarray] = []
    for i in range(m):
        for j in range(i + 1, m):
            for k in range(j + 1, m):
                mat = a[[i, j, k]]
                if abs(np.linalg.det(mat)) < 1e-10:
                    continue
                x = np.linalg.solve(mat, b[[i, j, k]])
                if np.all(a @ x <= b + 1e-7):
                    if not any(np.linalg.norm(x - v) < 1e-8 for v in verts):
                        verts.append(x)
    if not verts:
        return np.empty((0, 3))
    return np.array(verts)


def reduce_ineqs(a_set: np.ndarray, b_set: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Remove redundant rows of {Ax <= b} (ref `util_functions.py:82-88`,
    cdd ``matrix_redundancy_remove``). A row is kept iff it is active
    (within tol) at some vertex of the polytope."""
    try:
        if native_geom.available():
            return native_geom.reduce_ineqs(a_set, b_set)
    except Exception:
        pass
    a = np.asarray(a_set, dtype=np.float64)
    b = np.asarray(b_set, dtype=np.float64).reshape(-1)
    verts = polytope_vertices(a, b)
    if verts.shape[0] == 0:
        return a, b
    act = a @ verts.T - b[:, None]  # (m, nv)
    keep = np.any(act > -1e-6, axis=1)
    # Drop duplicate parallel rows (keep first)
    rows = np.hstack([a, b[:, None]])[keep]
    _, uniq = np.unique(np.round(rows, 9), axis=0, return_index=True)
    rows = rows[np.sort(uniq)]
    return rows[:, :3], rows[:, 3]
