"""Obstacle arrays and the per-link convex sets of the tick, in plain
PyTorch (copied from the port's ``planner/set_finder.py`` and
``utils/sets.py``, without the planner). ``find_set_line`` takes the
closest-point route by name: ``"dykstra"`` is the function kernel B
computes (the port's route for a float32 tick on the card), ``"ipm"`` the
exact 25-iteration interior-point projection (its route in float64).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.proj import seg_poly_closest

MAX_OBS = 16
OBS_ROWS = 15


class ObstacleArrays(NamedTuple):
    a: torch.Tensor       # (..., M, 15, 3) H-rep rows (padded, inactive b=10)
    b: torch.Tensor       # (..., M, 15)
    points: torch.Tensor  # (..., M, 8, 3) box corners
    mask: torch.Tensor    # (..., M) bool: obstacle present


def make_box(lb, ub):
    """H-representation a x <= b of the box [lb, ub]."""
    a = np.concatenate([np.eye(3), -np.eye(3)])
    b = np.concatenate([np.asarray(ub, dtype=np.float64), -np.asarray(lb, dtype=np.float64)])
    return a, b


def box_vertices(lb, ub) -> np.ndarray:
    """The 8 corners of the box [lb, ub]."""
    lb, ub = np.asarray(lb, dtype=np.float64), np.asarray(ub, dtype=np.float64)
    return np.array([[x, y, z] for x in (lb[0], ub[0]) for y in (lb[1], ub[1])
                     for z in (lb[2], ub[2])])


def build_obstacle_arrays(obstacles: Sequence[Sequence[float]], size_increase: float = 0.0,
                          max_obs: int = MAX_OBS, dtype=np.float64) -> ObstacleArrays:
    """AABB obstacles [xmin, ymin, zmin, xmax, ymax, zmax] -> padded numpy
    arrays of ONE scene."""
    m = len(obstacles)
    if m > max_obs:
        raise ValueError(f"{m} obstacles exceed MAX_OBS={max_obs}")
    a_arr = np.zeros((max_obs, OBS_ROWS, 3), dtype=dtype)
    b_arr = 10.0 * np.ones((max_obs, OBS_ROWS), dtype=dtype)
    pts = np.zeros((max_obs, 8, 3), dtype=dtype)
    mask = np.zeros(max_obs, dtype=bool)
    for i, ob in enumerate(obstacles):
        lb, ub = np.asarray(ob[:3], dtype=dtype), np.asarray(ob[3:], dtype=dtype)
        a, b = make_box(lb, ub)
        a_arr[i, :6] = a
        b_arr[i, :6] = b + size_increase
        pts[i] = box_vertices(lb - size_increase, ub + size_increase)
        mask[i] = True
    return ObstacleArrays(a=a_arr, b=b_arr, points=pts, mask=mask)


def _box_rows(upper, lower_neg):
    eye = torch.eye(3, dtype=upper.dtype, device=upper.device)
    a = torch.cat([eye, -eye], dim=0).expand(upper.shape[:-1] + (6, 3))
    return a, torch.cat([upper, lower_neg], dim=-1)


def _take(t, idx):
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _halfspace_scan(obs: ObstacleArrays, obs_points, anchor_points, dists, normal_fn,
                    n_rows: int, b_margin: float, degenerate):
    """The delete-covered-obstacles loop as a fixed-length masked loop."""
    dev = obs_points.device
    n_obs = obs_points.shape[1]
    slots = torch.arange(n_obs, device=dev)
    active = obs.mask
    collision = torch.zeros(dists.shape[:1], dtype=torch.bool, device=dev)
    a_rows, b_rows = [], []
    for _ in range(n_rows):
        d = torch.where(active, dists, torch.inf)
        idx = torch.argmin(d, dim=-1)
        any_active = torch.any(active, dim=-1)
        x = _take(obs_points, idx)
        anchor = _take(anchor_points, idx)
        a_raw = normal_fn(x, anchor)
        na = torch.linalg.vector_norm(a_raw, dim=-1)
        collision = collision | (any_active & _take(degenerate, idx))
        a_unit = a_raw / torch.clamp(na, min=1e-12)[:, None]
        b_val = torch.sum(a_unit * x, dim=-1) - b_margin
        corner_margin = torch.einsum("nmkj,nj->nmk", obs.points, a_unit) - b_val[:, None, None]
        outside = torch.amin(corner_margin, dim=-1) >= -1e-4
        new_active = active & ~outside & (slots[None, :] != idx[:, None])
        active = torch.where(any_active[:, None], new_active, active)
        a_rows.append(torch.where(any_active[:, None], a_unit, 0.0))
        b_rows.append(torch.where(any_active, b_val, 10.0))
    return torch.stack(a_rows, dim=1), torch.stack(b_rows, dim=1), collision


def find_set_line(p0, p1, obs: ObstacleArrays, e_max, route: str, n_rows: int = 15):
    """Collision-free convex set around each segment [p0, p1] (N, 3): a box
    of half-width e_max around p0, then one row per nearest obstacle."""
    a_init, b_init = _box_rows(p0 + e_max, -p0 + e_max)
    nb, m = obs.a.shape[:2]
    r = obs.a.shape[2]
    xs, phis = seg_poly_closest(
        obs.a.reshape(nb * m, r, 3),
        (obs.b - 0.001).reshape(nb * m, r),
        p0[:, None, :].expand(nb, m, 3).reshape(nb * m, 3),
        p1[:, None, :].expand(nb, m, 3).reshape(nb * m, 3),
        route,
    )
    xs = xs.reshape(nb, m, 3)
    phis = phis.reshape(nb, m)
    seg_pts = p0[:, None, :] + phis[..., None] * (p1 - p0)[:, None, :]
    dists = torch.linalg.vector_norm(xs - seg_pts, dim=-1)

    def normal_fn(x, anchor):
        a_raw = x - anchor
        na = torch.linalg.vector_norm(a_raw, dim=-1, keepdim=True)
        a_alt = x - p0
        na_alt = torch.linalg.vector_norm(a_alt, dim=-1, keepdim=True)
        a_alt2 = p1 - p0
        return torch.where(na < 1e-6, torch.where(na_alt < 1e-6, a_alt2, a_alt), a_raw)

    a_rows, b_rows, collision = _halfspace_scan(obs, xs, seg_pts, dists, normal_fn, n_rows - 6,
                                                b_margin=0.001, degenerate=dists < 1e-6)
    return torch.cat([a_init, a_rows], dim=1), torch.cat([b_init, b_rows], dim=1), collision
