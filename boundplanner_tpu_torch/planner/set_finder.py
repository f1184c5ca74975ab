"""Convex collision-free set around a segment
(port of ``ObstacleArrays``, ``_init_rows_point``, ``_halfspace_scan`` and
``find_set_line`` of ``boundplanner_tpu/planner/set_finder.py``; the rest
of the planner is a later slice).

Batch-major: N independent problems (in the MPC tick, scenes x links) run
in lockstep. The per-obstacle closest points of all N problems go through
ONE ``seg_poly_closest`` call (kernel B on a CUDA float32 batch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_proj import seg_poly_closest


class ObstacleArrays(NamedTuple):
    a: torch.Tensor       # (..., M, 15, 3) H-rep rows (padded, inactive b=10)
    b: torch.Tensor       # (..., M, 15)
    points: torch.Tensor  # (..., M, 8, 3) box corners
    mask: torch.Tensor    # (..., M) bool — obstacle present


def _init_rows_point(p, e_max, dtype):
    """Axis-aligned box of half-width e_max around p (N, 3) -> a (N, 6, 3),
    b (N, 6)."""
    eye = torch.eye(3, dtype=dtype, device=p.device)
    a = torch.cat([eye, -eye], dim=0).expand(p.shape[:-1] + (6, 3))
    b = torch.cat([p + e_max, -p + e_max], dim=-1)
    return a, b


def _take(t, idx):
    """t (N, M, ...), idx (N,) -> (N, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def _halfspace_scan(obs: ObstacleArrays, obs_points, anchor_points, dists,
                    normal_fn, n_rows: int, b_margin: float, degenerate=None):
    """The delete-covered-obstacles loop as a fixed-length masked loop over
    N problems: obs leaves (N, M, ...), obs_points/anchor_points (N, M, 3),
    dists (N, M). Returns (a_rows (N, n_rows, 3), b_rows (N, n_rows),
    collision (N,))."""
    dtype, dev = obs_points.dtype, obs_points.device
    n_obs = obs_points.shape[1]
    slots = torch.arange(n_obs, device=dev)
    if degenerate is None:
        degenerate = torch.zeros(dists.shape, dtype=torch.bool, device=dev)
    active = obs.mask
    collision = torch.zeros(dists.shape[:1], dtype=torch.bool, device=dev)
    a_rows, b_rows = [], []
    for _ in range(n_rows):
        d = torch.where(active, dists, torch.inf)
        idx = torch.argmin(d, dim=-1)                       # first minimum
        any_active = torch.any(active, dim=-1)

        x = _take(obs_points, idx)
        anchor = _take(anchor_points, idx)
        a_raw = normal_fn(x, anchor)
        na = torch.linalg.vector_norm(a_raw, dim=-1)
        collision = collision | (any_active & _take(degenerate, idx))
        a_unit = a_raw / torch.clamp(na, min=1e-12)[:, None]
        b_val = torch.sum(a_unit * x, dim=-1) - b_margin

        # drop every obstacle fully outside the new half-space
        corner_margin = (
            torch.einsum("nmkj,nj->nmk", obs.points, a_unit) - b_val[:, None, None]
        )
        outside = torch.amin(corner_margin, dim=-1) >= -1e-4
        new_active = active & ~outside & (slots[None, :] != idx[:, None])
        active = torch.where(any_active[:, None], new_active, active)

        a_rows.append(torch.where(any_active[:, None], a_unit, 0.0))
        b_rows.append(torch.where(any_active, b_val, 10.0))
    return torch.stack(a_rows, dim=1), torch.stack(b_rows, dim=1), collision


def find_set_line(p0, p1, obs: ObstacleArrays, e_max, ws_min=None, ws_max=None,
                  limit_space: bool = True, n_rows: int = 15):
    """Collision-free convex set around each segment [p0, p1] (N, 3), with
    obstacles obs (leaves (N, M, ...)). Returns (a (N, n_rows, 3),
    b (N, n_rows), collision (N,)). The first 6 rows are the init box."""
    if not limit_space:
        raise NotImplementedError("find_set_line: workspace init rows are not ported")
    dtype = p0.dtype
    a_init, b_init = _init_rows_point(p0, e_max, dtype)

    nb, m = obs.a.shape[:2]
    r = obs.a.shape[2]
    xs, phis = seg_poly_closest(
        obs.a.reshape(nb * m, r, 3),
        (obs.b - 0.001).reshape(nb * m, r),
        p0[:, None, :].expand(nb, m, 3).reshape(nb * m, 3),
        p1[:, None, :].expand(nb, m, 3).reshape(nb * m, 3),
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

    a_rows, b_rows, collision = _halfspace_scan(
        obs, xs, seg_pts, dists, normal_fn, n_rows - 6, b_margin=0.001,
        degenerate=dists < 1e-6,
    )
    return (
        torch.cat([a_init, a_rows], dim=1),
        torch.cat([b_init, b_rows], dim=1),
        collision,
    )
