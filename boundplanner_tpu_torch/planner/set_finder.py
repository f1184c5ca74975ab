"""Convex collision-free set construction
(port of ``boundplanner_tpu/planner/set_finder.py``).

Batch-major: N independent problems run in lockstep (in the MPC tick,
scenes x links; in the planner, the calls the broker coalesced). Obstacle
leaves carry the problem axis: (N, M, ...). The per-obstacle closest points
of all N problems go through ONE ``seg_poly_closest`` call (kernel B on a
CUDA float32 batch) or ONE batched QP (kernel A on the card), and the
delete-covered-obstacles loop is a fixed-length masked loop, as the JAX
package's ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.cuda_proj import seg_poly_closest
from ..ops.mvie import mvie, mvie_fixed_mid, mvie_fixed_r
from ..ops.qp import solve_qp
from ..utils.sets import box_vertices, make_box
from ..utils.so3 import gram_schmidt

MAX_OBS = 16
OBS_ROWS = 15


class ObstacleArrays(NamedTuple):
    a: torch.Tensor       # (..., M, 15, 3) H-rep rows (padded, inactive b=10)
    b: torch.Tensor       # (..., M, 15)
    points: torch.Tensor  # (..., M, 8, 3) box corners
    mask: torch.Tensor    # (..., M) bool — obstacle present


def build_obstacle_arrays(
    obstacles: Sequence[Sequence[float]],
    size_increase: float = 0.0,
    max_obs: int = MAX_OBS,
    dtype=np.float64,
) -> ObstacleArrays:
    """Host-side: AABB obstacles [xmin,ymin,zmin,xmax,ymax,zmax] -> padded
    numpy arrays of ONE scene (convert with `parallel.fleet_cache.to_torch`)."""
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


def build_obstacle_arrays_np(obstacles, size_increase: float = 0.0,
                             max_obs: int = MAX_OBS, dtype=np.float64):
    """`build_obstacle_arrays` under the JAX package's name for it (numpy
    leaves either way)."""
    return build_obstacle_arrays(obstacles, size_increase, max_obs, dtype)


def _box_rows(upper, lower_neg):
    """Rows [I; -I] with b = [upper; lower_neg], each (N, 3) -> a (N, 6, 3),
    b (N, 6)."""
    eye = torch.eye(3, dtype=upper.dtype, device=upper.device)
    a = torch.cat([eye, -eye], dim=0).expand(upper.shape[:-1] + (6, 3))
    return a, torch.cat([upper, lower_neg], dim=-1)


def _init_rows_point(p, e_max, dtype):
    """Axis-aligned box of half-width e_max around p (N, 3)."""
    return _box_rows(p + e_max, -p + e_max)


def _init_rows_workspace(ws_min, ws_max, dtype):
    """Workspace box rows from ws_min/ws_max (N, 3)."""
    return _box_rows(ws_max, -ws_min)


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
    obstacles obs (leaves (N, M, ...)). The first 6 rows are a box of
    half-width e_max around p0 (``limit_space``) or the workspace box
    ws_min/ws_max (N, 3). Returns (a (N, n_rows, 3), b (N, n_rows),
    collision (N,))."""
    dtype = p0.dtype
    if limit_space:
        a_init, b_init = _init_rows_point(p0, e_max, dtype)
    else:
        a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)

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


def _polyhedron_once(p_seed, gen_l, shape_s, obs: ObstacleArrays, a_init, b_init, n_rows):
    """One separating-hyperplane sweep around each ellipsoid {p + L u}:
    p_seed (N, 3), gen_l/shape_s (N, 3, 3). Returns (a (N, n_rows, 3),
    b (N, n_rows), ok (N,))."""
    dtype, dev = p_seed.dtype, p_seed.device
    nb, m, r = obs.a.shape[:3]
    # per-obstacle closest point in the ellipsoid metric, all N x M QPs in
    # one batch: min |y|^2 s.t. (A L) y <= b - A p ; x = L y + p
    g = obs.a @ gen_l[:, None]                                    # (N, M, R, 3)
    h = obs.b - (obs.a @ p_seed[:, None, :, None])[..., 0]        # (N, M, R)
    eye = torch.eye(3, dtype=dtype, device=dev)
    sol = solve_qp((2.0 * eye).expand(nb * m, 3, 3),
                   torch.zeros((nb * m, 3), dtype=dtype, device=dev),
                   g.reshape(nb * m, r, 3), h.reshape(nb * m, r), iters=25)
    y = sol.x.reshape(nb, m, 3)
    xs = (gen_l[:, None] @ y[..., None])[..., 0] + p_seed[:, None]
    dists = torch.linalg.vector_norm(y, dim=-1)

    s_inv = torch.linalg.inv_ex(shape_s + 1e-12 * eye)[0]

    def normal_fn(x, anchor):
        return (s_inv @ (x - anchor)[..., None])[..., 0]

    anchors = p_seed[:, None].expand_as(xs)
    a_rows, b_rows, _ = _halfspace_scan(
        obs, xs, anchors, dists, normal_fn, n_rows - 6, b_margin=0.0
    )
    ok = torch.amin(torch.where(obs.mask, dists, torch.inf), dim=-1) > 0.99
    return torch.cat([a_init, a_rows], dim=1), torch.cat([b_init, b_rows], dim=1), ok


def _det_abs(gen):
    return torch.abs(torch.linalg.det(gen))


def find_set_around_line(p0, dp1, obs: ObstacleArrays, ws_min, ws_max,
                         n_rows: int = 20, max_iter: int = 5):
    """Convex set grown around each segment [p0, p0 + dp1] (N, 3), with
    the segment direction as a fixed ellipsoid axis: separating-polytope
    sweeps alternate with the fixed-orientation MVIE (`mvie_fixed_r`), the
    first semi-axis kept long enough to cover the segment.

    Returns (a (N, n_rows, 3), b (N, n_rows), shape (N, 3, 3),
    center (N, 3), ok (N,))."""
    dtype, dev = p0.dtype, p0.device
    p1 = p0 + dp1
    l_seg = torch.linalg.vector_norm(dp1, dim=-1)
    dp_ref = dp1 / torch.clamp(l_seg, min=1e-12)[:, None]
    p_seed = 0.5 * (p0 + p1)
    a_lb = l_seg ** 2 / 4.0
    eye = torch.eye(3, dtype=dtype, device=dev)     # rows: the axes, built on the device
    b1d = torch.where((torch.abs(dp_ref[:, 2]) < 0.99)[:, None], eye[2], eye[1])
    b1 = gram_schmidt(dp_ref, b1d)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1, dim=-1), min=1e-12)[:, None]
    b2 = torch.linalg.cross(dp_ref, b1, dim=-1)
    b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2, dim=-1), min=1e-12)[:, None]
    r_ell = torch.stack([dp_ref, b1, b2], dim=-1)

    a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)
    axes0 = torch.stack([a_lb, torch.full_like(a_lb, 1e-2), torch.full_like(a_lb, 1e-2)], dim=-1)
    gen = r_ell @ torch.diag_embed(axes0)
    p = p_seed
    det_old = torch.full_like(a_lb, 1e-12)
    done = torch.zeros_like(a_lb, dtype=torch.bool)
    for _ in range(max_iter):
        shape = gen @ gen.mT
        a_set, b_set, _ = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
        res = mvie_fixed_r(a_set, b_set, p, r_ell, a_lb)
        det_new = _det_abs(res.gen)
        degenerate = torch.amin(torch.abs(torch.diagonal(r_ell.mT @ res.gen, dim1=-2, dim2=-1)),
                                dim=-1) < 1e-3
        conv = torch.abs(det_new - det_old) / torch.clamp(det_old, min=1e-12) < 0.01
        upd = ~done & res.ok & ~degenerate
        gen = torch.where(upd[:, None, None], res.gen, gen)
        det_old = torch.where(upd, det_new, det_old)
        done = done | conv | degenerate | ~res.ok
    shape = gen @ gen.mT
    a_set, b_set, ok = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
    return a_set, b_set, shape, p, ok


def find_set_around_point(p_seed, obs: ObstacleArrays, ws_min, ws_max,
                          fixed_mid: bool = False, n_rows: int = 20, max_iter: int = 5):
    """IRIS-style alternation around each seed p_seed (N, 3): separating
    polytope around an inflating ellipsoid + MVIE expansion (free center,
    or fixed center followed by one free-center polish).

    Returns (a (N, n_rows, 3), b (N, n_rows), shape S = L L^T (N, 3, 3),
    center (N, 3), ok (N,))."""
    dtype, dev = p_seed.dtype, p_seed.device
    a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)
    gen = (1e-2 * torch.eye(3, dtype=dtype, device=dev)).expand(p_seed.shape[:1] + (3, 3))
    p = p_seed
    det_old = torch.full(p_seed.shape[:1], 1e-12, dtype=dtype, device=dev)
    done = torch.zeros(p_seed.shape[:1], dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        shape = gen @ gen.mT
        a_set, b_set, _ = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
        if fixed_mid:
            res = mvie_fixed_mid(a_set, b_set, p)
            p_new = p
        else:
            res = mvie(a_set, b_set, p)
            p_new = res.center
        det_new = _det_abs(res.gen)
        degenerate = torch.amin(torch.abs(torch.diagonal(res.gen, dim1=-2, dim2=-1)), dim=-1) < 1e-3
        conv = torch.abs(det_new - det_old) / torch.clamp(det_old, min=1e-12) < 0.01
        upd = ~done & res.ok & ~degenerate
        p = torch.where(upd[:, None], p_new, p)
        gen = torch.where(upd[:, None, None], res.gen, gen)
        det_old = torch.where(upd, det_new, det_old)
        done = done | conv | degenerate | ~res.ok

    # final polytope at the converged ellipsoid; optional free-center polish
    shape = gen @ gen.mT
    a_set, b_set, ok = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
    if fixed_mid:
        res = mvie(a_set, b_set, p)
        keep = res.ok & (torch.amin(torch.abs(torch.diagonal(res.gen, dim1=-2, dim2=-1)),
                                    dim=-1) > 1e-4)
        gen = torch.where(keep[:, None, None], res.gen, gen)
        p = torch.where(keep[:, None], res.center, p)
        shape = gen @ gen.mT
    return a_set, b_set, shape, p, ok
