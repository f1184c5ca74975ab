"""Padded reference path and its moving window
(port of ``build_path``, ``path_window``, ``path_advance`` and
``path_apply_via_correction`` of ``boundplanner_tpu/path/reference_path.py``).

``build_path`` is host numpy + scipy, as in the JAX package: it turns one
plan's via points into a ``PathState`` with numpy leaves. The window
functions are batch-major: each ``PathState`` leaf carries a leading scene
axis ``B``. Indices are clipped exactly where the JAX package clips them (a
gather out of range raises in torch).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from scipy.spatial.transform import Rotation as SciRotation

from ..config import MPC_SET_ROWS

MAX_VIAS = 16  # fixed via-point capacity (actual plans use ~2-8)


class PathState(NamedTuple):
    """Padded path data + window cursor (field order of the JAX package's
    ``PathState``; the fleet pickles depend on it)."""

    p: torch.Tensor            # (B, V, 3)
    r: torch.Tensor            # (B, V, 3, 3)
    r_tau: torch.Tensor        # (B, V, 3)
    iw: torch.Tensor           # (B, V, 3)
    dp: torch.Tensor           # (B, V, 3)
    dp_unit: torch.Tensor      # (B, V, 3)
    dr: torch.Tensor           # (B, V, 3)
    dr_normed: torch.Tensor    # (B, V, 3)
    seg_len: torch.Tensor      # (B, V)
    bp1: torch.Tensor          # (B, V, 3)
    bp2: torch.Tensor          # (B, V, 3)
    br1: torch.Tensor          # (B, V, 3)
    br2: torch.Tensor          # (B, V, 3)
    e_r_bound: torch.Tensor    # (B, V, 6)
    a_set: torch.Tensor        # (B, V, 15, 3)
    b_set: torch.Tensor        # (B, V, 15)
    sector: torch.Tensor       # (B,) int32
    num_sectors: torch.Tensor  # (B,) int32
    phi_max: torch.Tensor      # (B,)
    phi_bias: torch.Tensor     # (B,)
    switched: torch.Tensor     # (B,) bool

    @property
    def phi_cumsum(self):
        return torch.cumsum(self.seg_len, dim=-1)


def _unit(v, fallback=None):
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.array(fallback) if fallback is not None else v
    return v / n


def build_path(
    p_via: Sequence[np.ndarray],
    r_via: Sequence[np.ndarray],
    bp1: Sequence[np.ndarray],
    br1: Sequence[np.ndarray],
    e_r_bound: Sequence[np.ndarray],
    a_sets: Sequence[np.ndarray],
    b_sets: Sequence[np.ndarray],
    nr_segs: int = 4,
    phi_bias: float = 0.0,
    dtype=np.float64,
    spiral_blend: float = 0.0,
    spiral_sub: int = 4,
) -> PathState:
    """Host-side path preprocessing of ONE plan (ref `ReferencePath.py:12-166`):
    numpy in, a ``PathState`` with numpy leaves out (stack scenes and
    convert with `parallel.fleet_cache.to_torch`).

    ``spiral_blend > 0`` blends each interior corner with an euler spiral
    of that half-arc length: ``spiral_sub`` sub-segments sampled on the
    clothoid replace the corner (`euler_spiral.blend_corners`)."""
    if spiral_blend > 0.0:
        from .euler_spiral import blend_corners

        (p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets) = blend_corners(
            p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets,
            length=spiral_blend, n_sub=spiral_sub,
        )
    p_list = [np.asarray(x, dtype=dtype) for x in p_via]
    r_list = [np.asarray(x, dtype=dtype) for x in r_via]
    l_traj = len(p_list)
    num_sectors = l_traj - 2
    if l_traj + nr_segs > MAX_VIAS:
        raise ValueError(f"path with {l_traj} vias exceeds MAX_VIAS={MAX_VIAS}")

    e_r_bound = [np.asarray(x, dtype=dtype) for x in e_r_bound]
    a_list = [np.asarray(x, dtype=dtype) for x in a_sets]
    b_list = [np.asarray(x, dtype=dtype) for x in b_sets]

    # --- rotation deltas, normed axes with direction-flip guard, iw ---
    dr, dr_normed, iw = [], [], [np.zeros(3, dtype=dtype)]
    omega_prev = np.array([0.0, 1.0, 0.0])
    for i in range(1, l_traj):
        drot = SciRotation.from_matrix(r_list[i] @ r_list[i - 1].T).as_rotvec()
        dr.append(drot)
        norm_dr = np.linalg.norm(drot)
        if norm_dr > 1e-4:
            axis = drot / norm_dr
            # do not change the projection axis when only reversing direction
            if np.linalg.norm(omega_prev + axis) < 1e-4:
                axis = -axis
            dr_normed.append(axis)
        else:
            dr_normed.append(omega_prev.copy())
        omega_prev = dr_normed[-1].copy()
        iw.append(iw[-1] + dr[-1])

    # --- position deltas with degenerate-segment fallback ---
    dp = []
    for i in range(1, l_traj):
        d = p_list[i] - p_list[i - 1]
        if np.linalg.norm(d) < 1e-3:
            d = dp[-1].copy() if i > 1 else np.array([0.0, 1.0, 0.0])
        dp.append(d)

    # --- segment lengths (rotation-only segments get |dr|/pi) ---
    seg_len = []
    for i in range(1, l_traj):
        li = np.linalg.norm(p_list[i] - p_list[i - 1])
        if li < 1e-3:
            li = np.linalg.norm(dr[i - 1]) / np.pi
        seg_len.append(li)
    phi_max = float(np.sum(seg_len)) + phi_bias

    # --- orthonormal bases ---
    bp1_l, bp2_l, br1_l, br2_l = [], [], [], []
    for i in range(l_traj - 1):
        dpu = _unit(dp[i])
        b1 = np.asarray(bp1[i], dtype=dtype)
        b1 = b1 - np.dot(dpu, b1) * dpu
        if np.linalg.norm(b1) < 1e-3:
            b1 = np.array([1.0, 1.0, 1.0])
            b1 = b1 - np.dot(dpu, b1) * dpu
        b1 = _unit(b1)
        bp1_l.append(b1)
        bp2_l.append(_unit(np.cross(dpu, b1)))

        b1r = np.asarray(br1[i], dtype=dtype)
        axis = dr_normed[i]
        b1r = b1r - np.dot(axis, b1r) * axis
        if np.linalg.norm(b1r) < 1e-3:
            b1r = np.array([1.0, 1.0, 1.0])
            b1r = b1r - np.dot(axis, b1r) * axis
        b1r = _unit(b1r)
        br1_l.append(b1r)
        br2_l.append(_unit(np.cross(axis, b1r)))

    # --- scale omega to phi parametrization (ref `ReferencePath.py:152-155`) ---
    dr_scaled = [
        dr[i] / seg_len[i] if seg_len[i] > 1e-8 else dr[i] for i in range(l_traj - 1)
    ]

    def pad(arrs, shape_tail):
        out = np.zeros((MAX_VIAS,) + shape_tail, dtype=dtype)
        for i, a in enumerate(arrs):
            out[i] = a
        for i in range(len(arrs), MAX_VIAS):
            out[i] = arrs[-1]
        return out

    # normalize set shapes to (15, 3)/(15,)
    a_norm, b_norm = [], []
    for a, b in zip(a_list, b_list):
        a_p = np.zeros((MPC_SET_ROWS, 3), dtype=dtype)
        b_p = 10.0 * np.ones(MPC_SET_ROWS, dtype=dtype)
        a_p[: a.shape[0]] = a
        b_p[: b.shape[0]] = b
        a_norm.append(a_p)
        b_norm.append(b_p)

    r_tau = [SciRotation.from_matrix(r).as_rotvec() for r in r_list]
    # seg_len list in the reference gets "1" padding entries
    # (`ReferencePath.py:104-105`); replicate so phi_switch of padded
    # segments advances past phi_max.
    seg_pad = np.ones(MAX_VIAS, dtype=dtype)
    seg_pad[0] = 0.0
    seg_pad[1 : l_traj] = seg_len

    state = PathState(
        p=pad(p_list, (3,)),
        r=pad(r_list, (3, 3)),
        r_tau=pad(r_tau, (3,)),
        iw=pad(iw, (3,)),
        dp=pad(dp, (3,)),
        dp_unit=pad([_unit(d) for d in dp], (3,)),
        dr=pad(dr_scaled, (3,)),
        dr_normed=pad(dr_normed, (3,)),
        seg_len=seg_pad,
        bp1=pad(bp1_l, (3,)),
        bp2=pad(bp2_l, (3,)),
        br1=pad(br1_l, (3,)),
        br2=pad(br2_l, (3,)),
        e_r_bound=pad(e_r_bound, (6,)),
        a_set=pad(a_norm, (MPC_SET_ROWS, 3)),
        b_set=pad(b_norm, (MPC_SET_ROWS,)),
        sector=np.asarray(0, np.int32),
        num_sectors=np.asarray(num_sectors, np.int32),
        phi_max=np.asarray(phi_max, dtype),
        phi_bias=np.asarray(phi_bias, dtype),
        switched=np.asarray(True),
    )
    return state


build_path_np = build_path   # the JAX package's name (its demo imports it)


def take(arr, idx):
    """Per-scene gather along axis 1: arr (B, V, ...), idx (B, S) -> (B, S, ...)."""
    bidx = torch.arange(arr.shape[0], device=arr.device)[:, None]
    return arr[bidx, idx.long()]


def path_window(state: PathState, nr_segs: int):
    """The current ``nr_segs`` window (ref `ReferencePath.py:216-231`):
    p_ref (B, S, 6), dp_ref (B, S, 6), dp_normed (B, S, 3), phi_switch
    (B, S+1), bp1/bp2/br1/br2 (B, S, 3), e_r_bound (B, S, 6), a_set
    (B, S, 15, 3), b_set (B, S, 15), r_taud (B, S, 3), r_vias (B, S, 3, 3)."""
    dev = state.p.device
    sector = state.sector.long()[:, None]
    idx = torch.clamp(sector + torch.arange(nr_segs, device=dev), 0, MAX_VIAS - 1)
    p_ref = torch.cat([take(state.p, idx), take(state.iw, idx)], dim=-1)
    dp_ref = torch.cat([take(state.dp_unit, idx), take(state.dr, idx)], dim=-1)
    idx_sw = torch.clamp(
        sector + torch.arange(nr_segs + 1, device=dev), 0, MAX_VIAS - 1
    )
    phi_switch = take(state.phi_cumsum, idx_sw) + state.phi_bias[:, None]
    return {
        "p_ref": p_ref,
        "dp_ref": dp_ref,
        "dp_normed": take(state.dr_normed, idx),
        "phi_switch": phi_switch,
        "bp1": take(state.bp1, idx),
        "bp2": take(state.bp2, idx),
        "br1": take(state.br1, idx),
        "br2": take(state.br2, idx),
        "e_r_bound": take(state.e_r_bound, idx),
        "a_set": take(state.a_set, idx),
        "b_set": take(state.b_set, idx),
        "r_taud": take(state.r_tau, idx),
        "r_vias": take(state.r, idx),
    }


def path_advance(state: PathState, switch) -> PathState:
    """Advance the window one sector where ``switch`` is set and sectors
    remain (ref `ReferencePath.py:187-207`)."""
    can = switch & (state.sector < state.num_sectors)
    return state._replace(
        sector=torch.where(can, state.sector + 1, state.sector),
        switched=can,
    )


def path_apply_via_correction(state: PathState, seg_offset, p_new, phi_correction) -> PathState:
    """Move via point ``sector + seg_offset`` to ``p_new`` (B, 3) and shorten
    the following segment by ``phi_correction`` (B,) (ref
    `BoundMPC.py:992-1011`)."""
    dev = state.p.device
    i = torch.clamp(state.sector.long() + seg_offset, 0, MAX_VIAS - 1)     # (B,)
    slots = torch.arange(MAX_VIAS, device=dev)
    at_i = slots[None, :] == i[:, None]                                    # (B, V)
    p = torch.where(at_i[..., None], p_new[:, None, :], state.p)
    # `.at[i + 1].add` drops the update when i + 1 is out of range
    at_i1 = slots[None, :] == (i + 1)[:, None]
    seg_len = torch.where(at_i1, state.seg_len - phi_correction[:, None], state.seg_len)
    cums = torch.cumsum(seg_len, dim=-1)
    j = torch.clamp(state.num_sectors.long() + 1, 0, MAX_VIAS - 1)
    phi_max = take(cums, j[:, None])[:, 0] + state.phi_bias
    return state._replace(p=p, seg_len=seg_len, phi_max=phi_max)
