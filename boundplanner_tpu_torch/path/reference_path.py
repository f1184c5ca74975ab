"""Moving window over the padded reference path
(port of ``path_window``/``path_advance``/``path_apply_via_correction`` of
``boundplanner_tpu/path/reference_path.py``).

``build_path`` is not ported: the cached fleets already hold the
``PathState``. Every function here is batch-major: each ``PathState`` leaf
carries a leading scene axis ``B``. Indices are clipped exactly where the
JAX package clips them (a gather out of range raises in torch).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_VIAS = 16


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
