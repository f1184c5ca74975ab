"""The tick of the frozen reference: ``MPCCarry``, ``init_carry`` and
``mpc_tick``, copied from the port's ``mpc/bound_mpc.py`` without its
models, graphs and host API. One call is one control period for every
scene of the batch, in plain PyTorch operations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..config import MPCParams
from ..path import ref_fns
from ..path.reference_path import (
    PathState,
    build_path,
    path_advance,
    path_apply_via_correction,
    path_window,
    take,
)
from ..planner.obstacles import ObstacleArrays
from ..robot import kinematics as kin
from ..robot.model import U_MAX
from ..utils import so3
from . import ocp, ocp_struct, prep
from .solver import solve_sqp

NJ = 7


class MPCCarry(NamedTuple):
    """Per-scene tick state (field order of the JAX package's ``MPCCarry``;
    the fleet pickles depend on it). Leaves carry a leading scene axis."""

    path: PathState
    split_idx: torch.Tensor     # (B, nr_segs+1) int32
    switch: torch.Tensor        # (B,) bool
    pr_ref: torch.Tensor        # (B, 3)
    iw_ref: torch.Tensor        # (B, 3)
    phi_current: torch.Tensor   # (B,)
    dphi_current: torch.Tensor  # (B,)
    slacks0: torch.Tensor       # (B, 6)
    x_prev: torch.Tensor        # (B, n_x)
    has_prev: torch.Tensor      # (B,) bool
    error_count: torch.Tensor   # (B,) int32
    prev_q: torch.Tensor        # (B, N, 7)
    prev_dq: torch.Tensor
    prev_ddq: torch.Tensor
    prev_u: torch.Tensor
    prev_p: torch.Tensor        # (B, N, 6)
    prev_v: torch.Tensor        # (B, N, 6)
    prev_pslacks: torch.Tensor  # (B, N)


def init_carry(path: PathState, p0, cfg: MPCParams, dtype=np.float64) -> MPCCarry:
    """Fresh carry of ONE scene at plan start, in numpy (stack scenes and
    convert with `parallel.fleet_cache.to_torch`)."""
    n = cfg.n
    nx = ocp.n_vars(n)
    dtype = np.dtype(dtype)
    p0 = np.asarray(p0, dtype)
    return MPCCarry(
        path=path,
        split_idx=np.asarray([0] + [n] * cfg.nr_segs, np.int32),
        switch=np.asarray(False),
        pr_ref=p0[3:].copy(),
        iw_ref=np.zeros(3, dtype),
        phi_current=np.asarray(0.0, dtype),
        dphi_current=np.asarray(0.0, dtype),
        slacks0=np.zeros(6, dtype),
        x_prev=np.zeros(nx, dtype),
        has_prev=np.asarray(False),
        error_count=np.asarray(0, np.int32),
        prev_q=np.zeros((n, NJ), dtype),
        prev_dq=np.zeros((n, NJ), dtype),
        prev_ddq=np.zeros((n, NJ), dtype),
        prev_u=np.zeros((n, NJ), dtype),
        prev_p=np.tile(p0[None, :], (n, 1)),
        prev_v=np.zeros((n, 6), dtype),
        prev_pslacks=np.zeros(n, dtype),
    )



def _sel(cond, a, b):
    """torch.where with a per-scene condition (B,) broadcast over a/b."""
    cond = cond.reshape(cond.shape + (1,) * (max(a.dim(), b.dim()) - cond.dim()))
    return torch.where(cond, a, b)


def _win_with_proj(win, carry, p0_rot):
    """Initial rotation errors + dual projection vectors for the window."""
    nr_segs = win["br1"].shape[1]
    prs = torch.cat([carry.pr_ref[:, None], win["r_taud"][:, 1:nr_segs]], dim=1)
    dtau, dtau_par, dtau_o1, dtau_o2 = prep.compute_initial_rot_errors(
        p0_rot[:, None].expand(-1, nr_segs, 3), prs,
        win["dp_normed"], win["br1"], win["br2"],
    )
    v1, v2, v3, jac_l, jac_r = prep.orientation_projection_vectors(
        dtau, dtau_par, dtau_o1, dtau_o2, win["dp_normed"], win["br1"], win["br2"]
    )
    return dict(
        dtau_init=dtau,
        dtau_init_par=dtau_par,
        dtau_init_orth1=dtau_o1,
        dtau_init_orth2=dtau_o2,
        v1=v1,
        v2=v2,
        v3=v3,
        jac_dtau_l=jac_l,
        jac_dtau_r=jac_r,
    )


def build_tick_params(carry: MPCCarry, meas: dict, obs: ObstacleArrays,
                      cfg: MPCParams, st):
    """Advance the window, prep rotation errors, shape the phi weights,
    build the link collision sets and assemble the OCP parameters (every
    leaf with a leading scene axis)."""
    nr_segs = cfg.nr_segs
    q0 = meas["q0"]
    path = path_advance(carry.path, carry.switch)
    win = path_window(path, nr_segs)
    proj = _win_with_proj(win, carry, meas["p0"][:, 3:])

    weights, x_phi_d, phi_max_c = prep.shape_phi_weights(
        st.weights.expand(q0.shape[0], -1), path.phi_max, carry.phi_current
    )
    a_j, b_j = prep.link_collision_sets(q0, meas["qf"], obs, st)

    params = {
        "q0": q0,
        "dq0": meas["dq0"],
        "ddq0": meas["ddq0"],
        "p0": meas["p0"],
        "v0": meas["v0"],
        "u0": meas["u0"],
        "split_idx": carry.split_idx,
        "slacks0": carry.slacks0,
        "i_omega_ref_0": carry.iw_ref,
        "x_phi_d": x_phi_d,
        "phi_max": phi_max_c,
        "weights": weights,
        "phi_switch": win["phi_switch"],
        "p_ref": win["p_ref"],
        "dp_ref": win["dp_ref"],
        "dp_normed": win["dp_normed"],
        "bp1": win["bp1"],
        "bp2": win["bp2"],
        "br1": win["br1"],
        "br2": win["br2"],
        "e_r_bound": win["e_r_bound"],
        "a_set": win["a_set"],
        "b_set": win["b_set"],
        "a_set_joints": a_j,
        "b_set_joints": b_j,
        **proj,
    }
    return params, path, win, proj


def _telemetry(i, p_i, v_i, ref_win, err_params, split_idx, p0_rot, n, nr_segs):
    """Reference/errors at the committed trajectory, one scene and step."""
    ref = ref_fns.reference_function(ref_win, split_idx, i, p_i, v_i, n, nr_segs)
    err = ref_fns.error_function(
        ref, err_params, split_idx, i, p_i, v_i, p0_rot, n, nr_segs
    )
    dot = lambda a, b: torch.sum(a * b)
    e_rs = torch.stack([
        dot(err["e_r_orth1"], ref["br1_current"]),
        dot(err["e_r_par"], ref["dp_normed_d"]),
        dot(err["e_r_orth2"], ref["br2_current"]),
    ])
    e_rsn = torch.stack([
        dot(err["e_r_orth1n"], ref["br1_next"]),
        dot(err["e_r_parn"], ref["dp_normed_n"]),
        dot(err["e_r_orth2n"], ref["br2_next"]),
    ])
    return {
        "phi": ref["phi"], "dphi": ref["dphi"], "p_d": ref["p_d"],
        "dp_d": ref["dp_d"], "e_p": err["e_p"], "e_r": err["e_r"],
        "e_rs": e_rs, "e_rsn": e_rsn,
        "r_lo": ref["r_bound_lower"], "r_up": ref["r_bound_upper"],
        "r_lo_n": ref["r_bound_lower_next"], "r_up_n": ref["r_bound_upper_next"],
    }


def mpc_tick(carry: MPCCarry, meas: dict, obs: ObstacleArrays, cfg: MPCParams, st):
    """One control period for every scene. ``meas``: q0, dq0, ddq0, p0, v0,
    u0, qf, each with a leading scene axis."""
    n, nr_segs = cfg.n, cfg.nr_segs
    q0 = meas["q0"]
    dtype, dev = q0.dtype, q0.device
    bsz = q0.shape[0]
    acc = 0.005
    steps = torch.arange(n, device=dev)

    # 0) in-scan re-anchor after safe-stop
    deep_bar = cfg.deep_fail_ticks if cfg.deep_fail_ticks > 0 else n - 2
    deep_bar = min(deep_bar, n - 2)
    deep_prev = carry.error_count >= deep_bar
    at_rest = torch.amax(torch.abs(meas["dq0"]), dim=-1) < 0.1
    reanchor = deep_prev & at_rest & carry.has_prev
    win_p = path_window(carry.path, nr_segs)
    dp3 = win_p["dp_ref"][..., :3]
    pr3 = win_p["p_ref"][..., :3]
    seg_ext = win_p["phi_switch"][:, 1:] - win_p["phi_switch"][:, :-1]
    p0_3 = meas["p0"][:, None, :3]
    t_seg = torch.sum((p0_3 - pr3) * dp3, dim=-1)
    t_seg = torch.minimum(torch.clamp(t_seg, min=0.0), seg_ext)
    d2 = torch.sum((p0_3 - pr3 - t_seg[..., None] * dp3) ** 2, dim=-1)
    valid = (carry.path.sector[:, None] + torch.arange(nr_segs, device=dev)
             <= carry.path.num_sectors[:, None])
    seg_star = torch.argmin(torch.where(valid, d2, torch.inf), dim=-1).to(torch.int32)
    path_r = carry.path._replace(
        sector=torch.where(reanchor, carry.path.sector + seg_star, carry.path.sector)
    )
    win_r = path_window(path_r, nr_segs)
    phi_sw0, phi_sw1 = win_r["phi_switch"][:, 0], win_r["phi_switch"][:, 1]
    p_ref0, dp_ref0 = win_r["p_ref"][:, 0], win_r["dp_ref"][:, 0]
    phi_anchor = phi_sw0 + torch.sum((meas["p0"][:, :3] - p_ref0[:, :3]) * dp_ref0[:, :3], -1)
    phi_anchor = torch.minimum(torch.maximum(phi_anchor, phi_sw0), phi_sw1)
    dphi_anchor = torch.sum(meas["v0"][:, :3] * dp_ref0[:, :3], dim=-1)
    pr_anchor = prep.integrate_rotation_reference(
        so3.matrix_to_rotvec(win_r["r_vias"][:, 0]), dp_ref0[:, 3:], phi_sw0, phi_anchor
    )
    iw_anchor = p_ref0[:, 3:] + (phi_anchor - phi_sw0)[:, None] * dp_ref0[:, 3:]
    pick_anchor = lambda a, b: _sel(reanchor, a, b)
    carry = carry._replace(
        path=path_r,
        phi_current=pick_anchor(phi_anchor, carry.phi_current),
        dphi_current=pick_anchor(dphi_anchor, carry.dphi_current),
        pr_ref=pick_anchor(pr_anchor, carry.pr_ref),
        iw_ref=pick_anchor(iw_anchor, carry.iw_ref),
        slacks0=pick_anchor(torch.zeros_like(carry.slacks0), carry.slacks0),
        split_idx=pick_anchor(st.split_reset.expand(bsz, -1), carry.split_idx),
        switch=carry.switch & ~reanchor,
    )

    params, path, win, proj = build_tick_params(carry, meas, obs, cfg, st)

    # 5) solve, warm-started from the previous decision vector
    x_warm = ocp.shift_warm_start(carry.x_prev, cfg) if cfg.warm_shift else carry.x_prev
    x0 = _sel(carry.has_prev, _sel(reanchor, carry.x_prev, x_warm),
              torch.zeros_like(carry.x_prev))
    sol = solve_sqp(x0, params, cfg, st)

    # 6) infeasibility fallback
    success = sol.success
    use_prev = (~success) & carry.has_prev
    error_count = torch.where(
        success, 0, torch.where(carry.has_prev, carry.error_count + 1, 0)
    ).to(torch.int32)

    traj_new = vmap(lambda x, p: ocp.rollout(x, p, cfg, st))(sol.x, params)
    shift = torch.where(use_prev, torch.clamp(error_count, max=n - 2), 0)
    gidx = torch.clamp(steps[None, :] + shift[:, None], 0, n - 1)

    def pick(new, old):
        return take(_sel(use_prev, old, new), gidx)

    q_out = pick(traj_new["q"], carry.prev_q)
    dq_out = pick(traj_new["dq"], carry.prev_dq)
    ddq_out = pick(traj_new["ddq"], carry.prev_ddq)
    u_out = pick(traj_new["u"], carry.prev_u)
    p_out = pick(traj_new["p"], carry.prev_p)
    v_out = pick(traj_new["v"], carry.prev_v)
    ps_out = pick(traj_new["pslacks"], carry.prev_pslacks)

    # 6b) safe-stop braking once the reusable horizon is exhausted, or at
    # once when the replayed horizon's first 3 EE steps would enter a box
    deep = use_prev & (error_count >= deep_bar)
    if cfg.fallback_guard:
        rows_g = (
            torch.einsum("bmri,bki->bkmr", obs.a, p_out[:, 1:4, :3])
            - obs.b[:, None]
        )
        pen_g = -torch.amax(rows_g, dim=-1)                    # (B, 3, M)
        pen_g = torch.where(obs.mask[:, None], pen_g, -torch.inf)
        deep = deep | (use_prev & (torch.amax(pen_g, dim=(1, 2)) > 0.0))
    q_target = torch.minimum(torch.maximum(q0, st.q_lb + 0.03), st.q_ub - 0.03)
    pos_term = (0.08 / cfg.dt**3) * (q_target - q0)
    pos_term = torch.where(torch.isfinite(pos_term), pos_term, 0.0)
    u_stop = torch.clamp(
        pos_term - (1.5 / cfg.dt) * meas["ddq0"] - (0.5 / cfg.dt**2) * meas["dq0"],
        -U_MAX, U_MAX,
    ).to(u_out.dtype)
    u_out = _sel(deep, u_stop[:, None, :].expand_as(u_out), u_out)

    # 7) horizon telemetry at the committed trajectory
    ref_win = {k: win[k] for k in ("p_ref", "dp_ref", "dp_normed", "phi_switch",
                                   "bp1", "bp2", "br1", "br2", "e_r_bound",
                                   "a_set", "b_set")}
    ref_win.update({k: proj[k] for k in ("v1", "v2", "v3")})
    err_params = {
        "i_omega_ref_0": carry.iw_ref,
        "jac_dtau_l": proj["jac_dtau_l"],
        "jac_dtau_r": proj["jac_dtau_r"],
        "dtau_init": proj["dtau_init"],
        "dtau_init_par": proj["dtau_init_par"],
        "dtau_init_orth1": proj["dtau_init_orth1"],
        "dtau_init_orth2": proj["dtau_init_orth2"],
    }
    telem = lambda i, p_i, v_i, rw, ep, sp, pr: _telemetry(i, p_i, v_i, rw, ep, sp, pr, n, nr_segs)
    tel = vmap(vmap(telem, in_dims=(0, 0, 0, None, None, None, None)),
               in_dims=(None, 0, 0, 0, 0, 0, 0))(
        steps, p_out, v_out, ref_win, err_params, carry.split_idx, meas["p0"][:, 3:]
    )
    phis = tel["phi"]
    dphis = tel["dphi"]

    # 8) rotation-reference integration
    cond_sw1 = carry.split_idx[:, 1] == 1
    base_rv = so3.matrix_to_rotvec(
        _sel(cond_sw1, win["r_vias"][:, 1], win["r_vias"][:, 0])
    )
    seg = cond_sw1.long()[:, None]
    dp_seg = take(win["dp_ref"], seg)[:, 0]
    p_seg = take(win["p_ref"], seg)[:, 0]
    phi_seg = take(win["phi_switch"], seg)[:, 0]
    pr_ref_new = prep.integrate_rotation_reference(base_rv, dp_seg[:, 3:], phi_seg, phis[:, 1])
    iw_ref_new = p_seg[:, 3:] + (phis[:, 1] - phi_seg)[:, None] * dp_seg[:, 3:]

    # 9) segment-switch update with via-point snap correction
    split = carry.split_idx.clone()
    switch = torch.zeros(bsz, dtype=torch.bool, device=dev)
    tol5 = 5.0 * np.pi / 180.0
    in_rot = torch.all(
        (tel["e_rs"] < tel["r_up"]) & (tel["e_rs"] > tel["r_lo"])
        & (tel["e_rsn"] < tel["r_up_n"] + tol5)
        & (tel["e_rsn"] > tel["r_lo_n"] - tol5),
        dim=-1,
    )
    for i in range(1, nr_segs - 1):
        lt = split[:, i] < n
        dec = split[:, i] - 1
        b1_switch = dec == 0
        split_b1 = torch.where(b1_switch, n, dec)

        def set_margin(j):
            return torch.amax(
                torch.einsum("brj,bkj->brk", win["a_set"][:, j], p_out[..., :3])
                - win["b_set"][:, j][..., None],
                dim=1,
            )

        in0 = set_margin(i - 1) < acc + ps_out
        in1 = set_margin(i) < acc + ps_out
        lf = torch.amax(torch.where(~in1, steps, -1), dim=-1)
        in1 = in1 & (steps[None, :] > lf[:, None])
        dswitch = phis > win["phi_switch"][:, i, None] - 0.03
        cand = dswitch & in0 & in1 & in_rot
        exists = torch.any(cand, dim=-1)
        first = torch.argmax(cand.to(dtype), dim=-1)          # first True (0 if none)
        not_at_end = (path.sector + (i - 1)) < path.num_sectors
        trigger = (~lt) & (error_count == 0) & exists & not_at_end

        dp_i = win["dp_ref"][:, i, :3]
        pv = win["p_ref"][:, i, :3]
        corr = torch.sum((take(p_out, first[:, None])[:, 0, :3] - pv) * dp_i, dim=-1)
        pv_new = pv + corr[:, None] * dp_i
        path_corr = path_apply_via_correction(path, i, pv_new, corr)
        path = PathState(*(_sel(trigger, a, b) for a, b in zip(path_corr, path)))

        new_split_i = first - 1
        b2_switch = new_split_i == 0
        split_val = torch.where(
            lt, split_b1, torch.where(trigger, new_split_i, split[:, i])
        ).to(torch.int32)
        switch = switch | (lt & b1_switch) | (trigger & b2_switch)
        split[:, i] = split_val

    split_shifted = torch.cat(
        [split[:, :1], split[:, 2:], torch.full_like(split[:, :1], n)], dim=1
    )
    split = _sel(switch, split_shifted, split)
    for i in range(1, nr_segs):
        fix = split[:, i] <= split[:, i - 1]
        split[:, i] = torch.where(
            fix, torch.clamp(split[:, i - 1] + 1, max=n), split[:, i]
        ).to(torch.int32)

    # 10) carry update
    carry_new = MPCCarry(
        path=path,
        split_idx=split,
        switch=switch,
        pr_ref=pr_ref_new,
        iw_ref=iw_ref_new,
        phi_current=phis[:, 1],
        dphi_current=dphis[:, 1],
        slacks0=carry.slacks0 + traj_new["dslacks"],
        x_prev=_sel(success | reanchor, sol.x,
                    _sel(carry.has_prev, x_warm, carry.x_prev)),
        has_prev=carry.has_prev | success,
        error_count=error_count,
        prev_q=_sel(success, traj_new["q"], carry.prev_q),
        prev_dq=_sel(success, traj_new["dq"], carry.prev_dq),
        prev_ddq=_sel(success, traj_new["ddq"], carry.prev_ddq),
        prev_u=_sel(success, traj_new["u"], carry.prev_u),
        prev_p=_sel(success, traj_new["p"], carry.prev_p),
        prev_v=_sel(success, traj_new["v"], carry.prev_v),
        prev_pslacks=_sel(success, traj_new["pslacks"], carry.prev_pslacks),
    )

    outputs = {
        "q": q_out,
        "dq": dq_out,
        "ddq": ddq_out,
        "dddq": u_out,
        "p": p_out,
        "v": v_out,
        "phi": phis,
        "dphi": dphis,
        "p_ref": tel["p_d"],
        "e_p": tel["e_p"],
        "e_r": tel["e_r"],
        "e_rs": tel["e_rs"],
        "success": success,
        "cost": sol.cost,
        "viol": sol.viol,
        "sqp_iters": sol.iters,
        "switched": path.switched,
        "sector": path.sector,
        "phi_max": path.phi_max,
    }
    return carry_new, outputs
