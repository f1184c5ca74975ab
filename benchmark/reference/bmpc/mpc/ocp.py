"""The BoundMPC optimal control problem condensed onto the jerk sequence
(port of ``boundplanner_tpu/mpc/ocp.py``).

Decision vector (n = 15 -> 136 entries)::

    x = [u_1..u_{N-1} (98) | dslacks (6) | rs0 (1) | drs (N) | ps0 (1) | dps (N)]

As in the JAX package, the functions here evaluate ONE scene (``x`` is
(nx,), ``params`` leaves carry no scene axis); callers batch scenes and
line-search candidates with ``torch.func.vmap``. The per-step pieces are
vmapped over the horizon inside. ``st`` is the model's
`ocp_struct.OCPStruct`: it carries the chain constants, limits and
static sensitivities on the working device and dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from ..config import MPCParams, MPC_SET_ROWS, NUM_LINK_SETS
from ..robot import kinematics as kin
from ..path import ref_fns

NJ = 7
N_Z = 61


def n_vars(n: int) -> int:
    return NJ * (n - 1) + 6 + 1 + n + 1 + n


class Decision(NamedTuple):
    """The decision vector's parts with the slack trajectories integrated."""

    u: torch.Tensor        # (N, 7) full jerk sequence (u[0] = measured jerk)
    dslacks: torch.Tensor  # (6,)
    rslacks: torch.Tensor  # (N,)
    drs: torch.Tensor      # (N,)
    pslacks: torch.Tensor  # (N,)
    dps: torch.Tensor      # (N,)


def unpack(x, u0, n: int):
    """Split the condensed decision vector."""
    u_free = x[: NJ * (n - 1)].reshape(n - 1, NJ)
    u = torch.cat([u0[None, :], u_free], dim=0)
    o = NJ * (n - 1)
    dslacks = x[o : o + 6]
    rs0 = x[o + 6]
    drs = x[o + 7 : o + 7 + n]
    ps0 = x[o + 7 + n]
    dps = x[o + 8 + n : o + 8 + 2 * n]
    return u, dslacks, rs0, drs, ps0, dps


def slack_trajectories(rs0, drs, ps0, dps, dt):
    """Trapezoidal integration of the slack rates."""
    zero = torch.zeros_like(drs[:1])
    incr_r = 0.5 * dt * (drs[:-1] + drs[1:])
    rslacks = rs0 + torch.cat([zero, torch.cumsum(incr_r, dim=0)])
    incr_p = 0.5 * dt * (dps[:-1] + dps[1:])
    pslacks = ps0 + torch.cat([zero, torch.cumsum(incr_p, dim=0)])
    return rslacks, pslacks


@functools.lru_cache(maxsize=None)
def jerk_chain_profiles(n: int, dt: float):
    """Scalar impulse responses of the jerk-spline chain (numpy, (n, n)
    each for q/dq/ddq)."""
    cq = np.zeros((n, n))
    cdq = np.zeros((n, n))
    cddq = np.zeros((n, n))
    for m in range(n):
        u = np.zeros(n)
        u[m] = 1.0
        q = dq = ddq = 0.0
        for k in range(n - 1):
            q, dq, ddq = (
                q + dt * dq + dt**2 / 2 * ddq + dt**3 / 8 * u[k] + dt**3 / 24 * u[k + 1],
                dq + dt * ddq + dt**2 / 3 * u[k] + dt**2 / 6 * u[k + 1],
                ddq + dt / 2 * (u[k] + u[k + 1]),
            )
            cq[k + 1, m] = q
            cdq[k + 1, m] = dq
            cddq[k + 1, m] = ddq
    return cq, cdq, cddq


def rollout_joints(u, q0, dq0, ddq0, dt):
    """Joint-space rollout of the jerk-spline chain (the reference dynamics,
    a fixed-trip loop where JAX scans)."""
    q, dq, ddq = q0, dq0, ddq0
    qs, dqs, ddqs = [q0], [dq0], [ddq0]
    for k in range(u.shape[0] - 1):
        u_k, u_k1 = u[k], u[k + 1]
        q, dq, ddq = (
            q + dt * dq + dt**2 / 2.0 * ddq + dt**3 / 8.0 * u_k + dt**3 / 24.0 * u_k1,
            dq + dt * ddq + dt**2 / 3.0 * u_k + dt**2 / 6.0 * u_k1,
            ddq + dt / 2.0 * (u_k + u_k1),
        )
        qs.append(q)
        dqs.append(dq)
        ddqs.append(ddq)
    return torch.stack(qs), torch.stack(dqs), torch.stack(ddqs)


def rollout_cartesian(q, dq, p0, v0, dt, chain):
    """Pose/twist trajectories: p_pos = fk(q), v = J(q) dq, integrated omega
    by trapezoid."""
    f = kin.fk_frames(q[1:], chain)
    jacs = kin.jacobian_of_frames(f)                         # (N-1, 6, 7)
    v_rest = (jacs @ dq[1:, :, None])[..., 0]
    v = torch.cat([v0[None], v_rest])
    p_pos = torch.cat([p0[None, :3], f["p_ee"]])
    omega = v[:, 3:]
    incr = 0.5 * dt * (omega[:-1] + omega[1:])
    iw = p0[3:] + torch.cat([torch.zeros_like(incr[:1]), torch.cumsum(incr, dim=0)])
    return torch.cat([p_pos, iw], dim=1), v


def rollout(x, params, cfg: MPCParams, st):
    n = cfg.n
    u, dslacks, rs0, drs, ps0, dps = unpack(x, params["u0"], n)
    q, dq, ddq = rollout_joints(u, params["q0"], params["dq0"], params["ddq0"], cfg.dt)
    p, v = rollout_cartesian(q, dq, params["p0"], params["v0"], cfg.dt, st.chain)
    rslacks, pslacks = slack_trajectories(rs0, drs, ps0, dps, cfg.dt)
    return {
        "u": u, "q": q, "dq": dq, "ddq": ddq, "p": p, "v": v,
        "dslacks": dslacks, "rslacks": rslacks, "drs": drs,
        "pslacks": pslacks, "dps": dps,
    }


# Per-step local inputs z (dim 61):
#   [ q(7) | dq(7) | u(7) | p(6) | v(6) | rs | drs | ps | dps | dslacks(6) |
#     p_col (6x3 flat) ]


def pack_z(q_k, dq_k, u_k, p_k, v_k, rs_k, drs_k, ps_k, dps_k, dslacks, p_col_k):
    """Pack the local inputs; any leading dims (steps)."""
    return torch.cat(
        [
            q_k, dq_k, u_k, p_k, v_k,
            rs_k[..., None], drs_k[..., None], ps_k[..., None], dps_k[..., None],
            dslacks, p_col_k.flatten(-2),
        ],
        dim=-1,
    )


def unpack_z(z):
    return {
        "q": z[0:7],
        "dq": z[7:14],
        "u": z[14:21],
        "p": z[21:27],
        "v": z[27:33],
        "rs": z[33],
        "drs": z[34],
        "ps": z[35],
        "dps": z[36],
        "dslacks": z[37:43],
        "p_col": z[43:61].reshape(NUM_LINK_SETS, 3),
    }


_WIN_KEYS = ("p_ref", "dp_ref", "dp_normed", "phi_switch", "bp1", "bp2", "br1",
             "br2", "e_r_bound", "a_set", "b_set", "v1", "v2", "v3")


def _ref_err_of_z(k, zd, params, n: int, nr_segs: int):
    win = {key: params[key] for key in _WIN_KEYS}
    ref = ref_fns.reference_function(
        win, params["split_idx"], k, zd["p"], zd["v"], n, nr_segs
    )
    err = ref_fns.error_function(
        ref, params, params["split_idx"], k, zd["p"], zd["v"],
        params["p0"][3:], n, nr_segs,
    )
    return ref, err


def _residual_nl(ref, err, v, params):
    """The 26 (p, v)-nonlinear residual rows of a step (shared with
    `ocp_jac._step_nl`, same expression order)."""
    w = params["weights"]
    phi, dphi = ref["phi"], ref["dphi"]
    sigm = 1.0 / (1.0 + torch.exp(-60.0 * (phi - (params["phi_max"] - 0.05))))
    v_orth = v - dphi * ref["dp_d"]
    one_norm = ref_fns.approx_one_norm(params["x_phi_d"][0] - phi)
    return [
        sigm * err["e_r"],
        sigm * err["e_p"],
        torch.sqrt(w[1]) * err["e_r_par"],
        torch.sqrt(w[2]) * v_orth[:3],
        torch.sqrt(w[3]) * v_orth[3:],
        (torch.sqrt(w[5]) * (params["x_phi_d"][1] - dphi))[None],
        torch.sqrt(w[4] * torch.maximum(one_norm, torch.zeros_like(one_norm)) + 1e-14)[None],
        torch.sqrt(w[0]) * err["e_p"],
        torch.sqrt(w[1] / 50.0) * err["e_r_orth1"],
        torch.sqrt(w[1] / 50.0) * err["e_r_orth2"],
    ]


def _band_projs(ref, err):
    proj1 = torch.sum(ref["br1_current"] * err["e_r_orth1"])
    proj_par = torch.sum(ref["dp_normed_d"] * err["e_r_par"])
    proj2 = torch.sum(ref["br2_current"] * err["e_r_orth2"])
    return torch.stack([proj1, proj_par, proj2])


def _step_local(k, z, params, cfg: MPCParams):
    """Residuals (40) and constraint rows (112) of horizon step k from the
    packed local inputs z. Row order: the 26 (p, v)-nonlinear residual rows
    first, then the 14 x-affine ones (matches `ocp_jac._step_nl`)."""
    n, nr_segs = cfg.n, cfg.nr_segs
    w = params["weights"]
    zd = unpack_z(z)
    slacks = params["slacks0"] + zd["dslacks"]
    ref, err = _ref_err_of_z(k, zd, params, n, nr_segs)

    r = torch.cat(
        _residual_nl(ref, err, zd["v"], params)
        + [
            torch.sqrt(w[6]) * zd["dq"][2:5],
            torch.sqrt(w[7]) * zd["u"],
            (torch.sqrt(w[9]) * zd["rs"])[None],
            (torch.sqrt(w[10]) * zd["drs"])[None],
            (torch.sqrt(w[9]) * zd["ps"])[None],
            (torch.sqrt(w[10]) * zd["dps"])[None],
        ]
    )

    projs = _band_projs(ref, err)
    link_rows = (
        torch.einsum("lri,li->lr", params["a_set_joints"], zd["p_col"])
        - params["b_set_joints"]
        - slacks[:NUM_LINK_SETS, None]
    )
    g = torch.cat(
        [
            ref["a_current"] @ zd["p"][:3] - ref["b_current"] - zd["ps"],
            projs - ref["r_bound_upper"] - zd["rs"],
            ref["r_bound_lower"] - projs - zd["rs"],
            link_rows.reshape(-1),
            (ref["phi"] - (ref["phi_end_seg"] + 0.005))[None],
        ]
    )
    return r, g


def _terminal_local(z, params, cfg: MPCParams):
    """Terminal set/rotation constraint rows (21) at k = N-1."""
    n, nr_segs = cfg.n, cfg.nr_segs
    kf = n - 1
    zd = unpack_z(z)
    slacks = params["slacks0"] + zd["dslacks"]
    ref_f, err_f = _ref_err_of_z(kf, zd, params, n, nr_segs)
    s_f = ref_fns.segment_index(kf, params["split_idx"], nr_segs)
    p_end = ref_fns._at(params["p_ref"], s_f + 1)[:3]
    bnew = ref_f["b_next"] - ref_f["a_next"] @ p_end
    anew = ref_f["a_next"] @ torch.stack(
        [ref_f["bp1_current"], ref_f["bp2_current"]], dim=1
    )
    z_proj = torch.stack(
        [
            torch.sum(ref_f["bp1_current"] * err_f["e_p"]),
            torch.sum(ref_f["bp2_current"] * err_f["e_p"]),
        ]
    )
    g_term_set = anew @ z_proj - bnew - slacks[-1]

    proj1n = torch.sum(ref_f["br1_next"] * err_f["e_r_orth1"])
    proj_parn = torch.sum(ref_f["dp_normed_n"] * err_f["e_r_par"])
    proj2n = torch.sum(ref_f["br2_next"] * err_f["e_r_orth2"])
    projs_n = torch.stack([proj1n, proj_parn, proj2n])
    g_term_rot_u = projs_n - ref_f["r_bound_upper_next"] - slacks[-1]
    g_term_rot_l = ref_f["r_bound_lower_next"] - projs_n - slacks[-1]
    return torch.cat([g_term_set, g_term_rot_u, g_term_rot_l])


def local_inputs(traj, n: int, chain):
    """Packed z vectors for steps k = 1..N-1: (N-1, N_Z)."""
    p_col = kin.fk_pos_col_all(traj["q"][1:], chain)[:, :NUM_LINK_SETS]
    dsl = traj["dslacks"].expand(n - 1, 6)
    return pack_z(
        traj["q"][1:], traj["dq"][1:], traj["u"][1:], traj["p"][1:],
        traj["v"][1:], traj["rslacks"][1:], traj["drs"][1:],
        traj["pslacks"][1:], traj["dps"][1:], dsl, p_col,
    )


def terminal_slack_rows(t):
    """Rows 0-3 and 5 of the 6 slack rows (the terminal residual leaves
    row 4 out), as slices: an index list would be copied from the host on
    every call, which a CUDA graph cannot hold."""
    return torch.cat([t[:4], t[5:6]])


def terminal_residuals(slacks, dslacks, v_last, w):
    return torch.cat(
        [
            torch.sqrt(w[8]) * terminal_slack_rows(slacks),
            torch.sqrt(w[10]) * dslacks,
            10.0 * v_last,  # sqrt(100)
        ]
    )


def evaluate(x, params, cfg: MPCParams, st):
    """Objective residuals (cost = sum r^2) and all inequality rows g <= 0
    of one scene, row order of the JAX ``evaluate``."""
    n = cfg.n
    traj = rollout(x, params, cfg, st)
    slacks = params["slacks0"] + traj["dslacks"]
    zs = local_inputs(traj, n, st.chain)
    ks = torch.arange(1, n, device=x.device)
    r_steps, g_steps = vmap(lambda k, z: _step_local(k, z, params, cfg))(ks, zs)
    r_term = terminal_residuals(slacks, traj["dslacks"], traj["v"][n - 1],
                                params["weights"])
    g_term = _terminal_local(zs[-1], params, cfg)
    residuals = torch.cat([r_steps.reshape(-1), r_term])
    constraints = torch.cat([g_steps.reshape(-1), g_term, st.tail_values(traj)])
    return residuals, constraints


def cost_residuals(x, params, cfg: MPCParams, st):
    return evaluate(x, params, cfg, st)[0]


def cost(x, params, cfg: MPCParams, st):
    r = cost_residuals(x, params, cfg, st)
    return torch.sum(r * r)


def constraints(x, params, cfg: MPCParams, st):
    return evaluate(x, params, cfg, st)[1]


def n_constraints(cfg: MPCParams) -> int:
    n = cfg.n
    per_step = MPC_SET_ROWS + 6 + NUM_LINK_SETS * MPC_SET_ROWS + 1
    return (
        (n - 1) * per_step
        + MPC_SET_ROWS
        + 6
        + (n - 1) * NJ * 6
        + (n - 1) * NJ * 2
        + (6 + 4 * n)
    )


def shift_warm_start(x, cfg: MPCParams):
    """Advance a previous decision vector (..., nx) one control period:
    jerk and slack-rate sequences shift left (last entry repeated),
    integrated slack offsets advance by one trapezoid increment."""
    n, dt = cfg.n, cfg.dt
    o = NJ * (n - 1)
    u = x[..., :o].reshape(x.shape[:-1] + (n - 1, NJ))
    u_s = torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2)
    dslacks = x[..., o : o + 6]
    rs0 = x[..., o + 6]
    drs = x[..., o + 7 : o + 7 + n]
    ps0 = x[..., o + 7 + n]
    dps = x[..., o + 8 + n : o + 8 + 2 * n]
    rs0_s = rs0 + 0.5 * dt * (drs[..., 0] + drs[..., 1])
    ps0_s = ps0 + 0.5 * dt * (dps[..., 0] + dps[..., 1])
    drs_s = torch.cat([drs[..., 1:], drs[..., -1:]], dim=-1)
    dps_s = torch.cat([dps[..., 1:], dps[..., -1:]], dim=-1)
    return torch.cat(
        [u_s.flatten(-2), dslacks, rs0_s[..., None], drs_s, ps0_s[..., None], dps_s],
        dim=-1,
    )
