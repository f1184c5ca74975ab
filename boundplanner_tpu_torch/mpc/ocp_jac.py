"""Structured chain-rule Jacobians of the condensed OCP
(port of the structured path of ``boundplanner_tpu/mpc/ocp_jac.py``).

q/dq/ddq/u and the slack trajectories are affine in x with static
sensitivity matrices (numpy, built once per (n, dt) and held as buffers
by `ocp_struct.OCPStruct`). The FK quantities are differentiated per step
with respect to q_k only (7 tangents), the reference/error math with
respect to the step's pose and twist (12 tangents), both by
``torch.func.jacfwd`` vmapped over the horizon. One scene per call, as in
the JAX package; callers vmap over scenes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import jacfwd, vmap

from boundplanner_tpu.config import MPCParams, MPC_SET_ROWS, NUM_LINK_SETS
from ..robot import kinematics as kin
from . import ocp

NJ = ocp.NJ


@functools.lru_cache(maxsize=None)
def _static_sensitivities(n: int, dt: float):
    """All constant sensitivity matrices for horizon length n (numpy):
    dq, ddq, dddq, du (n, NJ, nx); cq, cdq, cddq (n, n); w_trap (n, n-1);
    drs_traj, dps_traj, ddrs, ddps (n, nx); ddsl (6, nx)."""
    nx = ocp.n_vars(n)
    o = NJ * (n - 1)
    cq, cdq, cddq = ocp.jerk_chain_profiles(n, float(dt))

    dq_s = np.zeros((n, NJ, nx))
    ddq_s = np.zeros((n, NJ, nx))
    dddq_s = np.zeros((n, NJ, nx))
    du_s = np.zeros((n, NJ, nx))
    for k in range(n):
        for m in range(1, n):
            cols = NJ * (m - 1) + np.arange(NJ)
            dq_s[k, np.arange(NJ), cols] = cq[k, m]
            ddq_s[k, np.arange(NJ), cols] = cdq[k, m]
            dddq_s[k, np.arange(NJ), cols] = cddq[k, m]
        if k >= 1:
            du_s[k, np.arange(NJ), NJ * (k - 1) + np.arange(NJ)] = 1.0

    w_full = np.zeros((n, n))
    for k in range(1, n):
        w_full[k, 0] = 0.5 * dt
        w_full[k, k] = 0.5 * dt
        w_full[k, 1:k] = dt
    w_trap = w_full[:, 1:]

    drs_traj = np.zeros((n, nx))
    dps_traj = np.zeros((n, nx))
    ddrs = np.zeros((n, nx))
    ddps = np.zeros((n, nx))
    drs_traj[:, o + 6] = 1.0
    dps_traj[:, o + 7 + n] = 1.0
    for k in range(n):
        drs_traj[k, o + 7 : o + 7 + n] = w_full[k]
        dps_traj[k, o + 8 + n : o + 8 + 2 * n] = w_full[k]
        ddrs[k, o + 7 + k] = 1.0
        ddps[k, o + 8 + n + k] = 1.0
    ddsl = np.zeros((6, nx))
    ddsl[np.arange(6), o + np.arange(6)] = 1.0

    return {
        "dq": dq_s, "ddq": ddq_s, "dddq": dddq_s, "du": du_s,
        "cq": cq, "cdq": cdq, "cddq": cddq, "w_trap": w_trap,
        "drs_traj": drs_traj, "dps_traj": dps_traj,
        "ddrs": ddrs, "ddps": ddps, "ddsl": ddsl,
    }


@functools.lru_cache(maxsize=None)
def _static_bound_rows(n: int, dt: float):
    """Exact Jacobian of the variable-bound + slack rows (numpy)."""
    s = _static_sensitivities(n, dt)
    flat = lambda a: a.reshape(-1, a.shape[-1])
    jq = flat(s["dq"][1:])
    jdq = flat(s["ddq"][1:])
    jddq = flat(s["dddq"][1:])
    ju = flat(s["du"][1:])
    g_bounds = np.concatenate([jq, -jq, jdq, -jdq, jddq, -jddq, ju, -ju])
    g_slack = np.concatenate(
        [-s["ddsl"], -s["drs_traj"], -s["ddrs"], -s["dps_traj"], -s["ddps"]]
    )
    return np.concatenate([g_bounds, g_slack])


def _fk_bundle(q, dq, chain):
    """Per-step FK quantities whose q-derivatives the chain rule needs."""
    f = kin.fk_frames(q, chain)
    return (
        f["p_ee"],
        kin.jacobian_of_frames(f) @ dq,
        f["p_col"][:NUM_LINK_SETS],
    )


def _step_nl(k, p, v, params, cfg: MPCParams):
    """The (p, v)-dependent parts of `ocp._step_local`'s rows with the
    x-affine slack addends omitted: r_nl (26,), g_nl (22,)."""
    ref, err = ocp._ref_err_of_z(k, {"p": p, "v": v}, params, cfg.n, cfg.nr_segs)
    r_nl = torch.cat(ocp._residual_nl(ref, err, v, params))
    projs = ocp._band_projs(ref, err)
    g_nl = torch.cat(
        [
            ref["a_current"] @ p[:3] - ref["b_current"],
            projs - ref["r_bound_upper"],
            ref["r_bound_lower"] - projs,
            (ref["phi"] - (ref["phi_end_seg"] + 0.005))[None],
        ]
    )
    return r_nl, g_nl


def evaluate_with_jac_structured(x, params, cfg: MPCParams, st):
    """(r, g_full, J_r, J_g_runtime) of one scene: values identical to
    `ocp.evaluate`; Jacobians for the residuals and the RUNTIME constraint
    rows (the first ``st.m_run``). The static tail's Jacobian is applied
    structurally inside the QP (`ocp_struct`)."""
    if cfg.struct_link or not cfg.struct_tail:
        raise NotImplementedError("only the flat struct_tail layout is ported")
    n = cfg.n
    nx = ocp.n_vars(n)
    dtype = x.dtype
    w = params["weights"]
    chain = st.chain

    traj = ocp.rollout(x, params, cfg, st)
    zs = ocp.local_inputs(traj, n, chain)
    ks = torch.arange(1, n, device=x.device)

    r_steps, g_steps = vmap(lambda k, z: ocp._step_local(k, z, params, cfg))(ks, zs)

    # nonlinear-core Jacobians: 12 (p, v) tangents per step
    pv = torch.cat([traj["p"][1:], traj["v"][1:]], dim=-1)
    jr_pv, jg_pv = vmap(
        jacfwd(lambda k, pv_: _step_nl(k, pv_[:6], pv_[6:], params, cfg), argnums=1)
    )(ks, pv)                                   # (n-1, 26, 12), (n-1, 22, 12)
    # forward-mode tangents of 0-d tensor + Python float come out in
    # float64 (torch's wrapped-number promotion): cast back
    jr_pv, jg_pv = jr_pv.to(dtype), jg_pv.to(dtype)

    # FK derivative bundles: 7 tangents per step
    ap, hv, acol = vmap(jacfwd(lambda q, dq: _fk_bundle(q, dq, chain), argnums=0))(
        traj["q"][1:], traj["dq"][1:]
    )                                           # (n-1, 3, 7), (n-1, 6, 7), (n-1, 6, 3, 7)
    ap, hv, acol = ap.to(dtype), hv.to(dtype), acol.to(dtype)
    jacs = kin.jacobian_fk(traj["q"][1:], chain)  # (n-1, 6, 7)

    dq_r = st.sens_dq[1:]                        # (n-1, 7, nx)
    ddq_r = st.sens_ddq[1:]
    du_r = st.sens_du[1:]

    dv = torch.einsum("kij,kjx->kix", hv, dq_r) + torch.einsum(
        "kij,kjx->kix", jacs, ddq_r
    )
    diw = torch.einsum("kj,jax->kax", st.sens_w_trap[1:], dv[:, 3:, :])
    dp = torch.cat([torch.einsum("kij,kjx->kix", ap, dq_r), diw], dim=1)
    dpv = torch.cat([dp, dv], dim=1)            # (n-1, 12, nx)

    jr_nl = torch.einsum("krt,ktx->krx", jr_pv, dpv)
    jg_nl = torch.einsum("krt,ktx->krx", jg_pv, dpv)

    drs_traj = st.sens_drs_traj[1:]
    ddrs = st.sens_ddrs[1:]
    dps_traj = st.sens_dps_traj[1:]
    ddps = st.sens_ddps[1:]
    ddsl = st.sens_ddsl

    jr_steps = torch.cat(
        [
            jr_nl,
            torch.sqrt(w[6]) * ddq_r[:, 2:5, :],
            torch.sqrt(w[7]) * du_r,
            torch.sqrt(w[9]) * drs_traj[:, None, :],
            torch.sqrt(w[10]) * ddrs[:, None, :],
            torch.sqrt(w[9]) * dps_traj[:, None, :],
            torch.sqrt(w[10]) * ddps[:, None, :],
        ],
        dim=1,
    )

    jg_set = jg_nl[:, :15, :] - dps_traj[:, None, :]
    jg_band = jg_nl[:, 15:21, :] - drs_traj[:, None, :]
    ab = torch.einsum("lri,klij->klrj", params["a_set_joints"], acol).reshape(
        n - 1, NUM_LINK_SETS * MPC_SET_ROWS, NJ
    )
    ddsl_link = torch.repeat_interleave(ddsl[:NUM_LINK_SETS], MPC_SET_ROWS, dim=0)
    jg_link = torch.einsum("krj,kjx->krx", ab, dq_r) - ddsl_link[None]
    jg_steps = torch.cat([jg_set, jg_band, jg_link, jg_nl[:, 21:22, :]], dim=1)

    # terminal rows: 61-tangent local jacfwd at the last step
    g_term = ocp._terminal_local(zs[-1], params, cfg)
    jg_term_z = jacfwd(lambda zz: ocp._terminal_local(zz, params, cfg))(zs[-1]).to(dtype)
    acol_x_last = torch.einsum("lij,jx->lix", acol[-1], dq_r[-1])
    dz_last = torch.cat(
        [
            dq_r[-1], ddq_r[-1], du_r[-1], dp[-1], dv[-1],
            drs_traj[-1][None], ddrs[-1][None], dps_traj[-1][None],
            ddps[-1][None], ddsl,
            acol_x_last.reshape(NUM_LINK_SETS * 3, nx),
        ]
    )
    jg_term = jg_term_z @ dz_last

    slacks = params["slacks0"] + traj["dslacks"]
    r_term = ocp.terminal_residuals(slacks, traj["dslacks"], traj["v"][n - 1], w)
    jr_term = torch.cat(
        [
            torch.sqrt(w[8]) * ddsl[[0, 1, 2, 3, 5]],
            torch.sqrt(w[10]) * ddsl,
            10.0 * dv[-1],
        ]
    )

    residuals = torch.cat([r_steps.reshape(-1), r_term])
    j_res = torch.cat([jr_steps.reshape(-1, nx), jr_term])
    constraints = torch.cat([g_steps.reshape(-1), g_term, st.tail_values(traj)])
    j_run = torch.cat([jg_steps.reshape(-1, nx), jg_term])
    return residuals, constraints, j_res, j_run
