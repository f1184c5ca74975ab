"""Reference projection and error decomposition along the path
(port of ``boundplanner_tpu/path/ref_fns.py``).

Conventions as in the JAX package: every function works on ONE horizon
step of ONE scene (``win`` leaves are (nr_segs, ...), ``idx`` and the
segment indices are 0-d tensors); callers batch over steps and scenes with
``torch.func.vmap``, as the JAX package does with ``jax.vmap``.
"""

from __future__ import annotations

import torch


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _at(t, i):
    """t[i] for a 0-d index tensor (plain tensor indexing would read the
    index on the host, which ``vmap`` forbids)."""
    return t[i.reshape(1)][0]


def segment_index(idx, split_idx, nr_segs: int):
    """Active window segment for horizon step ``idx``: split thresholds passed."""
    return torch.sum((idx > split_idx[1 : nr_segs - 1]).long())


def terminal_segment_index(split_idx, n_horizon, nr_segs: int):
    """First window segment not active inside the horizon."""
    j = torch.full_like(split_idx[0], nr_segs - 1, dtype=torch.long)
    for i in range(nr_segs - 2, 0, -1):
        j = torch.where(split_idx[i] == n_horizon, torch.full_like(j, i), j)
    return j


def reference_function(win, split_idx, idx, p, v, n_horizon: int, nr_segs: int):
    """Pose reference at horizon step ``idx`` (ref
    `bound_mpc_functions.py:85-253`)."""
    s = segment_index(idx, split_idx, nr_segs)
    sn = s + 1

    p_ref = win["p_ref"]
    dp_ref = win["dp_ref"]
    phi_switch = win["phi_switch"]

    dp_d = _at(dp_ref, s)
    dp_dn = _at(dp_ref, sn)
    p_ref_c = _at(p_ref, s)
    p_ref_n = _at(p_ref, sn)
    phi_start = _at(phi_switch, s)

    phi_loc = _dot(p[:3] - p_ref_c[:3], dp_d[:3])
    phi_next_loc = _dot(p[:3] - p_ref_n[:3], dp_dn[:3])
    dphi = _dot(v[:3], dp_d[:3])

    p_d = torch.cat(
        [p_ref_c[:3] + dp_d[:3] * phi_loc, p_ref_c[3:] + dp_d[3:] * phi_loc]
    )
    p_dr_next = p_ref_n[3:] + dp_dn[3:] * phi_next_loc
    phi = phi_loc + phi_start

    e_r_bound = win["e_r_bound"]
    j = terminal_segment_index(split_idx, n_horizon, nr_segs)

    return {
        "p_d": p_d,
        "p_dr_next": p_dr_next,
        "p_r_omega0": p_ref_c[3:],
        "dp_d": dp_d,
        "ddp_d": torch.zeros_like(dp_d),
        "bp1_current": _at(win["bp1"], s),
        "bp2_current": _at(win["bp2"], s),
        "br1_current": _at(win["br1"], s),
        "br2_current": _at(win["br2"], s),
        "br1_next": _at(win["br1"], sn),
        "br2_next": _at(win["br2"], sn),
        "dp_normed_d": _at(win["dp_normed"], s),
        "dp_normed_n": _at(win["dp_normed"], sn),
        "v1_current": _at(win["v1"], s),
        "v2_current": _at(win["v2"], s),
        "v3_current": _at(win["v3"], s),
        "v1_next": _at(win["v1"], sn),
        "v2_next": _at(win["v2"], sn),
        "v3_next": _at(win["v3"], sn),
        "r_bound_lower": _at(e_r_bound, s)[3:],
        "r_bound_upper": _at(e_r_bound, s)[:3],
        "r_bound_lower_next": _at(e_r_bound, sn)[3:],
        "r_bound_upper_next": _at(e_r_bound, sn)[:3],
        "a_current": _at(win["a_set"], s),
        "b_current": _at(win["b_set"], s),
        "a_next": _at(win["a_set"], j),
        "b_next": _at(win["b_set"], j),
        "phi_end_seg": _at(phi_switch, j),
        "phi": phi,
        "dphi": dphi,
        "phi_switchk": phi_start,
        "seg": s,
        "seg_next_term": j,
    }


def compute_position_error(p3, v3, p_d3, dp_d3, dphi):
    """Position error split parallel/orthogonal to the path."""
    e = p3 - p_d3
    e_par = _dot(dp_d3, e) * dp_d3
    e_orth = e - e_par
    de = v3 - dp_d3 * dphi
    de_par = _dot(dp_d3, de) * dp_d3
    de_orth = de - de_par
    return e_par, e_orth, de_par, de_orth, e, de


def error_function(ref, params, split_idx, idx, p, v, i_omega_0,
                   n_horizon: int, nr_segs: int):
    """Decomposed pose errors at one horizon step (ref
    `bound_mpc_functions.py:256-390`)."""
    s = segment_index(idx, split_idx, nr_segs)
    sn = s + 1
    j = ref["seg_next_term"]

    e_p_par, e_p_orth, de_p_par, de_p_orth, e_p, de_p = compute_position_error(
        p[:3], v[:3], ref["p_d"][:3], ref["dp_d"][:3], ref["dphi"]
    )

    i_w_ref_0 = torch.where(
        idx <= split_idx[1], params["i_omega_ref_0"], ref["p_r_omega0"]
    )

    jac_l = params["jac_dtau_l"]
    jac_r = params["jac_dtau_r"]
    e_init = _at(params["dtau_init"], s)
    e_initn = _at(params["dtau_init"], j)

    dw = jac_l @ (p[3:] - i_omega_0)
    e_r = e_init + dw - jac_r @ (ref["p_d"][3:] - i_w_ref_0)
    e_rn = e_initn + dw - jac_r @ (ref["p_dr_next"] - i_w_ref_0)
    de_r = jac_l @ v[3:] - jac_r @ (ref["dp_d"][3:] * ref["dphi"])

    d = e_r - e_init
    dn = e_rn - e_initn
    e_r_orth1 = _at(params["dtau_init_orth1"], s) + _dot(d, ref["v1_current"]) * ref["br1_current"]
    e_r_par = _at(params["dtau_init_par"], s) + _dot(d, ref["v2_current"]) * ref["dp_normed_d"]
    e_r_orth2 = _at(params["dtau_init_orth2"], s) + _dot(d, ref["v3_current"]) * ref["br2_current"]
    e_r_orth1n = _at(params["dtau_init_orth1"], sn) + _dot(dn, ref["v1_next"]) * ref["br1_next"]
    e_r_parn = _at(params["dtau_init_par"], sn) + _dot(dn, ref["v2_next"]) * ref["dp_normed_n"]
    e_r_orth2n = _at(params["dtau_init_orth2"], sn) + _dot(dn, ref["v3_next"]) * ref["br2_next"]

    return {
        "e_p_par": e_p_par,
        "e_p_orth": e_p_orth,
        "de_p_par": de_p_par,
        "de_p_orth": de_p_orth,
        "e_p": e_p,
        "de_p": de_p,
        "e_r": e_r,
        "de_r": de_r,
        "e_r_par": e_r_par,
        "e_r_orth1": e_r_orth1,
        "e_r_orth2": e_r_orth2,
        "e_r_parn": e_r_parn,
        "e_r_orth1n": e_r_orth1n,
        "e_r_orth2n": e_r_orth2n,
    }


def approx_one_norm(x, alpha=0.1):
    """Smooth |x|."""
    return torch.sqrt(torch.sum(x * x) + alpha**2) - alpha


def decompose_orthogonal_error(e_orth, v1, v2):
    """Coordinates of an orthogonal error in the (v1, v2) plane."""
    return torch.stack([_dot(e_orth, v1), _dot(e_orth, v2)], dim=-1)
