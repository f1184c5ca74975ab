"""Per-tick MPC parameter preparation (port of
``boundplanner_tpu/mpc/prep.py``). Batch-major: leading scene axis B,
window segments S where the JAX package vmapped over them."""

from __future__ import annotations

import torch

from boundplanner_tpu.config import NUM_LINK_SETS
from ..robot import kinematics as kin
from ..utils import so3
from ..planner.set_finder import ObstacleArrays, find_set_line


def integrate_rotation_reference(pr_ref, omega, phi0, phi1):
    """Rotate the reference rotvec by omega over [phi0, phi1]; any leading
    dims (pr_ref/omega (..., 3), phi0/phi1 (...))."""
    r0 = so3.rotvec_to_matrix(pr_ref)
    on = torch.linalg.vector_norm(omega, dim=-1)
    axis = omega / torch.clamp(on, min=1e-12)[..., None]
    dr = so3.rodrigues(axis, (phi1 - phi0) * on)
    r1 = torch.where((on > 1e-4)[..., None, None], dr @ r0, r0)
    return so3.matrix_to_rotvec(r1)


def compute_initial_rot_errors(pr, pr_ref, dp_normed, br1, br2):
    """Initial Lie-algebra orientation error and its zyx-Euler split in the
    (br2, path, br1) frame; any leading dims."""
    tauc = so3.rotvec_to_matrix(pr)
    taud = so3.rotvec_to_matrix(pr_ref)
    dtau_init = so3.matrix_to_rotvec(tauc @ taud.mT)
    r01 = torch.stack([br2, dp_normed, br1], dim=-1)    # columns
    dtau_01 = r01.mT @ so3.rotvec_to_matrix(dtau_init) @ r01
    eul = so3.matrix_to_euler_zyx(dtau_01)
    return (
        dtau_init,
        eul[..., 1:2] * dp_normed,
        eul[..., 0:1] * br1,
        eul[..., 2:3] * br2,
    )


def orientation_projection_vectors(dtau_init, dtau_par, dtau_orth1, dtau_orth2,
                                   dp_normed, br1, br2):
    """Dual-basis projection vectors v1/v2/v3 (B, S, 3) and the SO(3)
    inverse Jacobians jac_l, jac_r (B, 3, 3) of segment 0's error."""
    jac_r = so3.jac_so3_inv_right(dtau_init[:, 0])
    jac_l = so3.jac_so3_inv_left(dtau_init[:, 0])
    r_dtau0 = so3.rotvec_to_matrix(dtau_init[:, 0])[:, None]

    rest1 = r_dtau0 @ so3.rotvec_to_matrix(dtau_orth1).mT
    rest2 = rest1 @ so3.rotvec_to_matrix(dtau_par).mT
    jac_r1 = so3.jac_so3_inv_right(so3.matrix_to_rotvec(rest1))
    jac_r2 = so3.jac_so3_inv_right(so3.matrix_to_rotvec(rest2))
    w1 = (jac_r[:, None] @ br1[..., None])[..., 0]
    w2 = (jac_r1 @ dp_normed[..., None])[..., 0]
    w3 = (jac_r2 @ br2[..., None])[..., 0]
    m = torch.stack([w1, w2, w3], dim=-1)                # (B, S, 3, 3) columns
    gram = m.mT @ m
    # inv_ex: no singularity check, hence no device-to-host sync
    dual = m @ torch.linalg.inv_ex(gram)[0]
    return dual[..., 0], dual[..., 1], dual[..., 2], jac_l, jac_r


def link_collision_sets(q0, qf, obs: ObstacleArrays, st, e_max=0.7):
    """Per-tick convex sets around each link's motion segment: 6 sets per
    scene, rows shrunk by the link sphere radius. q0/qf (B, 7), obs leaves
    (B, M, ...); all B x 6 x M projections go through one call."""
    p0s = kin.fk_pos_col_all(q0, st.chain)[:, :NUM_LINK_SETS]
    p1s = kin.fk_pos_col_all(qf, st.chain)[:, :NUM_LINK_SETS]
    bsz, nl = p0s.shape[:2]
    per_link = ObstacleArrays(*(
        t[:, None].expand((bsz, nl) + t.shape[1:]).reshape((bsz * nl,) + t.shape[1:])
        for t in obs
    ))
    a, b, _ = find_set_line(p0s.reshape(-1, 3), p1s.reshape(-1, 3), per_link, e_max)
    a_j = a.reshape(bsz, nl, a.shape[-2], 3)
    b_j = b.reshape(bsz, nl, -1) - st.col_sizes[:NUM_LINK_SETS, None]
    return a_j, b_j


def shape_phi_weights(weights, phi_max, phi_current):
    """Desired-phi weight scaling and long-trajectory clamping; weights
    (B, 11), phi_max/phi_current (B,)."""
    x_phi_d0 = phi_max
    scaling = 1.0 / torch.clamp((phi_max - phi_current) ** 2, min=1e-12)
    scaling = torch.clamp(scaling, max=2.0)
    apply = (x_phi_d0 < 1.0) & (phi_max > 0.001)
    w4 = torch.where(apply, weights[:, 4] * scaling, weights[:, 4])
    weights = torch.cat([weights[:, :4], w4[:, None], weights[:, 5:]], dim=1)
    phi_max_c = torch.minimum(phi_current + 5.0, phi_max)
    zero = torch.zeros_like(phi_max)
    x_phi_d = torch.stack([torch.minimum(phi_current + 5.0, x_phi_d0), zero, zero], dim=1)
    return weights, x_phi_d, phi_max_c
