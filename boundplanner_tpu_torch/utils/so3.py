"""SO(3) utilities (port of ``boundplanner_tpu/utils/so3.py``).

Every function takes arbitrary leading batch dimensions (``(..., 3)``
vectors, ``(..., 3, 3)`` matrices) and is safe under ``torch.func.vmap``
and forward-mode AD: fixed shapes, smooth ``where`` guards, no host syncs.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def skew(w):
    """3-vector -> skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _eye3(ref):
    return torch.eye(3, dtype=ref.dtype, device=ref.device)


def rodrigues(axis, angle):
    """Rotation matrix from a unit axis and an angle."""
    omega = skew(axis)
    angle = torch.as_tensor(angle, dtype=omega.dtype, device=omega.device)
    s = torch.sin(angle)[..., None, None]
    c = (1.0 - torch.cos(angle))[..., None, None]
    return _eye3(omega) + s * omega + c * (omega @ omega)


def rotvec_to_matrix(rv):
    """exp: rotation vector -> rotation matrix (Taylor-guarded at 0)."""
    theta2 = _dot(rv, rv)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    omega = skew(rv)
    return _eye3(rv) + a[..., None, None] * omega + b[..., None, None] * (omega @ omega)


def matrix_to_quat(r):
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0
    (branch-free Shepperd: all four candidates, best one selected)."""
    t = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    d0, d1, d2 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    qw = torch.stack(
        [1.0 + t, 1.0 + 2.0 * d0 - t, 1.0 + 2.0 * d1 - t, 1.0 + 2.0 * d2 - t],
        dim=-1,
    )
    r01, r02, r10 = r[..., 0, 1], r[..., 0, 2], r[..., 1, 0]
    r12, r20, r21 = r[..., 1, 2], r[..., 2, 0], r[..., 2, 1]
    c0 = torch.stack([qw[..., 0], r21 - r12, r02 - r20, r10 - r01], dim=-1)
    c1 = torch.stack([r21 - r12, qw[..., 1], r10 + r01, r02 + r20], dim=-1)
    c2 = torch.stack([r02 - r20, r10 + r01, qw[..., 2], r21 + r12], dim=-1)
    c3 = torch.stack([r10 - r01, r02 + r20, r21 + r12, qw[..., 3]], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)          # (..., 4, 4)
    idx = torch.argmax(qw, dim=-1)                          # first maximum
    q = torch.take_along_dim(cands, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_to_rotvec(q):
    """Unit quaternion (w >= 0) -> rotation vector, |angle| <= pi."""
    w = q[..., 0]
    v = q[..., 1:]
    n = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    small = n < 1e-8
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=1e-12), angle / torch.clamp(n, min=1e-12)
    )
    return scale[..., None] * v


def matrix_to_rotvec(r):
    """log: rotation matrix -> rotation vector with angle in [0, pi]."""
    return quat_to_rotvec(matrix_to_quat(r))


def matrix_to_euler_zyx(r):
    """Extrinsic z-y-x Euler angles [alpha, beta, gamma] (scipy "zyx")."""
    sb = torch.clamp(r[..., 0, 2], -1.0, 1.0)
    beta = torch.asin(sb)
    degenerate = torch.abs(sb) > 1.0 - 1e-9
    alpha = torch.where(
        degenerate,
        torch.atan2(r[..., 1, 0], r[..., 1, 1]),
        torch.atan2(-r[..., 0, 1], r[..., 0, 0]),
    )
    gamma = torch.where(
        degenerate, torch.zeros_like(sb), torch.atan2(-r[..., 1, 2], r[..., 2, 2])
    )
    return torch.stack([alpha, beta, gamma], dim=-1)


def _jac_coeff(theta2):
    """1/t^2 - (1+cos t)/(2 t sin t) with a Taylor guard near 0."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-6
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    direct = 1.0 / theta2 - (1.0 + torch.cos(theta_safe)) / (
        2.0 * theta_safe * torch.sin(theta_safe)
    )
    series = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    return torch.where(small, series, direct)


def jac_so3_inv_right(axis):
    """Inverse right Jacobian of SO(3) at rotation vector ``axis``."""
    omega = skew(axis)
    c = _jac_coeff(_dot(axis, axis))[..., None, None]
    return _eye3(axis) + 0.5 * omega + c * (omega @ omega)


def jac_so3_inv_left(axis):
    """Inverse left Jacobian of SO(3)."""
    omega = skew(axis)
    c = _jac_coeff(_dot(axis, axis))[..., None, None]
    return _eye3(axis) - 0.5 * omega + c * (omega @ omega)


def gram_schmidt(v, b):
    """Remove the projection of ``b`` onto ``v``."""
    return b - _dot(v, b)[..., None] * v


def normalize(v, eps=1e-12):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)
