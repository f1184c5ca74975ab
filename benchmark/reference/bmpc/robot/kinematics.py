"""Kinematics of the KUKA iiwa14 and the Kinova Gen3
(port of ``boundplanner_tpu/robot/kinematics.py``).

The URDF chain constants are copied from the JAX package (they *are* the
robot; importing that module would pull in jax). ``Chain`` holds them as
registered buffers so ``.to(device, dtype)`` moves them with the model.
Every function takes ``q`` with arbitrary leading batch dimensions
``(..., 7)`` and is safe under ``torch.func.vmap``/``jacfwd``.

The frame Jacobian follows Pinocchio's LOCAL_WORLD_ALIGNED convention:
column i is ``[z_i x (p_ee - p_i); z_i]``; its time derivative is a jvp
of the Jacobian map (``djacobian_fk``). Every function takes the chain:
unlike the JAX package, whose ``djacobian_fk``/``velocity_ee``/
``omega_ee`` always use the iiwa14 chain, the gen3 gets its own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..utils.so3 import matrix_to_rotvec

NUM_JOINTS = 7

_PI = np.pi
_HPI = np.pi / 2.0

# iiwa14 (`iiwa.urdf:25-143`): (xyz, rpy) of each joint's fixed placement
_JOINT_XYZ = np.array(
    [
        [0.0, 0.0, 0.1525],
        [0.0, 0.0, 0.2075],
        [0.0, 0.2325, 0.0],
        [0.0, 0.0, 0.1875],
        [0.0, 0.2125, 0.0],
        [0.0, 0.0, 0.1875],
        [0.0, 0.0796, 0.0],
    ]
)
_JOINT_RPY = np.array(
    [
        [0.0, 0.0, 0.0],
        [_HPI, 0.0, _PI],
        [_HPI, 0.0, _PI],
        [_HPI, 0.0, 0.0],
        [-_HPI, _PI, 0.0],
        [_HPI, 0.0, 0.0],
        [-_HPI, _PI, 0.0],
    ]
)
_EE_XYZ = np.array([0.0, 0.0, 0.21])
_EE_RPY = np.array([0.0, -1.575, -1.575])
_LINK4_COL_XYZ = np.array([0.0, 0.3, 0.0])
_EE_COL_XYZ = np.array([0.0, 0.0, 0.13])


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


class RobotChain:
    """Static chain description (float64 numpy constants)."""

    def __init__(self, joint_xyz, joint_rpy, ee_xyz, ee_rpy,
                 link4_col_xyz, ee_col_xyz, name="iiwa14"):
        self.name = name
        self.joint_xyz = np.asarray(joint_xyz, dtype=np.float64)
        self.joint_r = np.stack([_rpy_to_matrix(np.asarray(r)) for r in joint_rpy])
        self.ee_xyz = np.asarray(ee_xyz, dtype=np.float64)
        self.ee_r = _rpy_to_matrix(np.asarray(ee_rpy, dtype=np.float64))
        self.link4_col_xyz = np.asarray(link4_col_xyz, dtype=np.float64)
        self.ee_col_xyz = np.asarray(ee_col_xyz, dtype=np.float64)


IIWA14_CHAIN = RobotChain(
    _JOINT_XYZ, _JOINT_RPY, _EE_XYZ, _EE_RPY, _LINK4_COL_XYZ, _EE_COL_XYZ,
    name="iiwa14",
)


@functools.lru_cache(maxsize=None)
def gen3_chain() -> RobotChain:
    """Kinova Gen3 chain (`gen3_arm.urdf:27-137`)."""
    return RobotChain(
        joint_xyz=[
            [0.0, 0.0, 0.15643],
            [0.0, 0.005375, -0.12838],
            [0.0, -0.21038, -0.006375],
            [0.0, 0.006375, -0.21038],
            [0.0, -0.20843, -0.006375],
            [0.0, 0.00017505, -0.10593],
            [0.0, -0.10593, -0.00017505],
        ],
        joint_rpy=[
            [np.pi, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
        ],
        ee_xyz=[0.0, 0.0, -0.20],
        ee_rpy=[0.0, 1.570796326794895, 1.570796326794895],
        link4_col_xyz=[0.0, -0.1, 0.0],
        ee_col_xyz=[0.0, 0.0, -0.13],
        name="gen3",
    )


def chain_by_name(name: str | None) -> RobotChain:
    """Resolve a config robot name to its chain constants."""
    if name in (None, "iiwa14"):
        return IIWA14_CHAIN
    if name == "gen3":
        return gen3_chain()
    raise ValueError(f"unknown robot {name!r} (expected 'iiwa14' or 'gen3')")


class Chain(nn.Module):
    """A robot chain's constants as buffers (float64 until ``.to()``)."""

    def __init__(self, robot: str | None = "iiwa14"):
        super().__init__()
        c = chain_by_name(robot)
        self.name = c.name
        for key in ("joint_xyz", "joint_r", "ee_xyz", "ee_r",
                    "link4_col_xyz", "ee_col_xyz"):
            self.register_buffer(key, torch.as_tensor(getattr(c, key)))


def fk_frames(q, chain: Chain):
    """World placements of the 7 joint frames, the EE and the collision
    frames. Returns ``r`` (..., 7, 3, 3), ``p`` (..., 7, 3), ``r_ee``
    (..., 3, 3), ``p_ee`` (..., 3) and ``p_col`` (..., 7, 3): joints 3..7,
    link4_col, ee_col (ordering of ref `RobotModel.py:27-35`)."""
    rs, ps = [], []
    r_cur = None
    p_cur = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    for i in range(NUM_JOINTS):
        if r_cur is None:                      # world frame: identity
            p_cur = p_cur + chain.joint_xyz[0]
            a = chain.joint_r[0].expand(q.shape[:-1] + (3, 3))
        else:
            p_cur = p_cur + r_cur @ chain.joint_xyz[i]
            a = r_cur @ chain.joint_r[i]
        c = torch.cos(q[..., i])[..., None]
        s = torch.sin(q[..., i])[..., None]
        a0, a1, a2 = a[..., :, 0], a[..., :, 1], a[..., :, 2]
        r_cur = torch.stack([c * a0 + s * a1, c * a1 - s * a0, a2], dim=-1)
        rs.append(r_cur)
        ps.append(p_cur)
    r = torch.stack(rs, dim=-3)
    p = torch.stack(ps, dim=-2)
    r6 = rs[6]
    r_ee = r6 @ chain.ee_r
    p_ee = ps[6] + r6 @ chain.ee_xyz
    p_link4_col = ps[3] + rs[3] @ chain.link4_col_xyz
    p_ee_col = ps[6] + r6 @ chain.ee_col_xyz
    p_col = torch.cat(
        [p[..., 2:7, :], p_link4_col[..., None, :], p_ee_col[..., None, :]], dim=-2
    )
    return {"r": r, "p": p, "r_ee": r_ee, "p_ee": p_ee, "p_col": p_col}


def fk_pose(q, chain: Chain):
    """6-vector [position; rotation vector] of the EE."""
    f = fk_frames(q, chain)
    return torch.cat([f["p_ee"], matrix_to_rotvec(f["r_ee"])], dim=-1)


def fk_pos_col_all(q, chain: Chain):
    """All 7 collision-frame positions, (..., 7, 3)."""
    return fk_frames(q, chain)["p_col"]


def jacobian_of_frames(f):
    """The EE Jacobian from already evaluated ``fk_frames``."""
    z = f["r"][..., :, :, 2]                      # (..., 7, 3) world joint axes
    dp = f["p_ee"][..., None, :] - f["p"]         # (..., 7, 3)
    jv = torch.linalg.cross(z, dp, dim=-1)
    return torch.cat([jv.transpose(-1, -2), z.transpose(-1, -2)], dim=-2)


def jacobian_fk(q, chain: Chain):
    """(..., 6, 7) LOCAL_WORLD_ALIGNED EE Jacobian: rows [linear; angular]."""
    return jacobian_of_frames(fk_frames(q, chain))


def fk_ee_htm(q, chain: Chain):
    """(..., 4, 4) homogeneous transform of the end effector."""
    f = fk_frames(q, chain)
    top = torch.cat([f["r_ee"], f["p_ee"][..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def fk_pos(q, chain: Chain):
    """(..., 3) end-effector position."""
    return fk_frames(q, chain)["p_ee"]


def fk_pos_col(q, i: int, chain: Chain):
    """(..., 3) position of collision frame i (static index)."""
    return fk_frames(q, chain)["p_col"][..., i, :]


def jacobian_col(q, i: int, chain: Chain):
    """3x7 positional Jacobian of collision frame i at one q (7,), by
    forward-mode AD."""
    return torch.func.jacfwd(lambda qq: fk_pos_col(qq, i, chain))(q)


def djacobian_fk(q, dq, chain: Chain):
    """(..., 6, 7) time derivative of the EE Jacobian, dJ/dt = (dJ/dq) dq,
    exactly by a jvp. Takes the robot's own chain (the JAX package's
    version always differentiates the iiwa14's)."""
    dj = torch.func.jvp(lambda qq: jacobian_fk(qq, chain), (q,), (dq,))[1]
    # the tangent of a 0-d tensor and a Python float comes out in float64
    return dj.to(q.dtype)


def velocity_ee(q, dq, chain: Chain):
    """(..., 3) Cartesian EE velocity."""
    return (jacobian_fk(q, chain) @ dq[..., None])[..., :3, 0]


def omega_ee(q, dq, chain: Chain):
    """(..., 3) EE angular velocity."""
    return (jacobian_fk(q, chain) @ dq[..., None])[..., 3:, 0]


def forward_kinematics(q, dq, chain: Chain):
    """(pose6, J, dJ) of the EE."""
    return fk_pose(q, chain), jacobian_fk(q, chain), djacobian_fk(q, dq, chain)
