"""Robot limits, collision geometry, the ``RobotModel`` facade and its
inverse kinematics (port of ``boundplanner_tpu/robot/model.py``).

``RobotModel(robot, device=, dtype=)`` takes and returns numpy; its
kinematics run as tensors on ``device`` (the card by default). Inverse
kinematics is a bounded damped Gauss-Newton iteration on
``|fk_pos(q) - pd|^2 + |R(q) Rd^T - I|_F^2`` with a fixed trip count.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import DEFAULT_DEVICE, checked_device
from . import kinematics as kin

Q_LIM_UPPER = np.array(
    [
        2.9670597283903604,
        2.0943951023931953,
        2.9670597283903604,
        2.0943951023931953,
        2.9670597283903604,
        2.0943951023931953,
        3.0543261909900763,
    ]
)
Q_LIM_LOWER = -Q_LIM_UPPER
DQ_LIM = 10.0 * np.ones(7)
TAU_LIM_UPPER = np.array([320.0, 320.0, 176.0, 176.0, 110.0, 40.0, 40.0])
TAU_LIM_LOWER = -TAU_LIM_UPPER
U_MAX = 35.0
U_MIN = -35.0
DDQ_LIM = 5.0

COL_JOINT_SIZES = np.array([0.09, 0.12, 0.09, 0.10, 0.07, 0.09, 0.075])

GEN3_Q_LIM_UPPER = np.array([np.inf, 2.24, np.inf, 2.57, np.inf, 2.09, np.inf])
GEN3_DQ_LIM = np.array([1.3963, 1.3963, 1.3963, 1.3963, 1.2218, 1.2218, 1.2218])
GEN3_COL_JOINT_SIZES = np.array([0.09, 0.09, 0.06, 0.06, 0.06, 0.06, 0.075])

# Finite stand-in for the gen3 continuous joints' +-inf limits inside the
# OCP's inequality rows (the IPM keeps a finite slack for every row).
OCP_INF_CLAMP = 1e3


@functools.lru_cache(maxsize=None)
def ocp_limits(robot: str = "iiwa14"):
    """(q_ub, q_lb, dq_lim, col_sizes) numpy constants per robot."""
    if robot == "gen3":
        q_ub = np.where(np.isinf(GEN3_Q_LIM_UPPER), OCP_INF_CLAMP, GEN3_Q_LIM_UPPER)
        return q_ub, -q_ub, GEN3_DQ_LIM.copy(), GEN3_COL_JOINT_SIZES.copy()
    if robot in (None, "iiwa14"):
        return Q_LIM_UPPER.copy(), Q_LIM_LOWER.copy(), DQ_LIM.copy(), COL_JOINT_SIZES.copy()
    raise ValueError(f"unknown robot {robot!r}")


def _ik_gauss_newton(pd, rd, q0, chain, q_lim=None, iters: int = 60):
    """Bounded damped Gauss-Newton IK: ``iters`` steps of
    q <- clip(q - (J^T J + lam I)^{-1} J^T r) with lam halved on an
    improving step and quadrupled otherwise (``torch.where``, no host sync).
    pd (3,), rd (3, 3), q0 (7,) tensors on one device and dtype."""
    q_ub = Q_LIM_UPPER if q_lim is None else q_lim
    hi = torch.as_tensor(q_ub, dtype=q0.dtype, device=q0.device)
    lo = -hi
    eye3 = torch.eye(3, dtype=q0.dtype, device=q0.device)
    eye7 = torch.eye(7, dtype=q0.dtype, device=q0.device)

    def residuals(q):
        f = kin.fk_frames(q, chain)
        r_pos = f["p_ee"] - pd
        r_rot = (f["r_ee"] @ rd.T - eye3).reshape(-1)
        return torch.cat([r_pos, r_rot])

    q = q0
    lam = torch.tensor(1e-4, dtype=q0.dtype, device=q0.device)
    for _ in range(iters):
        r = residuals(q)
        jac = torch.func.jacfwd(residuals)(q).to(q.dtype)
        h = jac.T @ jac + lam * eye7
        step = torch.linalg.solve(h, jac.T @ r)
        q_new = torch.minimum(torch.maximum(q - step, lo), hi)
        improved = torch.sum(residuals(q_new) ** 2) < torch.sum(r ** 2)
        q = torch.where(improved, q_new, q)
        lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-8), lam * 4.0)
    return q


class RobotModel:
    """Host-side facade over the kinematics: numpy in, numpy out.

    ``robot="iiwa14"`` (default) or ``"gen3"``; ``device`` (the card by
    default; raises at once without one) and ``dtype`` are where and in
    which precision the kinematics run."""

    def __init__(self, robot: str = "iiwa14", device=DEFAULT_DEVICE,
                 dtype=torch.float64):
        self.robot = robot
        self.device = checked_device(device)
        self.dtype = dtype
        self.chain = kin.Chain(robot).to(self.device, dtype)
        if robot == "gen3":
            self.q_lim_upper = GEN3_Q_LIM_UPPER.copy()
            self.q_lim_lower = -GEN3_Q_LIM_UPPER.copy()
            self.dq_lim_upper = GEN3_DQ_LIM.copy()
            self.dq_lim_lower = -GEN3_DQ_LIM.copy()
            self.col_joint_sizes = GEN3_COL_JOINT_SIZES.copy()
        else:
            self.q_lim_upper = Q_LIM_UPPER.copy()
            self.q_lim_lower = Q_LIM_LOWER.copy()
            self.dq_lim_upper = DQ_LIM.copy()
            self.dq_lim_lower = -DQ_LIM.copy()
            self.col_joint_sizes = COL_JOINT_SIZES.copy()
        self.tau_lim_upper = TAU_LIM_UPPER.copy()
        self.tau_lim_lower = TAU_LIM_LOWER.copy()
        self.u_max = U_MAX
        self.u_min = U_MIN

    def get_robot_limits(self):
        return (
            self.q_lim_upper,
            self.q_lim_lower,
            self.dq_lim_upper,
            self.dq_lim_lower,
            self.tau_lim_upper,
            self.tau_lim_lower,
            self.u_max,
            self.u_min,
        )

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype,
                               device=self.device)

    @staticmethod
    def _np(t):
        return t.detach().cpu().numpy()

    def forward_kinematics(self, q, dq):
        """(pose6, J (6, 7), dJ (6, 7)) as numpy."""
        return tuple(self._np(t) for t in
                     kin.forward_kinematics(self._t(q), self._t(dq), self.chain))

    def fk(self, q):
        return self._np(kin.fk_pose(self._t(q), self.chain))

    def fk_pos(self, q):
        return self._np(kin.fk_pos(self._t(q), self.chain))

    def fk_pos_col(self, q, i):
        return self._np(kin.fk_pos_col(self._t(q), i, self.chain))

    def hom_transform_endeffector(self, q):
        return self._np(kin.fk_ee_htm(self._t(q), self.chain))

    def jacobian_fk(self, q):
        return self._np(kin.jacobian_fk(self._t(q), self.chain))

    def djacobian_fk(self, q, dq):
        return self._np(kin.djacobian_fk(self._t(q), self._t(dq), self.chain))

    def velocity_ee(self, q, dq):
        return self._np(kin.velocity_ee(self._t(q), self._t(dq), self.chain))

    def omega_ee(self, q, dq):
        return self._np(kin.omega_ee(self._t(q), self._t(dq), self.chain))

    def inverse_kinematics(self, pd, rd, q0):
        """Joint configuration reaching position ``pd`` and rotation ``rd``
        from ``q0``, within the joint limits."""
        q = _ik_gauss_newton(self._t(pd), self._t(rd), self._t(q0), self.chain,
                             self.q_lim_upper)
        return self._np(q)
