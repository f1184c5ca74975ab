"""Robot limits and collision geometry (port of the constants and
``ocp_limits`` of ``boundplanner_tpu/robot/model.py``; the IK facade waits
for the runtime slice)."""

from __future__ import annotations

import functools

import numpy as np

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
