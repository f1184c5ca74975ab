from .kinematics import (
    fk_ee_htm,
    fk_pos,
    fk_frames,
    fk_pose,
    fk_pos_col,
    fk_pos_col_all,
    jacobian_fk,
    djacobian_fk,
    velocity_ee,
    omega_ee,
    forward_kinematics,
)
from .model import RobotModel

__all__ = [
    "fk_ee_htm",
    "fk_pos",
    "fk_frames",
    "fk_pose",
    "fk_pos_col",
    "fk_pos_col_all",
    "jacobian_fk",
    "djacobian_fk",
    "velocity_ee",
    "omega_ee",
    "forward_kinematics",
    "RobotModel",
]
