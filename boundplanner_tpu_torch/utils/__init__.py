from .so3 import (
    skew,
    rodrigues,
    rotvec_to_matrix,
    matrix_to_rotvec,
    matrix_to_quat,
    matrix_to_euler_zyx,
    jac_so3_inv_left,
    jac_so3_inv_right,
    gram_schmidt,
)
from .sets import normalize_set_size, make_box, box_vertices

__all__ = [
    "skew",
    "rodrigues",
    "rotvec_to_matrix",
    "matrix_to_rotvec",
    "matrix_to_quat",
    "matrix_to_euler_zyx",
    "jac_so3_inv_left",
    "jac_so3_inv_right",
    "gram_schmidt",
    "normalize_set_size",
    "make_box",
    "box_vertices",
]
