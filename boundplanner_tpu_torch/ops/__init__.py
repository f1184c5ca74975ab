from .qp import solve_qp, solve_projection, solve_feasibility, QPSolution
from .mvie import mvie, mvie_fixed_mid, mvie_fixed_r

__all__ = [
    "solve_qp",
    "solve_projection",
    "solve_feasibility",
    "QPSolution",
    "mvie",
    "mvie_fixed_mid",
    "mvie_fixed_r",
]
