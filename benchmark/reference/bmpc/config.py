"""Configuration of the port: the port's own copy of what it uses from
``boundplanner_tpu/config.py`` (the problem dimensions, ``MPCParams``,
``PlannerParams`` and their default constructors), with the same fields,
defaults and order. ``tests/test_torch_config.py`` holds the two equal.

The knobs keep the JAX package's names, including those of TPU-only
routes (``pallas_kkt``, ``esc_pallas``), which choose nothing in the port:
it factors every KKT matrix through one wrapper, kernel A on the card.
The port runs every combination the JAX package runs, and
``mpc.solver.check_supported`` rejects those it rejects. The reasons
behind each default and the measurements that chose them are documented
in the JAX package's ``config.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Fixed problem dimensions (horizon 15, 4 path segments, 7 joints,
# 15-row MPC sets, 20-row planner sets, 6 constrained collision frames).
NUM_JOINTS = 7
MPC_SET_ROWS = 15
PLANNER_SET_ROWS = 20
NUM_LINK_SETS = 6


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Static MPC configuration (frozen, hashable)."""

    n: int = 15                # horizon length N
    dt: float = 0.1            # sampling time [s]
    nr_segs: int = 4           # path segments visible to the OCP window
    robot: str = "iiwa14"      # kinematic chain and limits: "iiwa14" or "gen3"
    max_set_size: int = MPC_SET_ROWS
    # objective weights (w_p, w_r, w_v_p, w_v_r, w_phi, w_dphi, w_dq,
    # w_jerk, w_term, w_slack, w_dslack); empty -> `default_weights()`
    weights: Tuple[float, ...] = ()
    # SQP solver budget
    sqp_iters: int = 12
    qp_iters: int = 25
    line_search_steps: int = 6
    merit_penalty: float = 1e3
    # the JAX package's Pallas KKT route; in the port every CUDA-tensor
    # factorization goes to kernel A whatever this says
    pallas_kkt: bool = False
    qp_solver: str = "ipm"     # "ipm" or "admm"
    admm_iters: int = 60
    manual_jac: bool = False   # structured chain-rule OCP Jacobians
    struct_ocp: bool = False   # block-banded OCP structure end to end
    struct_tail: bool = True
    struct_chunked: bool = True
    struct_link: bool = False
    qp_warm_dual: bool = False
    qp_warm_sz: bool = False
    qp_bf16_rd: bool = False   # the dual residual's G^T z stream in bf16
    qp_gondzio: int = 0        # Gondzio correctors per IPM iteration
    warm_shift: bool = False   # shift the warm start one control period
    qp_bf16: bool = False      # bf16 constraint-matrix streams
    kkt_every: int = 1
    # budget escalation on failing ticks
    esc_lanes: int = 0
    esc_sqp_iters: int = 6
    esc_qp_iters: int = 8
    esc_streak_limit: int = 3
    esc_pallas: bool = False
    # consecutive failed ticks before safe-stop braking (0: n - 2)
    deep_fail_ticks: int = 0
    # brake at once when a failed tick's replay would enter an obstacle
    fallback_guard: bool = True

    def __post_init__(self):
        if not self.weights:
            object.__setattr__(self, "weights", tuple(default_weights()))

    @property
    def weights_array(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float64)


def default_weights() -> np.ndarray:
    """Default objective weights (those of the BoundMPC reference)."""
    w_p = 0.05
    w_r = 0.1
    w_v_p = 0.1
    w_v_r = 0.01
    w_speed = 0.5
    w_phi = 5.5 * w_speed
    w_dphi = 4.06
    scal = 0.5 / w_phi
    w_phi *= scal
    w_dphi *= scal
    w_dq = 0.001
    w_jerk = 0.0001
    w_term = 1.0
    w_slack = 10.0
    w_dslack = 500.0
    return np.array(
        [w_p, w_r, w_v_p, w_v_r, w_phi, w_dphi, w_dq, w_jerk, w_term, w_slack, w_dslack]
    )


def default_mpc_params() -> MPCParams:
    return MPCParams()


def perf_mpc_params() -> MPCParams:
    """The throughput configuration of the main path (`bench.py`'s):
    3 SQP x 4 IPM iterations with 2 Gondzio correctors, 4 line-search
    candidates, shifted warm starts, bf16 constraint streams, the flat
    structured OCP and safe-stop braking after 3 failed ticks."""
    return MPCParams(sqp_iters=3, qp_iters=4, qp_gondzio=2,
                     line_search_steps=4,
                     pallas_kkt=True, warm_shift=True, qp_bf16=True,
                     qp_bf16_rd=True,
                     struct_ocp=True, struct_chunked=False,
                     deep_fail_ticks=3)


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Static planner configuration."""

    e_p_max: float = 0.5
    obs_size_increase: float = 0.08
    workspace_max: Tuple[float, float, float] = (1.0, 1.0, 1.2)
    workspace_min: Tuple[float, float, float] = (-1.0, -1.0, 0.0)
    max_set_size: int = PLANNER_SET_ROWS
    length_ee: float = 0.05
    max_iters: int = 20
    nr_optimized: int = 10
    nr_free_mid: int = 5
    max_samples: int = 500
    w_size: float = 0.1
    c_fit: float = 1.0
    w_bias: float = 0.01
