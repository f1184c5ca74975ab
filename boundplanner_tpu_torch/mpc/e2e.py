"""The scene of tests/test_e2e.py for the single-arm runtime, and how far
two exact float64 factorizations drive its default closed loop apart.

``plan_e2e(device)`` plans the scene (a floor and a pillar between the
demo pose and the goal) with ``BoundPlanner`` in float64 and returns what
``MPCNode.update_reference`` takes. ``rounding_spread`` runs two
``MPCNode``s with ``MPCParams()`` (12 SQP x 25 IPM iterations, dense QP on
2439 rows) on that plan: one factors every KKT matrix through
``ops.linalg.kkt_inverse`` (kernel A on the card, its plain version on the
CPU), the other through the library route ``cholesky_ex`` +
``solve_triangular``. Both are exact to float64 rounding; the dense IPM's
KKT systems near active obstacle and set rows amplify it, and the closed
loop carries it on. Prints per tick the largest difference of q, dq and
the measured pose between the two.

    python -m boundplanner_tpu_torch.mpc.e2e [--device cpu] [--ticks 4]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..demo import DEMO_Q0
from ..ops import linalg, qp
from ..parallel.fleet import DEFAULT_ER_BOUND
from ..planner.planner import BoundPlanner
from ..robot.model import RobotModel
from .node import MPCNode

E2E_OBSTACLES = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0],        # floor
                 [0.35, -0.25, 0.0, 0.55, -0.1, 0.45]]    # pillar in the way
E2E_GOAL = (0.45, -0.4, 0.25)
E2E_WS_MIN = (-0.14, -1.0, 0.0)
E2E_WS_MAX = (1.0, 0.38, 1.0)


def plan_e2e(device, broker=None):
    """The scene planned on ``device`` in float64 (planner seed 0), through
    ``broker`` when given (a `parallel.broker.BatchBroker`). Returns (q0,
    the ``update_reference`` arguments, the original obstacles' H-reps,
    the goal, the plan's timing: ``seconds`` and the roadmap searches'
    ``comp_time_path``)."""
    device = torch.device(device)
    q0 = DEMO_Q0.copy()
    pose0 = RobotModel(device=device).fk(q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    goal = np.asarray(E2E_GOAL)
    t0 = time.perf_counter()
    planner = BoundPlanner(e_p_max=0.5, obstacles=E2E_OBSTACLES, workspace_max=E2E_WS_MAX,
                           workspace_min=E2E_WS_MIN, seed=0, broker=broker, device=device,
                           dtype=torch.float64)
    p_via, r_via, bp1, sets_via = planner.plan_convex_set_path(pose0[:3].copy(), goal.copy(),
                                                               r0, r1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.perf_counter() - t0
    n = len(bp1)
    args = (p_via, r_via, bp1, [np.array([0.0, 0.0, 1.0])] * n, [DEFAULT_ER_BOUND] * n,
            [x[0] for x in sets_via], [x[1] for x in sets_via], E2E_OBSTACLES)
    timing = {"seconds": secs, "comp_time_path": planner.comp_time_path}
    return q0, args, planner.obs_sets_orig, goal, timing


def library_inverse(kkt):
    """L^{-1} by the library route (``chip_smoke.py`` times it beside
    kernel A)."""
    eye = torch.eye(kkt.shape[-1], dtype=kkt.dtype, device=kkt.device).expand_as(kkt)
    return torch.linalg.solve_triangular(torch.linalg.cholesky_ex(kkt)[0], eye, upper=False)


def rounding_spread(plan, device, ticks: int):
    """Per tick, the largest difference of q, dq and p_lie between the two
    factorization routes on one device."""
    q0, args = plan[0], plan[1]
    nodes = [MPCNode(q0, device=device) for _ in range(2)]
    for node in nodes:
        node.update_reference(*args)
    rows = []
    try:
        for tick in range(1, ticks + 1):
            for node, route in zip(nodes, (linalg.kkt_inverse, library_inverse)):
                qp.kkt_inverse = route
                node.step()
            rows.append({"tick": tick, **{key: float(np.abs(getattr(nodes[0], key)
                                                            - getattr(nodes[1], key)).max())
                                          for key in ("q", "dq", "p_lie")}})
    finally:
        qp.kkt_inverse = linalg.kkt_inverse
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ticks", type=int, default=4)
    args = parser.parse_args(argv)
    plan = plan_e2e(args.device)
    for row in rounding_spread(plan, torch.device(args.device), args.ticks):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
