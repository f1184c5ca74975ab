"""The port's planner when the start EE point lies inside a box, and that
the start push leaves a free start alone.

The two cases of tests/test_start_in_collision.py through the port's
``BoundPlanner(device="cpu", dtype=torch.float64)``: a start at the centre
of a box is pushed free and every corridor set excludes the original box
to 2 mm (the reference test's bar); a free start keeps its start via
exactly and plans what the JAX planner plans, via points and sets within
1e-12.
"""

import numpy as np
from scipy.optimize import linprog
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu.planner import BoundPlanner as JPlanner
from boundplanner_tpu_torch.planner.planner import BoundPlanner

torch.set_num_threads(1)
FLOOR = [0.2, -1.0, -0.1, 1.0, 1.0, 0.0]
WS = dict(e_p_max=0.5, workspace_max=[1.0, 0.38, 1.0], workspace_min=[-0.14, -1.0, 0.0],
          seed=0)
R1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()


def overlap_depth(a, b, box):
    """Deepest point of {x: a x <= b} inside the box (bisection on a
    uniformly shrunk box; 0 when the set and the box are disjoint)."""
    a_box = np.vstack([np.eye(3), -np.eye(3)])
    b_box = np.concatenate([np.asarray(box[3:], float), -np.asarray(box[:3], float)])
    lo, hi = 0.0, 0.3
    for _ in range(18):
        t = 0.5 * (lo + hi)
        res = linprog(np.zeros(3), A_ub=np.vstack([a, a_box]), b_ub=np.concatenate([b, b_box - t]),
                      bounds=[(None, None)] * 3, method="highs")
        lo, hi = (t, hi) if res.status == 0 else (lo, t)
    return lo


def test_start_inside_box_corridor_sound():
    p0 = np.array([0.3, -0.3, 0.4])
    box = [0.25, -0.35, 0.35, 0.35, -0.25, 0.45]
    planner = BoundPlanner(obstacles=[FLOOR, box], device="cpu", dtype=torch.float64, **WS)
    p_via, _, _, sets_via = planner.plan_convex_set_path(p0.copy(), np.array([0.55, -0.45, 0.25]),
                                                         np.eye(3), R1)
    assert (np.any(p_via[0] < np.array(box[:3]) + 1e-9)
            or np.any(p_via[0] > np.array(box[3:]) - 1e-9)), "start via not pushed free"
    for a, b in sets_via:
        assert overlap_depth(np.asarray(a), np.asarray(b), box) < 2e-3


def test_free_start_plans_as_jax():
    p0, p1 = np.array([0.3, 0.2, 0.6]), np.array([0.45, -0.4, 0.25])
    obstacles = [FLOOR, [0.35, -0.25, 0.0, 0.55, -0.1, 0.45]]
    port = BoundPlanner(obstacles=obstacles, device="cpu", dtype=torch.float64,
                        **WS).plan_convex_set_path(p0.copy(), p1.copy(), np.eye(3), R1)
    ref = JPlanner(obstacles=obstacles, **WS).plan_convex_set_path(p0.copy(), p1.copy(),
                                                                   np.eye(3), R1)
    np.testing.assert_array_equal(port[0][0], p0)
    assert len(port[0]) == len(ref[0]) and len(port[3]) == len(ref[3])
    np.testing.assert_allclose(np.asarray(port[0]), np.asarray(ref[0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(port[1]), np.asarray(ref[1]), rtol=0, atol=1e-12)
    for (a, b), (ja, jb) in zip(port[3], ref[3]):
        np.testing.assert_allclose(a, ja, rtol=0, atol=1e-12)
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-12)
