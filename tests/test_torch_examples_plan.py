"""The port's planner examples (``boundplanner_tpu_torch/examples``) on the
CPU against the JAX package's: ``boundplanner_example.main`` in float64
gives the via points, rotations and sets of the JAX script's ``main()``
(within 1e-8); ``boundplanner_with_mpc_example.main`` at a reduced budget
(2 SQP x 6 IPM iterations, 2 ticks) plans the JAX planner's via points
from the same start (float64, within 1e-8) and tracks them: a finite EE
trajectory outside every box of the scene.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu import demo as jdemo
from boundplanner_tpu.planner import BoundPlanner as JaxPlanner
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.examples import boundplanner_example, boundplanner_with_mpc_example
from boundplanner_tpu_torch.examples.scene import (WORKSPACE_MAX, WORKSPACE_MIN,
                                                   example_obstacles)
from examples import scene as jax_scene
from examples.boundplanner_example import main as jax_planner_main

torch.set_num_threads(1)
TOL = 1e-8
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)


def test_scene_is_the_jax_examples():
    assert example_obstacles() == jax_scene.example_obstacles()
    assert (WORKSPACE_MAX, WORKSPACE_MIN) == (jax_scene.WORKSPACE_MAX, jax_scene.WORKSPACE_MIN)


def test_planner_example_matches_jax():
    pv_t, rv_t, bp_t, sets_t = boundplanner_example.main(device="cpu", dtype=torch.float64)
    pv_j, rv_j, bp_j, sets_j = jax_planner_main()
    assert len(pv_t) == len(pv_j) >= 3
    for got, ref in ((pv_t, pv_j), (rv_t, rv_j), (bp_t, bp_j)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float),
                                       rtol=0, atol=TOL)
    for (ga, gb), (ra, rb) in zip(sets_t, sets_j):
        np.testing.assert_allclose(ga, ra, rtol=0, atol=TOL)
        np.testing.assert_allclose(gb, rb, rtol=0, atol=TOL)


def test_planner_with_mpc_example_runs_and_plans_as_jax():
    traj, p_via = boundplanner_with_mpc_example.main(
        device="cpu", params=tconfig.MPCParams(**SMALL), max_ticks=2, plan_dtype=torch.float64)
    assert traj.shape == (2, 3) and np.isfinite(traj).all()
    for ob in example_obstacles():
        lb, ub = np.asarray(ob[:3]), np.asarray(ob[3:])
        inside = np.all((traj > lb + 1e-5) & (traj < ub - 1e-5), axis=1)
        assert not inside.any(), ob

    q0 = np.zeros(7)
    q0[3], q0[5] = -np.pi / 2, np.pi / 2
    pose0 = jdemo._fk_pose_np(q0)
    ref = JaxPlanner(e_p_max=0.5, obstacles=jax_scene.example_obstacles(),
                     workspace_max=jax_scene.WORKSPACE_MAX,
                     workspace_min=jax_scene.WORKSPACE_MIN, seed=0).plan_convex_set_path(
        pose0[:3], np.array([0.45, -0.5, 0.2]), R.from_rotvec(pose0[3:]).as_matrix(),
        R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix())[0]
    assert len(p_via) == len(ref)
    for g, r in zip(p_via, ref):
        np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float), rtol=0, atol=TOL)


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        boundplanner_example.main()
