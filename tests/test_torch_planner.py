"""The port's whole planner against the JAX package, in float64 on the CPU:
``BoundPlanner.plan_convex_set_path`` on the scene of
``tests/test_planner.py``, and ``parallel.fleet.plan_scene`` on fleet draw
1 of seed 7 (the draw scheme of the cached fleets), down to the MPC carry.

Tolerance 1e-6 with the same via count: the planner takes discrete
decisions on thresholds (intersection t < 1e-7, new-set distance > 0.01,
via convergence 1e-4, first-index argmin/argmax picks), so parity is held
on the final plan; both runs take the same branches, and the values
measured agree to ~1e-15.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu.demo import DEMO_Q0
from boundplanner_tpu.parallel import fleet as jfleet
from boundplanner_tpu.planner import BoundPlanner as JaxPlanner
from boundplanner_tpu_torch.parallel import fleet as tfleet
from boundplanner_tpu_torch.planner.planner import BoundPlanner

torch.set_num_threads(1)
TOL = 1e-6
OBSTACLES = [
    [0.25, -0.15, 0.0, 0.45, 0.15, 0.8],   # wall between start and goal
    [-0.5, -0.5, 0.0, -0.3, -0.3, 0.3],
]
KW = dict(e_p_max=0.5, obstacles=OBSTACLES, workspace_max=[1.0, 1.0, 1.0],
          workspace_min=[-1.0, -1.0, 0.0], seed=0)
P0 = np.array([0.0, 0.0, 0.4])
P1 = np.array([0.7, 0.0, 0.4])
R0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
R1 = R.from_euler("XYZ", [0, 45, 0], degrees=True).as_matrix()


@pytest.fixture(scope="module")
def jax_plan():
    planner = JaxPlanner(**KW)
    return planner, planner.plan_convex_set_path(P0, P1, R0, R1)


@pytest.fixture(scope="module")
def port_plan():
    planner = BoundPlanner(**KW, device="cpu", dtype=torch.float64)
    return planner, planner.plan_convex_set_path(P0, P1, R0, R1)


def draw_scene(draw, seed=7):
    return tfleet.random_scene(np.random.default_rng(seed + 1000 * draw), 3)


@pytest.fixture(scope="module")
def jax_scene():
    obstacles, goal = jfleet.random_scene(np.random.default_rng(7 + 1000), 3)
    return jfleet.plan_scene(DEMO_Q0, goal, obstacles, 8, perf_mpc_params(), dtype=np.float64)


@pytest.fixture(scope="module")
def port_scene():
    obstacles, goal = draw_scene(1)
    return tfleet.plan_scene(tfleet.DEMO_Q0, goal, obstacles, 8, tconfig.perf_mpc_params(),
                             dtype=np.float64, device="cpu", plan_dtype=torch.float64)


def test_plan_matches_jax(jax_plan, port_plan):
    (jp, (pv_j, rv_j, bp_j, sets_j)), (tp, (pv_t, rv_t, bp_t, sets_t)) = jax_plan, port_plan
    assert len(pv_t) == len(pv_j)
    assert tp.nr_sets == jp.nr_sets
    for got, ref in ((pv_t, pv_j), (rv_t, rv_j), (bp_t, bp_j)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float),
                                       rtol=TOL, atol=TOL)
    for (ga, gb), (ra, rb) in zip(sets_t, sets_j):
        np.testing.assert_allclose(ga, ra, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gb, rb, rtol=TOL, atol=TOL)


def test_plan_structure(port_plan):
    _, (p_via, r_via, bp1_list, sets_via) = port_plan
    assert len(p_via) >= 3                      # the wall forces a detour
    np.testing.assert_allclose(p_via[0], P0, atol=1e-9)
    np.testing.assert_allclose(p_via[-1], P1, atol=1e-9)
    assert len(r_via) == len(p_via) and len(bp1_list) == len(p_via) - 1
    np.testing.assert_allclose(r_via[0], R0, atol=1e-8)
    np.testing.assert_allclose(r_via[-1], R1, atol=1e-8)
    for a, b in sets_via:
        assert a.shape == (15, 3) and b.shape == (15,)


def test_plan_corridor_invariants(port_plan):
    """Segment ends inside their sets, segments outside the obstacles (the
    invariants of tests/test_planner.py)."""
    planner, (p_via, _, _, sets_via) = port_plan
    for i, (a, b) in enumerate(sets_via):
        assert np.max(a @ p_via[i] - b) < 2e-3
        assert np.max(a @ p_via[i + 1] - b) < 2e-3
        for t in np.linspace(0, 1, 25):
            x = (1 - t) * np.asarray(p_via[i]) + t * np.asarray(p_via[i + 1])
            for a_o, b_o in planner.obs_sets_orig:
                assert np.max(a_o @ x - b_o) > -1e-6


def test_plan_scene_matches_jax(jax_scene, port_scene):
    assert jax_scene is not None and port_scene is not None
    (carry_j, obs_j), (carry_t, obs_t) = jax_scene, port_scene
    for g, r in zip(obs_t, obs_j):
        np.testing.assert_array_equal(g, r)
    assert int(carry_t.path.num_sectors) == int(carry_j.path.num_sectors)
    assert carry_t._fields == carry_j._fields
    for (name, g), r in zip(carry_t._asdict().items(), carry_j):
        if name == "path":
            for gp, rp in zip(g, r):
                np.testing.assert_allclose(np.asarray(gp, float), np.asarray(rp, float),
                                           rtol=TOL, atol=TOL)
        else:
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float),
                                       rtol=TOL, atol=TOL)


def test_random_scene_draws_equal_jax():
    np.testing.assert_array_equal(tfleet.DEMO_Q0, DEMO_Q0)
    for draw in (1, 2, 3):
        ot, gt = draw_scene(draw)
        oj, gj = jfleet.random_scene(np.random.default_rng(7 + 1000 * draw), 3)
        np.testing.assert_array_equal(np.asarray(ot), np.asarray(oj))
        np.testing.assert_array_equal(gt, gj)
