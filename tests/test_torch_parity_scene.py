"""The port's planner on the parity scene (the counterpart of
``tests/test_parity_scene.py``): the exact 12-obstacle scene of the
examples (BASELINE config 1), planned in float64 on the CPU, held to the
JAX test's bars: intermediate vias, the exact endpoints, a polyline clear
of every original obstacle, and each consecutive via pair inside its
segment's 15-row set."""

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu_torch.examples.scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles
from boundplanner_tpu_torch.planner.planner import BoundPlanner

torch.set_num_threads(1)


def test_parity_scene_plan():
    planner = BoundPlanner(e_p_max=0.5, obstacles=example_obstacles(),
                           workspace_max=WORKSPACE_MAX, workspace_min=WORKSPACE_MIN, seed=0,
                           device="cpu", dtype=torch.float64)
    p0 = np.array([0.3, 0.0, 0.7])
    p1 = np.array([0.45, -0.5, 0.2])
    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r0)

    assert len(p_via) >= 3  # the scene genuinely needs intermediate vias
    np.testing.assert_allclose(p_via[0], p0, atol=1e-9)
    np.testing.assert_allclose(p_via[-1], p1, atol=1e-9)

    # the polyline must clear every original obstacle
    for i in range(len(p_via) - 1):
        for t in np.linspace(0, 1, 30):
            x = (1 - t) * np.asarray(p_via[i]) + t * np.asarray(p_via[i + 1])
            for a, b in planner.obs_sets_orig:
                assert np.max(a @ x - b) > -1e-6

    # every consecutive via pair lives in its segment's 15-row set
    for i, (a, b) in enumerate(sets_via):
        assert a.shape == (15, 3) and b.shape == (15,)
        assert np.max(a @ np.asarray(p_via[i]) - b) < 2e-3
        assert np.max(a @ np.asarray(p_via[i + 1]) - b) < 2e-3
