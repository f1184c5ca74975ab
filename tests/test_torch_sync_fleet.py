"""The phase-synchronous planner path of the port against the JAX package,
float64 on the CPU:

- one scene planned through ``PhaseSyncBroker`` (a single worker, so every
  batch has width 1) against JAX's direct ``BoundPlanner`` on the scene of
  tests/test_sync_broker.py, within 1e-8 (JAX's own bar for the same
  comparison);
- ``parallel.fleet.build_fleet_sync`` at ``batch=1, n_workers=1`` against
  JAX's with the same arguments: the same draws (q0 and obstacle arrays
  equal) and every carry leaf within 1e-8;
- two workers on two scenes: the barrier coalesces (mean width above 1),
  the draws are the JAX builder's, every corridor is sound. Plan values
  are not compared at width 2: batched rounding may take the planner's
  discrete decisions another way (tests/test_sync_broker.py says the same).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.parallel.fleet import build_fleet_sync as jax_build_fleet_sync
from boundplanner_tpu.parallel.fleet import random_scene
from boundplanner_tpu.planner import BoundPlanner as JaxPlanner
from boundplanner_tpu.planner.set_finder import build_obstacle_arrays as jax_obstacle_arrays
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.parallel.broker import register_planner_kernels
from boundplanner_tpu_torch.parallel.fleet import build_fleet_sync
from boundplanner_tpu_torch.parallel.sync_broker import PhaseSyncBroker
from boundplanner_tpu_torch.planner import BoundPlanner
from boundplanner_tpu_torch.utils.tree import tree_map

torch.set_num_threads(1)
TOL = 1e-8
SMALL = dict(sqp_iters=2, qp_iters=5, line_search_steps=2)
KW = dict(
    e_p_max=0.5,
    obstacles=[[0.2, -1.0, -0.1, 1.0, 1.0, 0.0], [0.35, -0.25, 0.0, 0.55, -0.1, 0.45]],
    workspace_max=[1.0, 0.38, 1.0],
    workspace_min=[-0.14, -1.0, 0.0],
    seed=0,
)
P0 = np.array([0.55, 0.0, 0.6])
P1 = np.array([0.45, -0.4, 0.25])
R0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def test_sync_brokered_planner_matches_jax_direct():
    pv_j, rv_j, bp_j, sets_j = JaxPlanner(**KW).plan_convex_set_path(P0, P1, R0, R0)

    brk = PhaseSyncBroker(device="cpu", dtype=torch.float64)
    register_planner_kernels(brk, max_set_size=20)
    planner = BoundPlanner(**KW, broker=brk, device="cpu", dtype=torch.float64)
    brk.worker_enter()
    try:
        pv_t, rv_t, bp_t, sets_t = planner.plan_convex_set_path(P0, P1, R0, R0)
    finally:
        brk.worker_exit()

    assert brk.calls_served > 0
    assert brk.stats["width_hist"] == {1: brk.batches_run}
    assert len(pv_t) == len(pv_j)
    for got, ref in ((pv_t, pv_j), (rv_t, rv_j), (bp_t, bp_j)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g, float), np.asarray(r, float),
                                       rtol=0, atol=TOL)
    for (ga, gb), (ra, rb) in zip(sets_t, sets_j):
        np.testing.assert_allclose(ga, ra, rtol=0, atol=TOL)
        np.testing.assert_allclose(gb, rb, rtol=0, atol=TOL)


def test_build_fleet_sync_matches_jax():
    jc, jq, jo, jbrk = jax_build_fleet_sync(1, MPCParams(**SMALL), n_obstacles=2, seed=3,
                                            dtype=np.float64, n_workers=1)
    tc, tq, to, tbrk = build_fleet_sync(1, tconfig.MPCParams(**SMALL), n_obstacles=2, seed=3,
                                        dtype=np.float64, n_workers=1, device="cpu",
                                        plan_dtype=torch.float64)
    np.testing.assert_array_equal(tq, jq)
    for g, r in zip(leaves(to), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert tc._fields == jc._fields
    got, ref = leaves(tc), [np.asarray(x) for x in jax.tree.leaves(jc)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.astype(float), r.astype(float), rtol=0, atol=TOL)
    assert tbrk.stats == jbrk.stats


def corridor_sound(carry, obs, i):
    path = carry.path
    n_via = int(path.num_sectors[i]) + 2
    p = np.asarray(path.p[i, :n_via], np.float64)
    for s in range(n_via - 1):
        a, b = path.a_set[i, s], path.b_set[i, s]
        if max(np.max(a @ p[s] - b), np.max(a @ p[s + 1] - b)) >= 2e-3:
            return False
        for t in np.linspace(0.0, 1.0, 25):
            x = (1 - t) * p[s] + t * p[s + 1]
            for o in np.nonzero(obs.mask[i])[0]:
                if np.max(obs.a[i, o, :6] @ x - obs.b[i, o, :6]) <= -1e-6:
                    return False
    return True


def test_two_workers_coalesce_the_jax_draws():
    carry, q0, obs, brk = build_fleet_sync(2, tconfig.MPCParams(**SMALL), n_obstacles=2,
                                           seed=3, dtype=np.float64, n_workers=2,
                                           device="cpu", plan_dtype=torch.float64)
    assert q0.shape == (2, 7)
    assert brk.stats["mean_width"] > 1.0
    assert sum(w * n for w, n in brk.width_hist.items()) >= brk.calls_served
    drawn = [jax_obstacle_arrays(random_scene(np.random.default_rng(3 + 1000 * d), 2)[0]).b
             for d in range(1, 9)]
    for i in range(2):
        assert any(np.array_equal(obs.b[i], b) for b in drawn)
        assert corridor_sound(carry, obs, i)
    assert all(np.isfinite(x.astype(float)).all() for x in leaves(carry))


def test_build_fleet_sync_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_fleet_sync(1, tconfig.MPCParams(**SMALL))
