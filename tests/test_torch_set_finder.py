"""The planner's set construction in the port against the JAX package, in
float64 on the CPU, on the scenes of ``tests/test_set_finder.py``:
``find_set_line`` inside the workspace box (``limit_space=False``, the
planner's setting), ``find_set_around_point`` with and without a fixed
center, and ``find_set_around_line``. The host-side numpy helpers copied
into the port (``utils.sets``, ``build_obstacle_arrays``,
``path.reference_path.build_path``) must give bit-equal results.

Tolerance 1e-8 for the set finder: batched QPs and closed-form MVIE
derivatives against per-problem autodiff, summation order only (measured
below 1e-14; the ellipsoid-metric projections near a degenerate seed
amplify it to ~1e-10).
"""

import importlib

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.path import reference_path as tpath
from boundplanner_tpu_torch.planner import set_finder as tsf
from boundplanner_tpu_torch.utils import sets as tsets
from boundplanner_tpu_torch.utils.tree import to_torch

jsf = importlib.import_module("boundplanner_tpu.planner.set_finder")
jsets = importlib.import_module("boundplanner_tpu.utils.sets")
jpath = importlib.import_module("boundplanner_tpu.path.reference_path")

torch.set_num_threads(1)
TOL = 1e-8
WS_MIN = np.array([-1.0, -1.0, 0.0])
WS_MAX = np.array([1.0, 1.0, 1.2])
OBSTACLES = [
    [0.3, -0.2, 0.0, 0.5, 0.2, 0.6],
    [-0.8, -0.8, 0.0, -0.6, -0.6, 0.3],
]


def batch1(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64))[None] for a in arrays]


def port_obs(obstacles, size_increase=0.0):
    obs = tsf.build_obstacle_arrays(obstacles, size_increase)
    return to_torch(tsf.ObstacleArrays(*(np.asarray(x)[None] for x in obs)), "cpu", torch.float64)


def assert_outputs_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[0].numpy().astype(float), np.asarray(r, float),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size_increase", [0.0, 0.08])
@pytest.mark.parametrize("count", [0, 2, 16])
def test_build_obstacle_arrays_bit_equal(count, size_increase):
    rng = np.random.default_rng(count)
    obstacles = [list(np.r_[c - 0.05, c + 0.05]) for c in rng.uniform(-1, 1, (count, 3))]
    for dtype in (np.float64, np.float32):
        got = tsf.build_obstacle_arrays(obstacles, size_increase, dtype=dtype)
        ref = jsf.build_obstacle_arrays(obstacles, size_increase, dtype=dtype)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("segment", [
    ([0.0, 0.0, 0.3], [0.1, 0.0, 0.3]),     # beside the first box
    ([0.4, 0.0, 0.3], [0.4, 0.05, 0.3]),    # piercing it: collision flag
    ([-0.5, 0.5, 0.8], [0.6, 0.5, 0.9]),    # long, above both
])
def test_find_set_line_workspace_matches_jax(segment):
    p0, p1 = segment
    got = tsf.find_set_line(*batch1(p0, p1), port_obs(OBSTACLES), 0.0, *batch1(WS_MIN, WS_MAX),
                            limit_space=False, n_rows=20)
    ref = jsf.find_set_line(jnp.asarray(p0), jnp.asarray(p1), jsf.build_obstacle_arrays(OBSTACLES),
                            0.0, jnp.asarray(WS_MIN), jnp.asarray(WS_MAX),
                            limit_space=False, n_rows=20)
    assert_outputs_close(got, ref)


@pytest.mark.parametrize("fixed_mid,seed", [
    (False, [0.0, 0.0, 0.5]),
    (True, [0.1, 0.3, 0.5]),
    (True, [0.3, -0.28, 0.62]),              # close to the first box's corner
])
def test_find_set_around_point_matches_jax(fixed_mid, seed):
    got = tsf.find_set_around_point(*batch1(seed), port_obs(OBSTACLES, 0.08),
                                    *batch1(WS_MIN, WS_MAX), fixed_mid=fixed_mid)
    ref = jsf.find_set_around_point(jnp.asarray(seed), jsf.build_obstacle_arrays(OBSTACLES, 0.08),
                                    jnp.asarray(WS_MIN), jnp.asarray(WS_MAX), fixed_mid=fixed_mid)
    assert_outputs_close(got, ref)


def test_find_set_around_line_matches_jax():
    p0, dp1 = [0.0, 0.3, 0.5], [0.15, 0.0, 0.0]
    got = tsf.find_set_around_line(*batch1(p0, dp1), port_obs(OBSTACLES),
                                   *batch1(WS_MIN, WS_MAX))
    ref = jsf.find_set_around_line(jnp.asarray(p0), jnp.asarray(dp1),
                                   jsf.build_obstacle_arrays(OBSTACLES),
                                   jnp.asarray(WS_MIN), jnp.asarray(WS_MAX))
    assert_outputs_close(got, ref)


def test_set_finder_batch_rows_are_independent():
    """Two problems in one batch give what each gives alone (the broker
    relies on it)."""
    seeds = np.array([[0.0, 0.0, 0.5], [0.1, 0.3, 0.5]])
    obs = port_obs(OBSTACLES, 0.08)
    obs2 = type(obs)(*(x.expand((2,) + x.shape[1:]) for x in obs))
    both = tsf.find_set_around_point(torch.from_numpy(seeds), obs2,
                                     *(torch.from_numpy(np.stack([w, w])) for w in (WS_MIN, WS_MAX)),
                                     fixed_mid=True)
    for i in range(2):
        one = tsf.find_set_around_point(*batch1(seeds[i]), obs, *batch1(WS_MIN, WS_MAX),
                                        fixed_mid=True)
        for x, y in zip(both, one):
            np.testing.assert_allclose(x[i].numpy().astype(float), y[0].numpy().astype(float),
                                       rtol=0, atol=1e-12)


def test_sets_helpers_bit_equal():
    rng = np.random.default_rng(3)
    lb, ub = rng.uniform(-1, 0, 3), rng.uniform(0, 1, 3)
    for g, r in zip(tsets.make_box(lb, ub), jsets.make_box(lb, ub)):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(tsets.box_vertices(lb, ub), jsets.box_vertices(lb, ub))
    a = np.vstack([np.eye(3), -np.eye(3), rng.normal(size=(5, 3)), np.eye(3)])
    b = np.concatenate([ub, -lb, rng.uniform(0.5, 2.0, 5), ub + 0.3])
    np.testing.assert_array_equal(tsets.polytope_vertices(a, b), jsets.polytope_vertices(a, b))
    for g, r in zip(tsets.reduce_ineqs(a, b), jsets.reduce_ineqs(a, b)):
        np.testing.assert_array_equal(g, r)
    sets = [[a[:7], b[:7]], [a[:3], b[:3]]]
    for (ga, gb), (ra, rb) in zip(tsets.normalize_set_size(sets, 15),
                                  jsets.normalize_set_size(sets, 15)):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_path_bit_equal(dtype):
    """A 4-via path with a degenerate (rotation-only) segment."""
    rng = np.random.default_rng(9)
    p_via = [np.array([0.5, 0.0, 0.6]), np.array([0.55, -0.2, 0.5]),
             np.array([0.55, -0.2, 0.5]), np.array([0.45, -0.4, 0.3])]
    rots = R.from_rotvec(rng.normal(size=(4, 3)) * 0.5).as_matrix()
    bp1 = [np.array([0.0, 0.0, 1.0])] * 3
    br1 = [np.array([0.0, 0.0, 1.0])] * 3
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * 3
    a_sets = [np.vstack([np.eye(3), -np.eye(3)])] * 3
    b_sets = [rng.uniform(0.5, 1.0, 6) for _ in range(3)]
    got = tpath.build_path(p_via, list(rots), bp1, br1, erb, a_sets, b_sets,
                           nr_segs=tconfig.perf_mpc_params().nr_segs, dtype=dtype)
    ref = jpath.build_path(p_via, list(rots), bp1, br1, erb, a_sets, b_sets,
                           nr_segs=perf_mpc_params().nr_segs, dtype=dtype)
    assert got._fields == ref._fields
    for g, r in zip(got, ref):
        assert np.asarray(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g, r)


def test_build_path_spiral_not_ported():
    """``spiral_blend > 0`` on a path without an interior corner: the
    corner blending (ported since; its corner cases are in
    tests/test_torch_runtime.py) passes it through, bit-equal to JAX."""
    args = ([np.zeros(3), np.ones(3)], [np.eye(3)] * 2, [np.ones(3)],
            [np.ones(3)], [np.zeros(6)], [np.eye(3)], [np.ones(3)])
    got = tpath.build_path(*args, spiral_blend=0.05)
    ref = jpath.build_path(*args, spiral_blend=0.05)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
