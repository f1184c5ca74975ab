"""The port's scene batching against the JAX package on the demo scene,
float64 on the CPU: ``parallel.batch.make_batch_scene`` (every leaf of the
stacked carry and obstacle arrays), ``parallel.batch.batched_mpc_tick``
(one tick of a two-scene batch at 2 SQP x 6 IPM iterations: every record
and carry leaf) and ``planner.set_finder.build_obstacle_arrays_np``, all
within 1e-9 (one tick from the same state; measured ~4e-11). Also the
package exports: every name in the JAX subpackages' ``__all__`` resolves
in the port's, and ``parallel`` stays lazy.
"""

import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu import demo as jdemo
from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu.path.reference_path import build_path_np as jax_build_path
from boundplanner_tpu.planner.set_finder import build_obstacle_arrays_np as jax_obs_np
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.path.reference_path import build_path
from boundplanner_tpu_torch.planner.set_finder import build_obstacle_arrays_np
from boundplanner_tpu_torch.utils.tree import to_numpy, to_torch, tree_map

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
OFFSETS = [(0.0, -0.3, 0.0), (0.05, -0.2, 0.04)]
OBSTACLES = [[[0.7, -0.2, 0.0, 0.9, 0.0, 0.4]],
             [[0.6, -0.3, 0.0, 0.8, -0.1, 0.3], [0.2, 0.3, 0.0, 0.3, 0.4, 0.2]]]


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def assert_trees_close(got, ref, tol):
    got, ref = leaves(got), [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.astype(float), r.astype(float), rtol=0, atol=tol)


def path_args(offset):
    pose0 = jdemo._fk_pose_np(jdemo.DEMO_Q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    return ([pose0[:3].copy(), pose0[:3] + np.asarray(offset)], [r0, r0],
            [np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [ERB],
            [np.zeros((15, 3))], [np.ones(15)])


@pytest.fixture(scope="module")
def scenes():
    jcfg, tcfg = MPCParams(**SMALL), tconfig.MPCParams(**SMALL)
    pose0 = jdemo._fk_pose_np(jdemo.DEMO_Q0)
    jpaths = [jax_build_path(*path_args(o), nr_segs=jcfg.nr_segs, dtype=np.float64)
              for o in OFFSETS]
    tpaths = [build_path(*path_args(o), nr_segs=tcfg.nr_segs, dtype=np.float64)
              for o in OFFSETS]
    jscene = jbatch.make_batch_scene(jpaths, [pose0, pose0], OBSTACLES, jcfg, dtype=np.float64)
    tscene = tbatch.make_batch_scene(tpaths, [pose0, pose0], OBSTACLES, tcfg, device="cpu",
                                     dtype=torch.float64)
    _, meas, _, _ = jdemo.demo_scene(jcfg, np.float64)
    meas = {k: np.stack([v, v]) for k, v in meas.items()}
    return jcfg, tcfg, jscene, tscene, meas


def test_make_batch_scene_matches_jax(scenes):
    _, _, (jcarry, jobs), (tcarry, tobs), _ = scenes
    assert tcarry.x_prev.shape[0] == 2 and tcarry.x_prev.device.type == "cpu"
    assert tcarry.x_prev.dtype == torch.float64
    assert_trees_close(to_numpy(tcarry), jcarry, TOL)
    assert_trees_close(to_numpy(tobs), jobs, 0.0)


def test_batched_mpc_tick_matches_jax(scenes):
    jcfg, tcfg, (jcarry, jobs), (tcarry, tobs), meas = scenes
    jout = jax.tree.map(np.asarray, jbatch.batched_mpc_tick(
        jcarry, jax.tree.map(jax.numpy.asarray, meas), jobs, jcfg))
    model = FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    tout = to_numpy(tbatch.batched_mpc_tick(tcarry, to_torch(meas, "cpu", torch.float64),
                                            tobs, model))
    (jc, jrec), (tc, trec) = jout, tout
    assert set(trec) == set(jrec)
    assert trec["success"].all()
    for key in jrec:
        np.testing.assert_allclose(np.asarray(trec[key], float), np.asarray(jrec[key], float),
                                   rtol=0, atol=TOL, err_msg=key)
    assert_trees_close(tc, jc, TOL)


@pytest.mark.parametrize("inflate", [0.0, 0.08])
def test_build_obstacle_arrays_np_matches_jax(inflate):
    from examples.scene import example_obstacles

    got = build_obstacle_arrays_np(example_obstacles(), inflate)
    ref = jax_obs_np(example_obstacles(), inflate)
    for g, r in zip(got, ref):
        assert g.dtype == np.asarray(r).dtype
        np.testing.assert_allclose(g, r, rtol=0, atol=TOL)


SUBPACKAGES = ["planner", "robot", "utils", "path", "ops", "mpc", "parallel"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_package_exports_mirror_jax(sub):
    jmod = importlib.import_module(f"boundplanner_tpu.{sub}")
    tmod = importlib.import_module(f"boundplanner_tpu_torch.{sub}")
    assert tmod.__all__ == jmod.__all__
    for name in tmod.__all__:
        assert getattr(tmod, name) is not None, name


def test_parallel_package_import_is_lazy():
    code = ("import sys, boundplanner_tpu_torch.parallel as p; "
            "print(sorted(m for m in sys.modules if m.startswith('boundplanner_tpu_torch.parallel.')))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
