"""One fused MPC tick of the port against the JAX package's, shared by the
tick-level test files of the solver configurations
(``test_torch_solver_configs*.py``, ``test_torch_escalation.py``).

Scenes come from ``.fleet_cache/test8.pkl`` cast to float64. A
configuration is ``perf_mpc_params()`` with some fields replaced, the same
in both packages. Each leaf of the outputs and of the carry must agree
within ``TICK_TOL`` of its largest entry (at least 1); flags and counters
exactly.
"""

import dataclasses
import os

import numpy as np

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch, tree_map

FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")
# one tick (3 SQP x 4 IPM iterations through explicit inverses of KKT
# matrices with condition ~1e8): the configurations agree to <= 6e-12 of
# the largest entry on the CPU (`python tests/torch_config_drift.py`)
TICK_TOL = 1e-7


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


def fleet_scenes(count: int):
    """(carry, q0, obs) of the fleet's first ``count`` scenes, numpy."""
    payload = load(FLEET8)
    return tree_map(lambda a: f64(a)[:count], (payload["carry"], payload["q0"], payload["obs"]))


def configs(**fields):
    """The perf configuration with ``fields`` replaced: (JAX's, the port's)."""
    return (dataclasses.replace(perf_mpc_params(), **fields),
            dataclasses.replace(tconfig.perf_mpc_params(), **fields))


def jax_inputs(scenes):
    carry, q0, obs = scenes
    return jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:]), jmpc.ObstacleArrays(*obs)


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def assert_trees_close(got, ref, tol=TICK_TOL):
    """``got`` a port tree (numpy leaves), ``ref`` the JAX tree."""
    got, ref = leaves(got), [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        if r.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r)
        else:
            bar = tol * max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, rtol=0, atol=bar)


def check_tick(count: int = 2, **fields):
    """One tick of the first ``count`` scenes in both packages at the
    plant's rest state; asserts agreement and returns the port's
    (carry, outputs) as numpy."""
    scenes = fleet_scenes(count)
    jcfg, tcfg = configs(**fields)
    jcarry, jobs = jax_inputs(scenes)
    q0 = scenes[1]
    zeros = np.zeros_like(q0)
    jmeas = jax.vmap(lambda *a: jbatch._plant_measurement(*a, jnp.float64))(
        q0, zeros, zeros, zeros, q0)
    jout = jax.tree.map(np.asarray, jbatch.batched_mpc_tick(jcarry, jmeas, jobs, jcfg))
    model = FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    carry, _, obs = to_torch(scenes, "cpu", torch.float64)
    meas = to_torch(jax.tree.map(np.asarray, jmeas), "cpu", torch.float64)
    tout = to_numpy(tbatch.batched_mpc_tick(carry, meas, obs, model))
    (jc, jrec), (tc, trec) = jout, tout
    assert set(trec) == set(jrec)
    for key in jrec:
        assert_trees_close(trec[key], jrec[key])
    assert_trees_close(tc, jc)
    return tout
