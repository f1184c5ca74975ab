"""The port's closed-loop slice against the JAX package, end to end:
``parallel.batch.fleet_rollout`` (plant FK -> fused MPC tick -> jerk
integration) on ``.fleet_cache/test8.pkl`` scenes 0-1 cast to float64,
3 ticks of the perf configuration.

Tolerances: every tick runs 3 SQP x 4 IPM iterations through explicit
inverses of KKT matrices with condition ~1e8, plus the 25-iteration
projection IPM of the link sets; f64 summation-order noise grows to
~4e-8 in q/phi/p (measured) and is held at 1e-6. The final decision
vector (jerks up to ~1e2) is held at 1e-6 relative to its largest entry.
Scene 0 fails tick 3 by a hair (viol 1.16e-4 against the 1e-4 bar) in
both packages: the success flags must agree exactly.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel.batch import fleet_rollout
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch, tree_map

torch.set_num_threads(1)
CFG = perf_mpc_params()
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")
TICKS = 3


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


@pytest.fixture(scope="module")
def rollouts():
    payload = load(FLEET8)
    carry, q0, obs = tree_map(lambda a: f64(a)[:2],
                              (payload["carry"], payload["q0"], payload["obs"]))
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jfinal, jrecs = jax_fleet_rollout(jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs),
                                      CFG, TICKS)
    model = FleetMPC(CFG).to(torch.float64)
    tfinal, trecs = fleet_rollout(*to_torch((carry, q0, obs), "cpu", torch.float64),
                                  model, TICKS)
    return (jax.tree.map(np.asarray, (jfinal, jrecs)), to_numpy((tfinal, trecs)))


def test_records_match_jax(rollouts):
    (_, jrecs), (_, trecs) = rollouts
    assert set(jrecs) == set(trecs) == {"phi", "q", "p", "success", "viol"}
    for key in jrecs:
        assert trecs[key].shape == jrecs[key].shape
    np.testing.assert_array_equal(trecs["success"], jrecs["success"])
    assert not jrecs["success"].all()          # the marginal tick is exercised
    for key in ("q", "phi", "p"):
        np.testing.assert_allclose(trecs[key], jrecs[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(trecs["viol"], jrecs["viol"], rtol=0, atol=1e-8)


def test_final_carry_matches_jax(rollouts):
    (jfinal, _), (tfinal, _) = rollouts
    x_scale = np.abs(jfinal.x_prev).max()
    np.testing.assert_allclose(tfinal.x_prev, jfinal.x_prev, rtol=0, atol=1e-6 * x_scale)
    for name in ("split_idx", "switch", "has_prev", "error_count"):
        np.testing.assert_array_equal(getattr(tfinal, name), getattr(jfinal, name))
    np.testing.assert_array_equal(tfinal.path.sector, jfinal.path.sector)
    for name in ("phi_current", "pr_ref", "iw_ref", "slacks0", "prev_q", "prev_p"):
        np.testing.assert_allclose(getattr(tfinal, name), getattr(jfinal, name),
                                   rtol=0, atol=1e-6)
