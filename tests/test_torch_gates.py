"""The port's quality gates and diagnostics (``boundplanner_tpu_torch.gates``)
against the JAX package's tools:

- ``rollout_diag`` on scenes 43 and 56 of the cached 128-scene fleet,
  float64, ``perf_mpc_params()``, 3 ticks, against the JAX diagnostic loop
  of ``tools/replay_worst.py`` built here from the JAX package's own
  ``mpc_tick``, ``_plant_measurement`` and ``integrate_jerk_step`` (the
  script itself sets a compilation cache directory at import, so it is
  not imported): floats within 1e-7 of each record's largest entry,
  ``err_cnt``, ``sector`` and ``success`` exactly;
- a chronology's fields on hand-made records;
- ``obstacle_gate`` and ``tracks`` on hand-made rows: each bar trips
  alone.

``tests/test_torch_gates_replay.py`` holds the other gates to JAX.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params as jax_perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import _plant_measurement as jax_plant_measurement
from boundplanner_tpu.utils.integration import integrate_jerk_step as jax_integrate
from boundplanner_tpu_torch import gates
from boundplanner_tpu_torch.config import perf_mpc_params
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, tree_map

torch.set_num_threads(1)
ROOT = os.path.join(os.path.dirname(__file__), "..")
FLEET128 = os.path.join(ROOT, ".fleet_cache", "fleet_b128_s7_segs4.pkl")
SCENES = [43, 56]
TICKS = 3
FLOATS = ("phi", "viol", "dq_max", "cost")
EXACT = ("success", "err_cnt", "sector")


def jax_rollout_diag(carry, q0, obs, cfg, n_ticks):
    """``tools/replay_worst.py``'s ``rollout_diag`` (one scene)."""
    zeros = jnp.zeros_like(q0)

    def step(state, _):
        carry, q, dq, ddq, jerk, qf = state
        meas = jax_plant_measurement(q, dq, ddq, jerk, qf, q0.dtype)
        carry_new, out = jmpc.mpc_tick(carry, meas, obs, cfg)
        u0 = out["dddq"][0]
        u1 = out["dddq"][1]
        q_n, dq_n, ddq_n = jax_integrate(q, dq, ddq, u0, u1, cfg.dt)
        rec = {"phi": out["phi"][1], "success": out["success"], "viol": out["viol"],
               "err_cnt": carry_new.error_count, "dq_max": jnp.max(jnp.abs(dq)),
               "cost": out["cost"], "sector": out["sector"]}
        return (carry_new, q_n, dq_n, ddq_n, u1, out["q"][-1]), rec

    state, recs = jax.lax.scan(step, (carry, q0, zeros, zeros, zeros, q0), None,
                               length=n_ticks)
    return state[0], recs


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


@pytest.fixture(scope="module")
def fleet128():
    return load(FLEET128)


@pytest.fixture(scope="module")
def diag_both(fleet128):
    carry, q0, obs = tree_map(lambda a: f64(a)[SCENES],
                              (fleet128["carry"], fleet128["q0"], fleet128["obs"]))
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    cfg = jax_perf_mpc_params()
    roll = jax.jit(jax.vmap(lambda c, q, o: jax_rollout_diag(c, q, o, cfg, TICKS)[1]))
    jrecs = jax.tree.map(np.asarray, roll(jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs)))
    model = FleetMPC(perf_mpc_params(), device="cpu", dtype=torch.float64)
    _, trecs = gates.rollout_diag(*gates.fleet_tensors(fleet128, "cpu", torch.float64, SCENES),
                                  model, TICKS)
    return jrecs, to_numpy(trecs)


def test_rollout_diag_records_match_jax(diag_both):
    jrecs, trecs = diag_both
    assert set(trecs) == set(jrecs) == set(FLOATS + EXACT)
    for key in trecs:
        assert trecs[key].shape == jrecs[key].shape == (len(SCENES), TICKS), key
    for key in EXACT:
        np.testing.assert_array_equal(trecs[key], jrecs[key], err_msg=key)
    for key in FLOATS:
        scale = max(np.abs(jrecs[key]).max(), 1e-30)
        np.testing.assert_allclose(trecs[key], jrecs[key], rtol=0, atol=1e-7 * scale,
                                   err_msg=key)


def test_rollout_diag_exercises_failures(diag_both):
    """Scene 56 fails its first tick in float64 and then recovers; its
    error count stays 0 (a tick with no previous solution counts no
    error); scene 43 does not fail: the records carry a failing
    chronology."""
    jrecs, trecs = diag_both
    assert not trecs["success"][1, 0] and trecs["success"][1, 1:].all()
    assert trecs["err_cnt"].max() == 0
    assert trecs["success"][0].all()


def test_chronology_of_a_failing_scene():
    recs = {"success": np.array([[True, False, False, True, False]]),
            "viol": np.array([[0.0, 0.2, 0.1, 0.0, 0.05]]),
            "err_cnt": np.array([[0, 1, 2, 0, 1]]),
            "sector": np.array([[0, 0, 1, 1, 2]]),
            "phi": np.array([[0.0, 0.1, 0.2, 0.3, 0.4]]),
            "dq_max": np.array([[0.0, 0.1, 0.3, 0.2, 0.1]])}
    chron = gates.chronology(recs, 0)
    assert chron["failed_ticks"] == [1, 2, 4] and chron["first_fail_tick"] == 1
    assert chron["fails"] == 3 and chron["err_cnt_max"] == 2
    assert chron["sector_changes"] == [2, 4]
    assert chron["max_viol"] == 0.2 and chron["phi_final"] == 0.4


PASSING = {"ticks": 38, "stopped_by": "path_end", "path_end_reached": True, "fails": 0.0,
           "goal_err_m": 9.1e-4, "min_box_margin_m": 0.04}


@pytest.mark.parametrize("change, tripped", [
    ({}, set()),
    ({"ticks": 46}, {"path_end_within_ticks"}),
    ({"fails": 1.0}, {"no_fallbacks"}),
    ({"goal_err_m": 2.5e-3}, {"goal_err_within"}),
    ({"min_box_margin_m": -2e-5}, {"ee_outside_boxes"}),
    ({"path_end_reached": False}, {"path_end_within_ticks", "goal_err_within"}),
    ({"stopped_by": "seconds"}, {"path_end_within_ticks", "goal_err_within"}),
], ids=["pass", "ticks", "fallback", "goal_err", "collision", "not_reached", "capped"])
def test_obstacle_gate_bars_trip_alone(change, tripped):
    passed, bars = gates.obstacle_gate({**PASSING, **change})
    assert {name for name, ok in bars.items() if not ok} == tripped
    assert passed == (not tripped)


@pytest.mark.parametrize("phi, viol, success, ok, why", [
    ([0.0, 0.1, 0.2, 0.3], [0, 0, 0, 0], [1, 1, 1, 1], True, None),
    ([0.0, 0.1, 0.09, 0.3], [0, 0, 0, 0], [1, 1, 1, 1], False, "phi_monotone"),
    ([0.0, 0.1, 0.2, 0.3], [0, 0.02, 0, 0], [1, 0, 1, 1], False, "viol_under_1cm"),
    ([0.0, 0.1, 0.2, 0.3, 0.4], [0, 0, 0, 0, 0], [1, 0, 0, 0, 1], False, "longest_fail_run"),
    ([0.0, 0.1, 0.2, 0.3, 0.4], [0, 0, 0, 0, 0], [0, 0, 1, 0, 0], True, None),
], ids=["tracks", "phi_back", "viol", "three_fails", "two_fails"])
def test_tracks_bars_trip_alone(phi, viol, success, ok, why):
    passed, parts = gates.tracks(phi, viol, np.asarray(success, bool))
    assert passed == ok
    if why == "longest_fail_run":
        assert parts["longest_fail_run"] == 3 and parts["phi_monotone"]
    elif why is not None:
        assert not parts[why]


def test_box_margin():
    a = np.vstack([np.eye(3), -np.eye(3)])
    box = (a, np.r_[1.0, 1.0, 1.0, 0.0, 0.0, 0.0])       # the unit cube
    assert gates.box_margin([2.0, 0.5, 0.5], [box]) == pytest.approx(1.0)
    assert gates.box_margin([0.5, 0.5, 0.9], [box]) == pytest.approx(-0.1)
