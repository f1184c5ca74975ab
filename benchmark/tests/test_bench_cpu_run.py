"""Whole runs of the benchmark on the CPU at a small size, with the look for
a card skipped: a sound run comes out correct with nothing failed, and a
run whose timed path is broken underneath comes out not correct, once for
each fault a cell can have (one card, so no exchange between cards to
leave out):

- a step that returns its state unchanged;
- half of the batch left out (its scenes keep and report their state);
- an answer altered where it is produced.

On the CPU the port's float32 tick takes the exact IPM for its link sets
(the card runs kernel B's Dykstra projection), so these runs give the
reference the same route.
"""

import argparse

import numpy as np
import pytest
import torch

from benchmark import harness

FLEET = {"scenes": 4, "chunk": 4, "ticks": 10}
ARM = {"leg_periods": 2, "warm_periods": 1, "judged_periods": 1, "judged_handoffs": 1,
       "judged_within": 1}


def _run(workload, traffic, seconds=0.5, seed=2**31 + 7):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0)
    torch.set_num_threads(4)
    return harness.run(args, device="cpu", check_device=False, traffic_overrides=traffic,
                       config_overrides={"link_route": "ipm"})


@pytest.fixture
def batch_mod():
    from boundplanner_tpu_torch.parallel import batch

    return batch


def test_fleet_sound_run_is_correct():
    res = _run("fleet128.perf_f32", FLEET)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks" and res["metrics"]["setup_s"]["value"] > 0


def _broken_advance(batch, how):
    advance = batch._advance

    def broken(state, carry_n, out, meas, dt):
        new, record = advance(state, carry_n, out, meas, dt)
        if how == "unchanged":
            return state, record
        if how == "half":
            # the second half's scenes never step: they keep and report
            # their state, as if the tick had left them out
            half = record["q"].shape[0] // 2
            keep = lambda t_new, t_old: torch.cat([t_new[:half], t_old[half:]])
            new = tuple(batch.tree_map(keep, a, b) for a, b in zip(new[:-1], state[:-1])) \
                + (new[-1],)
            record = dict(record, q=keep(record["q"], state[1]),
                          phi=keep(record["phi"], state[0].phi_current))
            return new, record
        if how == "altered":
            record = dict(record)
            record["q"] = record["q"] + 1e-2       # the reported joint state
            return new, record
        raise ValueError(how)

    return broken


@pytest.mark.parametrize("how", ["unchanged", "half", "altered"])
def test_fleet_broken_timed_path_is_not_correct(monkeypatch, batch_mod, how):
    monkeypatch.setattr(batch_mod, "_advance", _broken_advance(batch_mod, how))
    res = _run("fleet128.perf_f32", FLEET)
    assert not res["correct"], res["checks"]


def test_arm_sound_run_is_correct():
    res = _run("arm_shuttle.default_f64", ARM, seconds=0.1)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("how", ["unchanged", "altered"])
def test_arm_broken_timed_path_is_not_correct(monkeypatch, how):
    from boundplanner_tpu_torch.mpc import node

    integrate = node.integrate_jerk_step

    def broken(q, dq, ddq, u0, u1, dt):
        q_n, dq_n, ddq_n = integrate(q, dq, ddq, u0, u1, dt)
        if how == "unchanged":
            return np.array(q), np.array(dq), np.array(ddq)
        return q_n + 1e-3, dq_n, ddq_n

    monkeypatch.setattr(node, "integrate_jerk_step", broken)
    res = _run("arm_shuttle.default_f64", ARM, seconds=0.1)
    assert not res["correct"], res["checks"]
