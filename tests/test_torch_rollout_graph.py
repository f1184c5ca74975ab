"""The rollout's scan on the CPU (`parallel.batch._rollout_step`,
`mpc.graph.StepGraph`, `mpc.graph.device_cond`).

On the card the graph route replays one CUDA graph a control period that
holds the plant's measurement, the tick, the escalation retry under a
conditional node and the plant's integration; the rollout state stays in
the graph's buffers. What the CPU can hold of it:

- (a) capture safety: one ``_rollout_step`` of the perf configuration
  and of 4 escalation lanes, with the retry's predicate false and true,
  runs under ``torch_host_guard.host_guard`` (no host data, no host
  read), and the step's device count of retried ticks reads 0 or 1;
- (b) the step graph's body (``model.graph = True`` on a CPU model: the
  scan's state in the graph's buffers, the retry run on every tick, as
  the card's eager warm-up runs it) equals the eager route bit for bit
  over 3 ticks of ``chunked_rollout`` in chunks of one scene, with the
  retry firing on tick 3 of scene 0 only: one step graph serves both
  chunks, and its count equals the eager route's ``retries``;
- (c) that body with 4 escalation lanes against the JAX package's jitted
  ``fleet_rollout`` (3 ticks) at ``test_torch_slice.py``'s tolerances;
- (d) ``gates.rollout_diag`` through its own step graph's body equals its
  eager loop bit for bit;
- (e) the launch bookkeeping of a branch: outside a capture
  ``device_cond`` runs the branch whatever its predicate and leaves its
  launches counted where they ran; a graph sets its warm-up's firings
  against the scan's count of firings, and returns its idle runs.

Scenes: ``.fleet_cache/test8.pkl`` scenes 0-1 in float64.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel.batch import fleet_rollout as jax_fleet_rollout
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch import gates
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import load, to_numpy, to_torch, tree_map
from torch_host_guard import host_guard

torch.set_num_threads(1)
FLEET8 = os.path.join(os.path.dirname(__file__), "..", ".fleet_cache", "test8.pkl")
TICKS = 3
ESC4 = dataclasses.replace(tconfig.perf_mpc_params(), esc_lanes=4)


def f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype.kind == "f" else a


@pytest.fixture(scope="module")
def scenes_np():
    payload = load(FLEET8)
    return tree_map(lambda a: f64(a)[:2], (payload["carry"], payload["q0"], payload["obs"]))


def scenes(scenes_np):
    return to_torch(scenes_np, "cpu", torch.float64)


def leaves(tree):
    out = []
    tree_map(lambda x: out.append(np.asarray(x)), tree)
    return out


def assert_bitwise(got, ref):
    got, ref = leaves(got), leaves(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


# ``esc_lanes=4`` at a base budget of 1 SQP x 2 IPM iterations from a rest
# state 0.3 rad (seeded) off the start: every lane fails, the retry runs
# (``test_torch_escalation.py``'s case)
STEP_CASES = {
    "perf": (tconfig.perf_mpc_params(), False, None),
    "esc4_not_taken": (ESC4, True, 0),
    "esc4_taken": (dataclasses.replace(ESC4, sqp_iters=1, qp_iters=2), True, 1),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_rollout_step_is_capture_safe(name, scenes_np):
    """(a) No host data and no host read inside one step of the scan."""
    cfg, escalate, fired = STEP_CASES[name]
    carry, q0, obs = scenes(scenes_np)
    if fired:
        q0 = q0 + torch.from_numpy(0.3 * np.random.default_rng(4).normal(size=q0.shape))
    model = FleetMPC(cfg, device="cpu", dtype=torch.float64)
    state = tbatch._initial_state(carry, q0)
    with host_guard():
        new, rec = tbatch._rollout_step(state, obs, cfg, model.st, escalate)
    assert len(new) == len(state) and set(rec) == {"phi", "q", "p", "success", "viol"}
    assert torch.isfinite(rec["q"]).all()
    if fired is not None:
        # fired: every lane failed the base budget and the retry rescued it
        assert int(new[-1]) == fired and bool(rec["success"].all())


@pytest.fixture(scope="module")
def esc4_routes(scenes_np):
    """3 ticks of 4 escalation lanes through the step graph's body and
    eagerly, in chunks of one scene: (body result, body model, its
    retries), (eager result, its retries)."""
    out = []
    for route in ("body", "eager"):
        model = FleetMPC(ESC4, device="cpu", dtype=torch.float64)
        model.graph = route == "body"
        tbatch._escalate_failed_lanes.retries = 0
        res = to_numpy(tbatch.chunked_rollout(*scenes(scenes_np), model, TICKS, chunk=1))
        out.append((res, model, tbatch._escalate_failed_lanes.retries))
    return out


def test_step_graph_body_equals_eager_rollout(esc4_routes):
    """(b) One step graph for both chunks; the retry fired once (scene 0,
    tick 3), by the graph's count and by the eager route's host check;
    records and final carry equal bit for bit."""
    (got, body, retries), (ref, eager, ref_retries) = esc4_routes
    assert retries == ref_retries == 1
    (key,) = body.graphs
    assert key[:3] == (tbatch._rollout_step, ESC4, (True,)) and not eager.graphs
    assert body.graphs[key].branch_launches == [0, 0, 0]   # the CPU counts no launch
    np.testing.assert_array_equal(got[1]["success"], np.ones((2, TICKS), bool))
    assert_bitwise(got, ref)


def test_step_graph_body_matches_jax_escalated_rollout(scenes_np, esc4_routes):
    """(c) The body with the retry against JAX's jitted ``fleet_rollout``
    at ``esc_lanes=4``, 2 scenes x 3 ticks, at the slice test's
    tolerances (q/phi/p 1e-6, viol 1e-8, flags exact, the final decision
    vector 1e-6 of its largest entry)."""
    carry, q0, obs = scenes_np
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jcfg = dataclasses.replace(perf_mpc_params(), esc_lanes=4)
    jfinal, jrecs = jax.tree.map(np.asarray, jax_fleet_rollout(
        jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs), jcfg, TICKS))
    (tfinal, trecs), _, _ = esc4_routes[0]
    np.testing.assert_array_equal(trecs["success"], jrecs["success"])
    for key in ("q", "phi", "p"):
        np.testing.assert_allclose(trecs[key], jrecs[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(trecs["viol"], jrecs["viol"], rtol=0, atol=1e-8)
    x_scale = np.abs(jfinal.x_prev).max()
    np.testing.assert_allclose(tfinal.x_prev, jfinal.x_prev, rtol=0, atol=1e-6 * x_scale)
    for name in ("split_idx", "switch", "has_prev", "error_count"):
        np.testing.assert_array_equal(getattr(tfinal, name), getattr(jfinal, name))


def test_rollout_diag_step_graph_body_equals_eager(scenes_np):
    """(d) ``rollout_diag`` through its step graph's body (its own key:
    its own step and record set) equals its eager loop bit for bit."""
    res = []
    for route in ("body", "eager"):
        model = FleetMPC(tconfig.perf_mpc_params(), device="cpu", dtype=torch.float64)
        model.graph = route == "body"
        res.append((to_numpy(gates.rollout_diag(*scenes(scenes_np), model, TICKS)), model))
    (got, body), (ref, _) = res
    (key,) = body.graphs
    assert key[:3] == (gates._diag_step, body.cfg, ())
    assert set(got[1]) == {"phi", "success", "viol", "err_cnt", "dq_max", "cost", "sector"}
    assert_bitwise(got, ref)


@pytest.mark.parametrize("held", [False, True])
def test_device_cond_outside_a_capture_counts_where_it_ran(held):
    """(e) The branch runs whatever ``pred`` says; a launch that it makes
    stays counted (it ran); ``pred`` goes to the graph around it."""
    from boundplanner_tpu_torch.mpc import graph as graph_mod

    wrapper = graph_mod.WRAPPERS[0]
    before = wrapper.launches
    out = torch.zeros(())

    def body():
        wrapper.launches += 1   # what a kernel's wrapper does where it launches
        out.add_(1.0)

    pred = torch.tensor(held)
    try:
        with graph_mod._branches() as got:
            graph_mod.device_cond(pred, body)
        assert wrapper.launches == before + 1 and float(out) == 1.0
    finally:
        wrapper.launches = before
    assert len(got.preds) == 1 and got.preds[0] is pred
    assert got.launches == [0, 0, 0] and not got.graphs


def test_graph_sets_warm_up_firings_against_the_count():
    """(e) A graph whose warm-up fired its branch once adds the branch's
    captured launches for the later firings only; one whose warm-up ran it
    idle adds them for every firing and returns that run; each warm-up is
    set against one count."""
    from boundplanner_tpu_torch.mpc import graph as graph_mod

    runner = graph_mod.Graph(lambda x: x + 1, (torch.zeros(2),))
    runner.branch_launches = [48, 1, 0]
    before = [w.launches for w in graph_mod.WRAPPERS]
    try:
        runner._warm_fired, runner._warm_idle = 1, 0
        assert runner.add_branch_launches(3) == 0
        assert [w.launches - b for w, b in zip(graph_mod.WRAPPERS, before)] == [96, 2, 0]
        runner._warm_fired, runner._warm_idle = 0, 1
        assert runner.add_branch_launches(2) == 1
        assert runner.add_branch_launches(1) == 0
        assert [w.launches - b for w, b in zip(graph_mod.WRAPPERS, before)] == [240, 5, 0]
    finally:
        for w, b in zip(graph_mod.WRAPPERS, before):
            w.launches = b
