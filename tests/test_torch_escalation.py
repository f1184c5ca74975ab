"""The port's budget escalation (``parallel.batch._escalate_failed_lanes``
in ``fleet_rollout``) against the JAX package's:

- the mechanics of tests/test_escalation.py with an injected fake tick
  that marks each retried lane with the pre-tick state it was given: only
  failed lanes are retried, capacity overflow keeps the base outputs, no
  failure is a no-op, all lanes at full capacity, and lanes past the
  streak limit are never retried. Both packages run the same fake tick
  (JAX's per lane under ``vmap``, the port's on the sub-batch) on the same
  state, and their outputs are equal;
- one real escalated tick: ``.fleet_cache/test8.pkl`` scenes 0-2 in
  float64 from a seeded perturbed rest state, at a base budget of 1 SQP x
  2 IPM iterations that every lane fails, with ``esc_lanes=2``: lanes 0
  and 1 are retried in a 2-wide sub-batch at 6 x 8 and succeed, lane 2
  overflows and keeps its base fallback. The records and every carry leaf
  but one agree with JAX's ``fleet_rollout`` within 1e-7 of each leaf's
  largest entry, and ``chunked_rollout`` carries the escalation through.
- no escalation where JAX has none: JAX's ``closed_loop_rollout`` (and so
  ``sharded_rollout`` and ``distributed_rollout``, which ``vmap`` it)
  ignores ``esc_lanes``. At the same escalated configuration the port's
  ``closed_loop_rollout`` of scene 0 and its ``sharded_rollout`` over one
  CPU device equal JAX's vmapped ``closed_loop_rollout`` at the slice
  test's tolerances, and the unescalated ``fleet_rollout`` of the same
  scenes bit for bit (each retried scene 0 and succeeded before).

  Two leaves are held apart (the numbers below: ``python
  tests/torch_config_drift.py --escalated-only``): the decision vector
  ``x_prev`` and the path slacks integrated from it (``prev_pslacks``,
  measured here by the test). Lane 1's retried solve
  (6 x 8 from a state 0.3 rad off the path) leaves its first path-slack
  rate dps_0 (entry 121) on a flat direction of the merit: two exact
  float64 factorizations in JAX (its masked Cholesky against
  ``jnp.linalg.cholesky``) put that entry 2.7e-5 apart and the merit at
  the solutions 6.5e-9 apart (of 13.36); the port is 6.9e-5 from JAX's
  there (2.9e-6 of max|x_prev|; ``prev_pslacks`` 3.5e-6), every other
  entry < 3e-7, and its merit lies between JAX's two, 3.2e-9 from each.
  So those two leaves are held within 1e-5 of their largest entry (at
  least 1), and the merit at the port's solution to the merit at JAX's
  within 1e-9 (relative).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu_torch.mpc import ocp as tocp
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC, build_tick_params
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.parallel.fleet_cache import to_numpy, to_torch, tree_map
from boundplanner_tpu_torch.parallel.mesh import make_mesh, sharded_rollout
from torch_tick_parity import assert_trees_close, configs, fleet_scenes, jax_inputs

torch.set_num_threads(1)


# --- mechanics with an injected fake tick -----------------------------------


def fake_state(xp, batch):
    """(carry_in, meas, obs, carry_n, out) of plain arrays (``xp`` numpy's
    ``jnp`` or torch); lane identity is encoded in the values."""
    lane = xp.arange(batch, dtype=xp.float64)
    carry_in = {"a": 100.0 + lane, "b": xp.stack([lane, lane + 0.5], 1)}
    meas = {"m": 200.0 + lane}
    obs = {"o": 300.0 + lane}
    carry_n = {"a": 400.0 + lane, "b": xp.stack([lane, lane - 0.5], 1)}
    out = {"y": 500.0 + lane}
    return carry_in, meas, obs, carry_n, out


def jax_fake_tick(c, m, o):
    """One lane (JAX vmaps it): the retried lane's marks."""
    return ({"a": c["a"] + 1000.0, "b": c["b"] + 1000.0},
            {"y": c["a"] * 1e6 + m["m"] * 1e3 + o["o"], "success": jnp.asarray(True)})


def port_fake_tick(c, m, o):
    """The sub-batch at once: the same marks."""
    return ({"a": c["a"] + 1000.0, "b": c["b"] + 1000.0},
            {"y": c["a"] * 1e6 + m["m"] * 1e3 + o["o"],
             "success": torch.ones_like(c["a"], dtype=torch.bool)})


def run_both(fail, esc_lanes, eligible=None, batch=6):
    """The escalation in both packages on the same fake state: (JAX's,
    the port's) (carry_in, carry_n, out, carry2, out2) as numpy, and the
    port's count of retried ticks."""
    jcfg, tcfg = configs(esc_lanes=esc_lanes)
    as_j = jnp.asarray
    as_t = lambda a: torch.from_numpy(np.asarray(a))
    res = []
    for xp, conv, esc, tick, cfg in (
            (jnp, as_j, jbatch._escalate_failed_lanes, jax_fake_tick, jcfg),
            (torch, as_t, tbatch._escalate_failed_lanes, port_fake_tick, tcfg)):
        carry_in, meas, obs, carry_n, out = fake_state(xp, batch)
        out = dict(out, success=conv(~np.asarray(fail)))
        elig = None if eligible is None else conv(eligible)
        tbatch._escalate_failed_lanes.retries = 0
        carry2, out2 = esc(carry_in, meas, obs, carry_n, out, cfg, tick_fn=tick, eligible=elig)
        res.append(to_numpy((carry_in, carry_n, out, carry2, out2)))
    (jres, tres) = res
    for jt, tt in zip(jres, tres):
        assert set(jt) == set(tt)
        for key in jt:
            np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)
    return tres, tbatch._escalate_failed_lanes.retries


def test_escalate_retries_only_failed_lanes():
    fail = np.array([False, True, False, True, False, False])
    (carry_in, carry_n, out, carry2, out2), retries = run_both(fail, esc_lanes=4)
    assert retries == 1
    for lane in range(6):
        if fail[lane]:
            # retried from the PRE-tick carry of that lane
            assert carry2["a"][lane] == carry_in["a"][lane] + 1000.0
            expect = (100.0 + lane) * 1e6 + (200.0 + lane) * 1e3 + 300.0 + lane
            assert out2["y"][lane] == expect and out2["success"][lane]
        else:
            assert carry2["a"][lane] == carry_n["a"][lane]
            assert out2["y"][lane] == out["y"][lane]
    np.testing.assert_array_equal(carry2["b"][~fail], carry_n["b"][~fail])


def test_escalate_capacity_overflow_keeps_base_fallback():
    fail = np.array([True, True, True, False, False, False])
    (_, carry_n, out, carry2, out2), _ = run_both(fail, esc_lanes=2)
    assert out2["success"][0] and out2["success"][1] and not out2["success"][2]
    assert out2["y"][2] == out["y"][2]
    assert carry2["a"][2] == carry_n["a"][2]


def test_escalate_no_failures_is_noop():
    (_, carry_n, out, carry2, out2), retries = run_both(np.zeros(6, bool), esc_lanes=4)
    assert retries == 0
    np.testing.assert_array_equal(out2["y"], out["y"])
    np.testing.assert_array_equal(carry2["a"], carry_n["a"])


def test_escalate_all_failed_full_capacity():
    (carry_in, _, _, carry2, out2), _ = run_both(np.ones(6, bool), esc_lanes=6)
    np.testing.assert_array_equal(carry2["a"], carry_in["a"] + 1000.0)
    assert out2["success"].all()


def test_escalate_streak_limit_stops_structural_retries():
    """A failing lane that is not eligible (its streak exhausted) keeps its
    base outputs, and no retry runs."""
    fail = np.array([True, False, False, False, False, False])
    (_, carry_n, out, carry2, out2), retries = run_both(fail, esc_lanes=2,
                                                        eligible=np.zeros(6, bool))
    assert retries == 0
    np.testing.assert_array_equal(out2["y"], out["y"])
    np.testing.assert_array_equal(carry2["a"], carry_n["a"])


# --- one real escalated tick ------------------------------------------------

ESC_FIELDS = dict(sqp_iters=1, qp_iters=2, esc_lanes=2)


@pytest.fixture(scope="module")
def escalated():
    """Scenes 0-2 from a rest state 0.3 rad (seeded) off the fleet's start,
    one tick in both packages; the port's sub-batch widths recorded."""
    carry, q0, obs = fleet_scenes(3)
    q0 = q0 + 0.3 * np.random.default_rng(4).normal(size=q0.shape)
    jcfg, tcfg = configs(**ESC_FIELDS)
    jcarry, jobs = jax_inputs((carry, q0, obs))
    jout = jax.tree.map(np.asarray, jbatch.fleet_rollout(jcarry, jnp.asarray(q0), jobs,
                                                         jcfg, 1))
    widths = []
    real_tick = tbatch.mpc_tick

    def counted_tick(c, m, o, cfg, st):
        widths.append(m["q0"].shape[0])
        return real_tick(c, m, o, cfg, st)

    inputs = to_torch((carry, q0, obs), "cpu", torch.float64)
    model = FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    base = to_numpy(tbatch.fleet_rollout(*inputs, FleetMPC(configs(**dict(
        ESC_FIELDS, esc_lanes=0))[1], device="cpu", dtype=torch.float64), 1))
    tbatch.mpc_tick, tbatch._escalate_failed_lanes.retries = counted_tick, 0
    try:
        tout = to_numpy(tbatch.fleet_rollout(*inputs, model, 1))
    finally:
        tbatch.mpc_tick = real_tick
    retries = tbatch._escalate_failed_lanes.retries
    chunked = to_numpy(tbatch.chunked_rollout(*inputs, model, 1, chunk=3))
    # the merit of a lane's decision vector on the pre-tick state
    c, q, o = inputs
    z = torch.zeros_like(q)
    esc_cfg = configs(sqp_iters=6, qp_iters=8)[1]
    params = build_tick_params(c, tbatch._plant_measurement(q, z, z, z, q, model.st.chain),
                               o, esc_cfg, model.st)[0]

    def merit(lane, x):
        r, g = tocp.evaluate(torch.from_numpy(x), {k: v[lane] for k, v in params.items()},
                             esc_cfg, model.st)
        return float(torch.sum(r * r) + esc_cfg.merit_penalty * torch.clamp(g, min=0).sum())

    return jout, tout, base, chunked, widths, retries, merit, (carry, q0, obs)


def test_escalated_tick_matches_jax(escalated):
    (jfinal, jrecs), (tfinal, trecs), (_, brecs), _, widths, retries, merit, _ = escalated
    # every lane fails the base budget; the retry rescues the first two
    assert not brecs["success"].any()
    np.testing.assert_array_equal(trecs["success"][:, 0], [True, True, False])
    assert retries == 1 and widths == [2]
    assert set(trecs) == set(jrecs)
    for key in jrecs:
        assert_trees_close(trecs[key], jrecs[key])
    flat = ("x_prev", "prev_pslacks")
    assert_trees_close(tfinal._replace(**{k: getattr(jfinal, k) for k in flat}), jfinal)
    for key in flat:
        assert_trees_close(getattr(tfinal, key), getattr(jfinal, key), tol=1e-5)
    for lane in (0, 1):
        m_port, m_jax = merit(lane, tfinal.x_prev[lane]), merit(lane, jfinal.x_prev[lane])
        assert abs(m_port - m_jax) <= 1e-9 * abs(m_jax), (lane, m_port, m_jax)
    # the overflowing lane keeps the base tick's fallback
    for key in trecs:
        np.testing.assert_array_equal(trecs[key][2], brecs[key][2])


def test_chunked_rollout_passes_escalation_through(escalated):
    _, (tfinal, trecs), _, (cfinal, crecs), _, _, _, _ = escalated
    for key in trecs:
        np.testing.assert_array_equal(crecs[key], trecs[key])
    np.testing.assert_array_equal(cfinal.x_prev, tfinal.x_prev)


# --- no escalation where JAX has none ---------------------------------------


@pytest.fixture(scope="module")
def unescalated_jax(escalated):
    """JAX's jitted ``closed_loop_rollout`` of the three scenes (vmapped,
    as its ``sharded_rollout`` runs it) at the escalated configuration."""
    carry, q0, obs = escalated[-1]
    jcfg = configs(**ESC_FIELDS)[0]
    jcarry, jobs = jax_inputs((carry, q0, obs))
    roll = jax.vmap(lambda c, q, o: jbatch.closed_loop_rollout(c, q, o, jcfg, 1))
    return jax.tree.map(np.asarray, roll(jcarry, jnp.asarray(q0), jobs))


def assert_slice_close(final, recs, jfinal, jrecs):
    """``test_torch_slice.py``'s tolerances: q/phi/p 1e-6, viol 1e-8, flags
    exact, the final decision vector 1e-6 of its largest entry."""
    np.testing.assert_array_equal(recs["success"], jrecs["success"])
    for key in ("q", "phi", "p"):
        np.testing.assert_allclose(recs[key], jrecs[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(recs["viol"], jrecs["viol"], rtol=0, atol=1e-8)
    x_scale = np.abs(jfinal.x_prev).max()
    np.testing.assert_allclose(final.x_prev, jfinal.x_prev, rtol=0, atol=1e-6 * x_scale)
    for name in ("split_idx", "switch", "has_prev", "error_count"):
        np.testing.assert_array_equal(getattr(final, name), getattr(jfinal, name))


def assert_bitwise(got, ref):
    got_leaves, ref_leaves = [], []
    tree_map(got_leaves.append, got)
    tree_map(ref_leaves.append, ref)
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_array_equal(g, r)


def test_closed_loop_rollout_does_not_escalate(escalated, unescalated_jax):
    """Scene 0 fails the base budget; JAX's closed loop keeps the failure,
    and so does the port's at ``esc_lanes=2``: equal to the unescalated
    ``fleet_rollout`` of scene 0 bit for bit. That one runs at batch 1 too
    (the base rollout's batch 3 rounds a few entries 1 ulp apart)."""
    inputs = to_torch(tree_map(lambda a: a[:1], escalated[-1]), "cpu", torch.float64)
    unescalated = FleetMPC(configs(**dict(ESC_FIELDS, esc_lanes=0))[1], device="cpu",
                           dtype=torch.float64)
    base = to_numpy(tbatch.fleet_rollout(*inputs, unescalated, 1))
    model = FleetMPC(configs(**ESC_FIELDS)[1], device="cpu", dtype=torch.float64)
    tbatch._escalate_failed_lanes.retries = 0
    first = lambda t: t[0]
    final, recs = to_numpy(tbatch.closed_loop_rollout(*tree_map(first, inputs), model, 1))
    assert tbatch._escalate_failed_lanes.retries == 0
    assert not recs["success"].any()
    jfinal, jrecs = unescalated_jax
    assert_slice_close(final, recs, *tree_map(first, (jfinal, jrecs)))
    assert_bitwise((final, recs), tree_map(first, base))


def test_sharded_rollout_does_not_escalate(escalated, unescalated_jax):
    """``sharded_rollout`` over one CPU device at ``esc_lanes=2``: JAX's
    vmapped closed loop, and the unescalated rollout bit for bit."""
    _, _, base, _, _, _, _, inputs = escalated
    tbatch._escalate_failed_lanes.retries = 0
    final, recs, diag = sharded_rollout(*to_torch(inputs, "cpu", torch.float64),
                                        configs(**ESC_FIELDS)[1], 1, make_mesh(devices=["cpu"]))
    final, recs = to_numpy((final, recs))
    assert tbatch._escalate_failed_lanes.retries == 0
    assert diag["success_rate"] == 0.0
    assert_slice_close(final, recs, *unescalated_jax)
    assert_bitwise((final, recs), base)
