"""Scene batching and closed-loop rollouts (port of ``make_batch_scene``,
``batched_mpc_tick``, ``_plant_measurement``, ``closed_loop_rollout``,
``_escalate_failed_lanes``, ``fleet_rollout`` and ``chunked_rollout`` of
``boundplanner_tpu/parallel/batch.py``).

The JAX package runs a rollout as one jitted ``lax.scan`` whose body is
the plant's measurement, the tick, the escalation retry and the plant's
integration. Here that body is `_rollout_step`, a function of the
rollout state. On the graph route (`FleetMPC`'s default on the card) the
model replays one CUDA graph of it per control period
(`FleetMPC.step_graph`, one per configuration, escalation and input
signature, ``n_ticks`` not among them): the state stays on the card in
the graph's buffers, and nothing between the first tick and the last
waits for the card. The eager route (``graph=False``, and the CPU) loops
over `FleetMPC.tick` and the plant step in Python. The scene axis is the
leading axis of every tensor. Where the JAX functions take the static
``cfg``, these take the `mpc.bound_mpc.FleetMPC` module that carries it
with its buffers.

With ``cfg.esc_lanes > 0`` `fleet_rollout` re-runs the whole tick for the
first ``esc_lanes`` failing lanes that are still eligible, at the
escalated budget (``esc_sqp_iters`` / ``esc_qp_iters``), in a sub-batch of
fixed width. Whether any lane failed is JAX's batch-level ``lax.cond``:
on the graph route a conditional node of the step's graph
(`mpc.graph.device_cond`), on the eager route one host check per tick.
``closed_loop_rollout`` has no retry, as in JAX. ``esc_pallas``, like
``pallas_kkt``, chooses nothing: the retry factors through kernel A as
every tick does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MPCParams
from ..mpc.bound_mpc import FleetMPC, MPCCarry, init_carry, mpc_tick
from ..mpc.graph import device_cond
from ..planner.set_finder import ObstacleArrays, build_obstacle_arrays
from ..robot import kinematics as kin
from ..utils.device import DEFAULT_DEVICE, checked_device
from ..utils.integration import integrate_jerk_step
from ..utils.tree import to_torch, tree_map, tree_stack


def make_batch_scene(paths, p0s, obstacles_list, cfg: MPCParams, device=DEFAULT_DEVICE,
                     dtype=torch.float32):
    """Stack per-scene paths (`path.reference_path.build_path`), start poses
    and obstacle lists into a batched carry and obstacle arrays (leading
    scene axis) on ``device``, floating leaves in ``dtype``."""
    device = checked_device(device)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    carries = [init_carry(p, np.asarray(q), cfg, np_dtype) for p, q in zip(paths, p0s)]
    obs = [build_obstacle_arrays(o) for o in obstacles_list]
    return to_torch(tree_stack(carries), device, dtype), to_torch(tree_stack(obs), device, dtype)


def batched_mpc_tick(carry: MPCCarry, meas: dict, obs: ObstacleArrays, model: FleetMPC):
    """One control period for a whole fleet: `FleetMPC.tick`."""
    return model.tick(carry, meas, obs)


def _plant_measurement(q, dq, ddq, jerk, qf, chain):
    pose = kin.fk_pose(q, chain)
    jac = kin.jacobian_fk(q, chain)
    return {
        "q0": q,
        "dq0": dq,
        "ddq0": ddq,
        "p0": pose,
        "v0": (jac @ dq[..., None])[..., 0],
        "u0": jerk,
        "qf": qf,
    }


def _escalation_tick(cfg: MPCParams, st):
    """The retry's tick: ``mpc_tick`` with the model's structure ``st`` at
    the escalated budget."""
    cfg = dataclasses.replace(cfg, sqp_iters=cfg.esc_sqp_iters, qp_iters=cfg.esc_qp_iters,
                              esc_lanes=0)
    return lambda c, m, o: mpc_tick(c, m, o, cfg, st)


def _retry(fail, carry_in, meas, obs, carry_n, out, esc_lanes: int, tick_fn):
    """The retry itself: the first ``k = min(esc_lanes, batch)`` lanes of
    ``fail`` re-ticked by ``tick_fn`` in a k-wide sub-batch and written
    over ``carry_n``/``out`` (new trees). Where fewer lanes fail, the rest
    of the sub-batch are fills: they gather lane ``batch - 1`` and write a
    spare row that is dropped, so with no failing lane the values stay as
    they were."""
    batch = fail.shape[0]
    k = min(esc_lanes, batch)
    # the first k failing lanes in index order (a stable sort puts them
    # first), then fills
    first = torch.argsort((~fail).to(torch.int8), stable=True)[:k]
    idx = torch.where(fail[first], first, batch)
    gidx = torch.clamp(idx, max=batch - 1)
    take = lambda t: t[gidx]
    sub_c, sub_out = tick_fn(tree_map(take, carry_in), tree_map(take, meas),
                             tree_map(take, obs))

    def scatter(full, sub):
        # one spare row takes the fills' writes, then goes
        ext = torch.cat([full, full[:1]])
        ext[idx] = sub
        return ext[:batch]

    return tree_map(scatter, carry_n, sub_c), tree_map(scatter, out, sub_out)


def _escalate_failed_lanes(carry_in, meas, obs, carry_n, out, cfg: MPCParams, tick_fn,
                           eligible=None):
    """Re-tick the first ``k = min(cfg.esc_lanes, batch)`` failing (and
    ``eligible``) lanes from their pre-tick ``carry_in``/``meas``/``obs``
    with ``tick_fn`` (batched: a k-wide sub-batch), and write the retried
    (carry, outputs) over ``carry_n``/``out`` for those lanes only: the
    eager route's retry, behind one host check (the step graph's branch
    is `_rollout_step`'s `device_cond`).

    The sub-batch is always k wide (f32 results move with the batch
    shape, and JAX's retry is k wide): fill positions take index ``batch``,
    gather lane ``batch - 1`` and are dropped on the scatter. A retry that
    fails again reproduces the base tick's fallback, so writing it back
    changes nothing. Lanes past capacity keep their base outputs. Counts
    the ticks whose retry ran in ``_escalate_failed_lanes.retries``; the
    step graph adds its count from the card after a scan, and the runs of
    its warm-up's retry where no lane failed to ``.idle_runs``."""
    fail = ~out["success"]
    if eligible is not None:
        fail = fail & eligible
    if not bool(fail.any()):
        return carry_n, out
    _escalate_failed_lanes.retries += 1
    return _retry(fail, carry_in, meas, obs, carry_n, out, cfg.esc_lanes, tick_fn)


_escalate_failed_lanes.retries = 0
_escalate_failed_lanes.idle_runs = 0


def _advance(state, carry_n, out, meas, dt):
    """The scan body's tail: the failure streak, the plant's integration of
    the first jerk, and the tick's record."""
    _, q, dq, ddq, _, _, streak, fired = state
    streak = torch.where(out["success"], 0, streak + 1)
    u0 = out["dddq"][:, 0]
    u1 = out["dddq"][:, 1]
    q_n, dq_n, ddq_n = integrate_jerk_step(q, dq, ddq, u0, u1, dt)
    record = {
        "phi": out["phi"][:, 1],
        "q": q_n,
        "p": meas["p0"],
        "success": out["success"],
        "viol": out["viol"],
    }
    return (carry_n, q_n, dq_n, ddq_n, u1, out["q"][:, -1], streak, fired), record


def _rollout_step(state, obs: ObstacleArrays, cfg: MPCParams, st, escalate: bool):
    """One control period of the rollout, JAX's ``fleet_rollout`` scan
    body: the plant's measurement, the tick, the retry under
    `device_cond` (``escalate``; only lanes whose streak of failed ticks
    is below ``esc_streak_limit``), the streak, the integration and the
    record. ``state`` is (carry, q, dq, ddq, jerk, qf, streak, fired):
    ``fired`` counts the ticks whose retry ran. Returns (state', record).
    Nothing in it reads the card from the host."""
    carry, q, dq, ddq, jerk, qf, streak, fired = state
    meas = _plant_measurement(q, dq, ddq, jerk, qf, st.chain)
    carry_n, out = mpc_tick(carry, meas, obs, cfg, st)
    if escalate:
        fail = ~out["success"] & (streak < cfg.esc_streak_limit)
        pred = fail.any()

        def retry():
            # in place, for the branch's writes to outlive it
            tree_map(lambda dst, src: dst.copy_(src), (carry_n, out),
                     _retry(fail, carry, meas, obs, carry_n, out, cfg.esc_lanes,
                            _escalation_tick(cfg, st)))
            fired.add_(pred.to(fired.dtype))

        device_cond(pred, retry)
    return _advance(state, carry_n, out, meas, cfg.dt)


def _initial_state(carry_b: MPCCarry, q0_b):
    zeros = torch.zeros_like(q0_b)
    streak = torch.zeros(q0_b.shape[0], dtype=torch.int32, device=q0_b.device)
    fired = torch.zeros((), dtype=torch.int64, device=q0_b.device)
    return (carry_b, q0_b, zeros, zeros, zeros, q0_b, streak, fired)


def _stack(records: list) -> dict:
    return {k: torch.stack([r[k] for r in records], dim=1) for k in records[0]}


@torch.no_grad()
def _rollout(carry_b: MPCCarry, q0_b, obs_b: ObstacleArrays, model: FleetMPC, n_ticks: int,
             escalate: bool):
    """The closed loop of :func:`fleet_rollout`, with the retry or without
    (``escalate``). On the graph route the count of retried ticks is read
    once, after the last tick: it adds the retry's launches,
    ``_escalate_failed_lanes.retries`` and ``.idle_runs``."""
    cfg = model.cfg
    state = _initial_state(carry_b, q0_b)
    if model.graph:
        runner = model.step_graph(_rollout_step, state, obs_b, escalate)
        state, recs = runner.scan(state, obs_b, n_ticks)
        if escalate:
            fired = int(state[-1])
            _escalate_failed_lanes.idle_runs += runner.add_branch_launches(fired)
            _escalate_failed_lanes.retries += fired
        return state[0], _stack(recs)
    esc_tick = _escalation_tick(cfg, model.st) if escalate else None
    recs = []
    for _ in range(n_ticks):
        carry, q, dq, ddq, jerk, qf, streak, _ = state
        meas = _plant_measurement(q, dq, ddq, jerk, qf, model.st.chain)
        carry_n, out = model.tick(carry, meas, obs_b)
        if escalate:
            carry_n, out = _escalate_failed_lanes(carry, meas, obs_b, carry_n, out, cfg,
                                                  esc_tick,
                                                  eligible=streak < cfg.esc_streak_limit)
        state, rec = _advance(state, carry_n, out, meas, cfg.dt)
        recs.append(rec)
    return state[0], _stack(recs)


def fleet_rollout(carry_b: MPCCarry, q0_b, obs_b: ObstacleArrays,
                  model: FleetMPC, n_ticks: int):
    """Closed-loop rollout of a batch of scenes: FK -> MPC tick -> apply the
    first jerk -> integrate the joint state, ``n_ticks`` times. Returns
    (final carry, records with leaves (B, n_ticks, ...)).

    With ``esc_lanes > 0`` failing lanes are retried at the escalated
    budget (:func:`_escalate_failed_lanes`) while their streak of failed
    ticks is below ``esc_streak_limit``; the streak lives in the rollout,
    not in the carry."""
    return _rollout(carry_b, q0_b, obs_b, model, n_ticks, model.cfg.esc_lanes > 0)


def closed_loop_rollout(carry: MPCCarry, q0, obs: ObstacleArrays,
                        model: FleetMPC, n_ticks: int):
    """Closed-loop rollout of ONE scene (leaves without a scene axis), as a
    batch of one, without the escalation retry whatever ``esc_lanes``
    says (JAX's ``closed_loop_rollout`` has none). Returns (final carry,
    records with leaves (n_ticks, ...))."""
    add = lambda t: t[None]
    final, recs = _rollout(tree_map(add, carry), q0[None], tree_map(add, obs), model, n_ticks,
                           escalate=False)
    drop = lambda t: t[0]
    return tree_map(drop, final), tree_map(drop, recs)


def _slice(tree, lo, hi):
    if isinstance(tree, tuple):
        return type(tree)(*(_slice(t, lo, hi) for t in tree))
    return tree[lo:hi]


def _concat(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*(_concat(list(ps)) for ps in zip(*parts)))
    return torch.cat(parts, dim=0)


def chunked_rollout(carry_b: MPCCarry, q0_b, obs_b: ObstacleArrays,
                    model: FleetMPC, n_ticks: int, chunk: int = 128):
    """Closed-loop rollout of a fleet in fixed-width chunks of scenes, one
    after the other (on the graph route every chunk replays the same step
    graph, as JAX's ``lax.map`` runs one program). The batch must be
    divisible by ``chunk``."""
    bsz = q0_b.shape[0]
    if bsz % chunk:
        raise ValueError(f"batch {bsz} not divisible by chunk {chunk}")
    finals, recs = [], []
    for lo in range(0, bsz, chunk):
        hi = lo + chunk
        c, r = fleet_rollout(_slice(carry_b, lo, hi), q0_b[lo:hi],
                             _slice(obs_b, lo, hi), model, n_ticks)
        finals.append(c)
        recs.append(r)
    return _concat(finals), _concat(recs)
