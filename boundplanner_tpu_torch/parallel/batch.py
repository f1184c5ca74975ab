"""Scene batching and closed-loop rollouts (port of ``make_batch_scene``,
``batched_mpc_tick``, ``_plant_measurement``, ``closed_loop_rollout``,
``_escalate_failed_lanes``, ``fleet_rollout`` and ``chunked_rollout`` of
``boundplanner_tpu/parallel/batch.py``).

The JAX package's jitted ``lax.scan`` over ticks becomes a Python loop
with a fixed trip count whose tick replays one CUDA graph on the card
(`FleetMPC.tick`: one graph per configuration and input signature, the
JAX package's compiled tick); the plant step between ticks runs eagerly.
The scene axis is the leading axis of every tensor. Where the JAX
functions take the static ``cfg``, these take the
`mpc.bound_mpc.FleetMPC` module that carries it with its buffers.

With ``cfg.esc_lanes > 0`` a tick whose failing lanes are still eligible
re-runs the whole tick for the first ``esc_lanes`` of them at the
escalated budget (``esc_sqp_iters`` / ``esc_qp_iters``), in a sub-batch of
fixed width, through the model's graph of that width and budget. Whether
any lane failed is JAX's batch-level ``lax.cond``; here it is one host
check per tick, between the two graphs. ``esc_pallas``, like ``pallas_kkt``,
chooses nothing: the retry factors through kernel A as every tick does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import MPCParams
from ..mpc.bound_mpc import FleetMPC, MPCCarry, init_carry, mpc_tick
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


def _escalation_tick(model: FleetMPC):
    """The retry's tick: the model's structure at the escalated budget, with
    its own graph."""
    cfg = dataclasses.replace(model.cfg, sqp_iters=model.cfg.esc_sqp_iters,
                              qp_iters=model.cfg.esc_qp_iters, esc_lanes=0)
    return lambda c, m, o: model.run(mpc_tick, cfg, c, m, o)


def _escalate_failed_lanes(carry_in, meas, obs, carry_n, out, cfg: MPCParams, tick_fn,
                           eligible=None):
    """Re-tick the first ``k = min(cfg.esc_lanes, batch)`` failing (and
    ``eligible``) lanes from their pre-tick ``carry_in``/``meas``/``obs``
    with ``tick_fn`` (batched: a k-wide sub-batch), and write the retried
    (carry, outputs) over ``carry_n``/``out`` for those lanes only.

    The sub-batch is always k wide (f32 results move with the batch
    shape, and JAX's retry is k wide): fill positions take index ``batch``,
    gather lane ``batch - 1`` and are dropped on the scatter. A retry that
    fails again reproduces the base tick's fallback, so writing it back
    changes nothing. Lanes past capacity keep their base outputs. Counts
    the ticks whose retry ran in ``_escalate_failed_lanes.retries``."""
    fail = ~out["success"]
    if eligible is not None:
        fail = fail & eligible
    if not bool(fail.any()):
        return carry_n, out
    _escalate_failed_lanes.retries += 1
    batch = fail.shape[0]
    k = min(cfg.esc_lanes, batch)
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


_escalate_failed_lanes.retries = 0


@torch.no_grad()
def fleet_rollout(carry_b: MPCCarry, q0_b, obs_b: ObstacleArrays,
                  model: FleetMPC, n_ticks: int):
    """Closed-loop rollout of a batch of scenes: FK -> MPC tick -> apply the
    first jerk -> integrate the joint state, ``n_ticks`` times. Returns
    (final carry, records with leaves (B, n_ticks, ...)).

    With ``esc_lanes > 0`` failing lanes are retried at the escalated
    budget (:func:`_escalate_failed_lanes`) while their streak of failed
    ticks is below ``esc_streak_limit``; the streak lives in the rollout,
    not in the carry."""
    cfg = model.cfg
    esc_tick = _escalation_tick(model) if cfg.esc_lanes > 0 else None
    zeros = torch.zeros_like(q0_b)
    carry, q, dq, ddq, jerk, qf = carry_b, q0_b, zeros, zeros, zeros, q0_b
    streak = torch.zeros(q0_b.shape[0], dtype=torch.int32, device=q0_b.device)
    recs = []
    for _ in range(n_ticks):
        meas = _plant_measurement(q, dq, ddq, jerk, qf, model.st.chain)
        carry_n, out = model.tick(carry, meas, obs_b)
        if esc_tick is not None:
            carry_n, out = _escalate_failed_lanes(carry, meas, obs_b, carry_n, out, cfg,
                                                  esc_tick,
                                                  eligible=streak < cfg.esc_streak_limit)
        streak = torch.where(out["success"], 0, streak + 1)
        carry = carry_n
        u0 = out["dddq"][:, 0]
        u1 = out["dddq"][:, 1]
        q_n, dq, ddq = integrate_jerk_step(q, dq, ddq, u0, u1, cfg.dt)
        recs.append({
            "phi": out["phi"][:, 1],
            "q": q_n,
            "p": meas["p0"],
            "success": out["success"],
            "viol": out["viol"],
        })
        q, jerk, qf = q_n, u1, out["q"][:, -1]
    records = {k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}
    return carry, records


def closed_loop_rollout(carry: MPCCarry, q0, obs: ObstacleArrays,
                        model: FleetMPC, n_ticks: int):
    """Closed-loop rollout of ONE scene (leaves without a scene axis), as a
    batch of one through :func:`fleet_rollout`. Returns (final carry,
    records with leaves (n_ticks, ...))."""
    add = lambda t: t[None]
    final, recs = fleet_rollout(tree_map(add, carry), q0[None], tree_map(add, obs),
                                model, n_ticks)
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
    after the other. The batch must be divisible by ``chunk``."""
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
