"""Scene batching and closed-loop rollouts (port of ``make_batch_scene``,
``batched_mpc_tick``, ``_plant_measurement``, ``closed_loop_rollout``,
``fleet_rollout`` and ``chunked_rollout`` of
``boundplanner_tpu/parallel/batch.py``).

The JAX package's ``lax.scan`` over ticks becomes a Python loop with a
fixed trip count; the scene axis is the leading axis of every tensor.
Where the JAX functions take the static ``cfg``, these take the
`mpc.bound_mpc.FleetMPC` module that carries it with its buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import MPCParams
from ..mpc.bound_mpc import FleetMPC, MPCCarry, init_carry
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


@torch.no_grad()
def fleet_rollout(carry_b: MPCCarry, q0_b, obs_b: ObstacleArrays,
                  model: FleetMPC, n_ticks: int):
    """Closed-loop rollout of a batch of scenes: FK -> MPC tick -> apply the
    first jerk -> integrate the joint state, ``n_ticks`` times. Returns
    (final carry, records with leaves (B, n_ticks, ...))."""
    cfg = model.cfg
    if cfg.esc_lanes > 0:
        raise NotImplementedError("fleet_rollout: esc_lanes>0 is not ported")
    zeros = torch.zeros_like(q0_b)
    carry, q, dq, ddq, jerk, qf = carry_b, q0_b, zeros, zeros, zeros, q0_b
    recs = []
    for _ in range(n_ticks):
        meas = _plant_measurement(q, dq, ddq, jerk, qf, model.st.chain)
        carry, out = model.tick(carry, meas, obs_b)
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
