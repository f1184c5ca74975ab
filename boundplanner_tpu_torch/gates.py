"""The JAX package's quality gates and diagnostics, run by the port.

Every solver change of the JAX package was adopted against four gates
(``tools/gate_obstacle.py``): 1. the obstacle gate (a table and a pillar,
``MPCNode`` at the f32 perf configuration), 2. the scene-43 replay (batch
1, 30 ticks), 3. the 128-scene fleet for 20 ticks, 4. the same fleet for
50 ticks; with two diagnostics, the worst scenes' chronologies
(``tools/replay_worst.py``) and the escalation probe
(``tools/probe_escalation.py``). These are the same functions on the
port's API:

- :func:`rollout_diag`: the closed loop with the diagnostic record set;
- :func:`long_horizon`: gate 4 (``chunked_rollout``), then the same
  inputs through :func:`rollout_diag`, and the worst scenes' chronologies;
- :func:`scene_replay`: gate 2 and its bar, :func:`tracks`;
- :func:`probe_escalation`: scenes rolled out with and without escalation;
- :func:`obstacle_run` and :func:`obstacle_gate`: gate 1 and its bars.

Run from the repository root (the card by default, ``--device cpu`` for
the CPU; the arguments and defaults are the JAX tools')::

    python -m boundplanner_tpu_torch.gates long [ticks=50] [top=3]
    python -m boundplanner_tpu_torch.gates scene [scene=43] [ticks=30]
    python -m boundplanner_tpu_torch.gates probe [scenes=29,43,54] [ticks=50] \\
        [esc_lanes=4] [esc_sqp=6] [esc_qp=8]
    python -m boundplanner_tpu_torch.gates obstacle

with ``--device``, ``--dtype float32|float64`` (float32, the gates'),
``--fleet PATH`` (the cached 128-scene fleet) and ``--out DIR`` (``long``
saves its records there as ``replay_worst.npz``). Each prints JSON lines;
``scene`` and ``obstacle`` exit 1 when their bar is missed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .config import perf_mpc_params
from .mpc.bound_mpc import FleetMPC, mpc_tick
from .ops.cuda_proj import line_polytope_projection
from .ops.linalg import kkt_inverse
from .parallel import batch as fleet_batch
from .parallel.dryrun import executed_penetration
from .parallel.fleet_cache import cache_path, load, to_numpy, to_torch, tree_map
from .utils.device import DEFAULT_DEVICE, checked_device
from .utils.integration import integrate_jerk_step

FLEET_SEED = 7
FLEET_BATCH = 128
PROBE_SCENES = (29, 43, 54)
# the obstacle gate's bars (tools/gate_obstacle.py: the JAX loop reaches
# the path end in 38 ticks with 0 fallbacks and a 0.91-1.01 mm final error)
OBSTACLE_MAX_TICKS = 45
OBSTACLE_DRIVE_TICKS = 60
OBSTACLE_MAX_ERR_M = 2e-3
COLLISION_TOL = 1e-5      # the JAX gate's: inside a box when max(A p - b) <= -1e-5
# the scene replay's bar ("tracks", tools/gate_scene43.py)
TRACK_MAX_VIOL = 0.01
TRACK_MAX_FAIL_RUN = 2


def _launches():
    return {"chol_inverse": kkt_inverse.launches,
            "line_polytope": line_polytope_projection.launches}


def _since(before):
    return {k: n - before[k] for k, n in _launches().items()}


def _diag_step(state, obs, cfg, st):
    """`rollout_diag`'s scan body (``tools/replay_worst.py``'s): state
    (carry, q, dq, ddq, jerk, qf); returns (state', record)."""
    carry, q, dq, ddq, jerk, qf = state
    meas = fleet_batch._plant_measurement(q, dq, ddq, jerk, qf, st.chain)
    carry, out = mpc_tick(carry, meas, obs, cfg, st)
    rec = {"phi": out["phi"][:, 1], "success": out["success"], "viol": out["viol"],
           "err_cnt": carry.error_count, "dq_max": dq.abs().amax(dim=-1),
           "cost": out["cost"], "sector": out["sector"]}
    u0, u1 = out["dddq"][:, 0], out["dddq"][:, 1]
    q_n, dq, ddq = integrate_jerk_step(q, dq, ddq, u0, u1, cfg.dt)
    return (carry, q_n, dq, ddq, u1, out["q"][:, -1]), rec


@torch.no_grad()
def rollout_diag(carry, q0, obs, model: FleetMPC, ticks: int):
    """The closed loop of `parallel.batch.fleet_rollout` (without
    escalation) with the diagnostic record set of the JAX package's
    ``tools/replay_worst.py``: per scene and tick ``phi``, ``success``,
    ``viol``, ``err_cnt`` (the carry's error count after the tick),
    ``dq_max`` (the largest joint speed before it), ``cost`` and
    ``sector``. On the graph route one step graph of its own (JAX jits
    this scan apart) replays each tick. Returns (final carry, records with
    leaves (B, ticks))."""
    zeros = torch.zeros_like(q0)
    state = (carry, q0, zeros, zeros, zeros, q0)
    if model.graph:
        state, recs = model.step_graph(_diag_step, state, obs).scan(state, obs, ticks)
    else:
        recs = []
        for _ in range(ticks):
            state, rec = _diag_step(state, obs, model.cfg, model.st)
            recs.append(rec)
    return state[0], fleet_batch._stack(recs)


def fleet_tensors(fleet, device, dtype, scenes=None):
    """(carry, q0, obs) of a cached fleet's payload (`fleet_cache.load`),
    of the rows ``scenes`` (a slice or index list; all by default), as
    tensors on ``device`` in ``dtype``."""
    pick = (lambda a: np.asarray(a)) if scenes is None else (lambda a: np.asarray(a)[scenes])
    return to_torch(tree_map(pick, (fleet["carry"], fleet["q0"], fleet["obs"])), device, dtype)


def chronology(recs, scene: int):
    """One scene's failure chronology from `rollout_diag`'s numpy records."""
    succ = recs["success"][scene]
    sector = recs["sector"][scene]
    failed = np.flatnonzero(~succ)
    return {"scene": int(scene), "max_viol": float(recs["viol"][scene].max()),
            "fails": int(failed.size), "ticks": int(succ.size),
            "failed_ticks": failed.tolist(),
            "first_fail_tick": int(failed[0]) if failed.size else None,
            "err_cnt_max": int(recs["err_cnt"][scene].max()),
            "sector_changes": (np.flatnonzero(np.diff(sector)) + 1).tolist(),
            "phi_final": float(recs["phi"][scene, -1]),
            "dq_max": float(recs["dq_max"][scene].max())}


def long_horizon(fleet, ticks: int = 50, top: int = 3, chunk: int = 128,
                 device=DEFAULT_DEVICE, dtype=torch.float32, watch=(43,)):
    """Gate 4 and ``replay_worst``: the fleet through ``chunked_rollout``
    for ``ticks`` ticks at the perf configuration (``bench.py 128 50``, in
    chunks of ``chunk`` scenes, or the whole fleet if it is smaller), then
    the same inputs through :func:`rollout_diag`; the chronologies of the
    ``top`` scenes by worst violation, and the executed EE's obstacle
    penetration (the dry run's bars and :func:`dig_in_by_tick`). ``watch``
    names scenes whose last tick is reported. Returns (summary, rollout
    records, diagnostic records), the records as numpy."""
    device = checked_device(device)
    carry, q0, obs = fleet_tensors(fleet, device, dtype)
    bsz = q0.shape[0]
    chunk = min(chunk, bsz)
    model = FleetMPC(perf_mpc_params(), device=device, dtype=dtype)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    before, t0 = _launches(), synced()
    _, recs = fleet_batch.chunked_rollout(carry, q0, obs, model, ticks, chunk=chunk)
    wall = synced() - t0
    launches_rollout = _since(before)
    before, t0 = _launches(), synced()
    parts = [rollout_diag(*tree_map(lambda t: t[lo:lo + chunk], (carry, q0, obs)), model,
                          ticks)[1]
             for lo in range(0, bsz, chunk)]
    diag_wall = synced() - t0
    launches_diag = _since(before)
    recs, diag = to_numpy((recs, fleet_batch._concat(parts)))

    succ, viol = recs["success"], recs["viol"]
    worst = np.argsort(-diag["viol"].max(axis=1), kind="stable")[:top]
    summary = {
        "scenes": int(bsz), "ticks": ticks, "chunk": chunk, "dtype": str(dtype).split(".")[-1],
        "success_rate": float(succ.mean()), "max_viol": float(viol.max()),
        "mean_phi_final": float(recs["phi"][:, -1].mean()),
        "wall_s": wall, "solves_per_s": bsz * ticks / wall, "diag_wall_s": diag_wall,
        "failing_scenes": np.flatnonzero(~succ.all(axis=1)).tolist(),
        **_penetration(recs["p"], fleet["obs"]),
        "diag_equal": {k: bool(np.array_equal(recs[k], diag[k]))
                       for k in ("phi", "success", "viol")},
        "launches_rollout": launches_rollout, "launches_diag": launches_diag,
        "worst": [chronology(diag, s) for s in worst],
        "watch": {int(s): {"tick": ticks - 1, "success": bool(diag["success"][s, -1]),
                           "viol": float(diag["viol"][s, -1]),
                           "phi": float(diag["phi"][s, -1]),
                           "err_cnt": int(diag["err_cnt"][s, -1]),
                           "sector": int(diag["sector"][s, -1]),
                           "fails": int((~diag["success"][s]).sum())}
                  for s in watch if s < bsz},
    }
    return summary, recs, diag


def dig_in_by_tick(p, obs):
    """The deepest dig-in of the executed EE at any tick: over the scenes
    that start inside a box (deeper than 1 mm), the largest depth at a
    tick minus the depth at the start (``p`` (B, T, >=3) the plant's EE
    poses, ``obs`` the obstacle arrays, numpy), with its scene and tick.
    The dry run's bar (`parallel.dryrun.executed_penetration`, as the JAX
    package's) reads the final tick only. Returns (depth, scene, tick);
    (-inf, None, None) where no scene starts inside."""
    p3 = np.asarray(p, np.float64)[..., :3]
    rows = (np.einsum("bmri,bti->btmr", np.asarray(obs.a, np.float64), p3)
            - np.asarray(obs.b, np.float64)[:, None])
    d = np.where(np.asarray(obs.mask)[:, None, :], -rows.max(-1), -np.inf).max(-1)
    inside = np.flatnonzero(d[:, 0] > 1e-3)
    if inside.size == 0:
        return -np.inf, None, None
    rise = d[inside] - d[inside, :1]
    k, t = np.unravel_index(np.argmax(rise), rise.shape)
    return float(rise[k, t]), int(inside[k]), int(t)


def _penetration(p, obs):
    """The executed EE's obstacle penetration: the dry run's two bars and
    the deepest dig-in at any tick."""
    enter, digin = executed_penetration(p, obs)
    depth, scene, tick = dig_in_by_tick(p, obs)
    return {"pen_enter": enter, "pen_digin": digin, "pen_digin_any": depth,
            "pen_digin_any_at": [scene, tick]}


def tracks(phi, viol, success):
    """The scene replay's bar ("tracks"): phi never decreases, every tick's
    violation is under 1 cm, and no 3 consecutive ticks fail. Returns
    (passed, the three parts)."""
    phi, viol, success = (np.asarray(x) for x in (phi, viol, success))
    run = longest = 0
    for ok in success:
        run = 0 if ok else run + 1
        longest = max(longest, run)
    parts = {"phi_monotone": bool(np.all(np.diff(phi) >= 0)),
             "viol_under_1cm": bool(np.all(viol < TRACK_MAX_VIOL)),
             "longest_fail_run": int(longest)}
    return (parts["phi_monotone"] and parts["viol_under_1cm"]
            and longest <= TRACK_MAX_FAIL_RUN), parts


@torch.no_grad()
def scene_replay(fleet, scene: int = 43, ticks: int = 30, device=DEFAULT_DEVICE,
                 dtype=torch.float32):
    """Gate 2 (``tools/gate_scene43.py``): one scene of the fleet rolled
    out alone (batch 1) by ``fleet_rollout`` at the perf configuration.
    Returns the ``phi``, ``viol`` and ``success`` series, the summary and
    the bar."""
    device = checked_device(device)
    model = FleetMPC(perf_mpc_params(), device=device, dtype=dtype)
    _, recs = fleet_batch.fleet_rollout(*fleet_tensors(fleet, device, dtype,
                                                       slice(scene, scene + 1)),
                                        model, ticks)
    recs = to_numpy(recs)
    phi, viol, succ = (recs[k][0] for k in ("phi", "viol", "success"))
    ok, parts = tracks(phi, viol, succ)
    return {"scene": scene, "ticks": ticks, "dtype": str(dtype).split(".")[-1],
            "phi": phi.tolist(), "viol": viol.tolist(), "success": succ.tolist(),
            "max_viol": float(viol.max()), "success_rate": float(succ.mean()),
            "phi_final": float(phi[-1]), "tracks": ok, **parts}


@torch.no_grad()
def probe_escalation(fleet, scenes=PROBE_SCENES, ticks: int = 50, esc_lanes: int = 4,
                     esc_sqp: int = 6, esc_qp: int = 8, device=DEFAULT_DEVICE,
                     dtype=torch.float32):
    """``tools/probe_escalation.py``: the fleet's ``scenes`` rolled out
    together by ``fleet_rollout`` at the perf configuration, without
    escalation and with ``esc_lanes`` lanes at the (``esc_sqp``,
    ``esc_qp``) budget. Returns one row per arm: each scene's fails,
    first failing ticks, worst violation and final phi, the arm's totals,
    the ticks whose retry fired, the retry's runs that fired nothing (a
    cold step graph's warm-up) and the kernels' launches."""
    device = checked_device(device)
    base = perf_mpc_params()
    arms = {"base": base,
            "escalated": dataclasses.replace(base, esc_lanes=esc_lanes,
                                             esc_sqp_iters=esc_sqp, esc_qp_iters=esc_qp)}
    tensors = fleet_tensors(fleet, device, dtype, list(scenes))
    rows = []
    for arm, cfg in arms.items():
        model = FleetMPC(cfg, device=device, dtype=dtype)
        esc = fleet_batch._escalate_failed_lanes
        before, retries, idle = _launches(), esc.retries, esc.idle_runs
        _, recs = fleet_batch.fleet_rollout(*tensors, model, ticks)
        recs = to_numpy(recs)
        per_scene = []
        for i, s in enumerate(scenes):
            succ, viol, phi = recs["success"][i], recs["viol"][i], recs["phi"][i]
            failed = np.flatnonzero(~succ)
            per_scene.append({"scene": int(s), "fails": int(failed.size),
                              "first_fail_ticks": failed[:8].tolist(),
                              "max_viol": float(viol.max()), "phi_final": float(phi[-1])})
        rows.append({"arm": arm, "esc_lanes": cfg.esc_lanes,
                     "esc": [cfg.esc_sqp_iters, cfg.esc_qp_iters], "ticks": ticks,
                     "scenes": per_scene, "success_rate": float(recs["success"].mean()),
                     "max_viol": float(recs["viol"].max()),
                     "escalated_ticks": esc.retries - retries,
                     "idle_retry_runs": esc.idle_runs - idle,
                     "launches": _since(before)})
    return rows


def box_margin(p, boxes) -> float:
    """The least of max(A p - b) over the H-reps ``boxes``: a point is
    inside a box when its margin is <= -1e-5 (the JAX gate's test)."""
    p = np.asarray(p, np.float64)[:3]
    return min(float(np.max(np.asarray(a) @ p - np.asarray(b))) for a, b in boxes)


def obstacle_gate(row):
    """The obstacle gate's bars (``tools/gate_obstacle.py``) on a node's
    summary (:func:`node_row`): ``ticks``, ``path_end_reached``,
    ``stopped_by``, ``fails`` (the node's ``sum(fails)``), ``goal_err_m``
    and ``min_box_margin_m`` (the least :func:`box_margin` of the EE over
    every tick and original box).
    Returns (passed, the bars). A run that stopped short of the path end
    (its ``stopped_by`` not ``"path_end"``) passes no bar that needs it."""
    reached = bool(row["path_end_reached"]) and row["stopped_by"] == "path_end"
    bars = {"path_end_within_ticks": reached and row["ticks"] <= OBSTACLE_MAX_TICKS,
            "no_fallbacks": row["fails"] == 0,
            "goal_err_within": reached and row["goal_err_m"] <= OBSTACLE_MAX_ERR_M,
            "ee_outside_boxes": row["min_box_margin_m"] > -COLLISION_TOL}
    return all(bars.values()), bars


def drive_node(node, boxes, max_ticks: int, cap_s: float | None = None, step=None):
    """Step ``node`` toward its path end, as the JAX gate does (until phi
    is within 1e-3 of its end, ``max_ticks`` ticks or ``cap_s`` seconds),
    calling ``step(node)`` for each tick (``node.step`` by default).
    Returns (why it stopped, the least EE box margin over the ticks)."""
    step = step or (lambda n: n.step())
    margin = np.inf
    t0 = time.perf_counter()
    while True:
        if node.mpc.phi_current[0] >= node.mpc.phi_max[0] - 0.001:
            return "path_end", margin
        if node.k_current >= max_ticks:
            return "ticks", margin
        if cap_s is not None and time.perf_counter() - t0 >= cap_s:
            return "seconds", margin
        step(node)
        margin = min(margin, box_margin(node.p_lie, boxes))


def node_row(node, goal, stopped_by, margin):
    """The obstacle gate's summary of a driven node."""
    return {"ticks": node.k_current, "phi": float(node.mpc.phi_current[0]),
            "phi_max": float(node.mpc.phi_max[0]),
            "path_end_reached": bool(node.mpc.phi_current[0] >= node.mpc.phi_max[0] - 0.02),
            "stopped_by": stopped_by, "goal_err_m": float(np.linalg.norm(node.p_lie[:3] - goal)),
            "fails": float(sum(node.fails)), "min_box_margin_m": float(margin)}


def obstacle_run(device=DEFAULT_DEVICE, dtype=torch.float32):
    """Gate 1: the table + pillar scene of ``mpc/e2e.py`` (the JAX gate's)
    planned on ``device`` in float64 (`mpc.e2e.plan_e2e`), then ``MPCNode``
    at the perf configuration in ``dtype`` toward the path end (60 ticks
    at most, as the JAX gate). Returns the node's row with the gate's
    verdict."""
    from .mpc import MPCNode
    from .mpc.e2e import plan_e2e

    device = checked_device(device)
    q0, args, boxes, goal, _ = plan_e2e(device)
    node = MPCNode(q0, params=perf_mpc_params(), device=device, dtype=dtype)
    node.update_reference(*args)
    stopped_by, margin = drive_node(node, boxes, OBSTACLE_DRIVE_TICKS)
    row = node_row(node, goal, stopped_by, margin)
    row["passed"], row["bars"] = obstacle_gate(row)
    return row


def _emit(obj):
    print(json.dumps(obj), flush=True)


def main(argv):
    ap = argparse.ArgumentParser(prog="python -m boundplanner_tpu_torch.gates")
    ap.add_argument("gate", choices=("long", "scene", "probe", "obstacle"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--fleet", default=None, help="a cached fleet (the 128-scene one)")
    ap.add_argument("--out", default=None, help="where `long` saves its records")
    ns = ap.parse_args(argv)
    device, dtype = checked_device(ns.device), getattr(torch, ns.dtype)
    arg = lambda i, default: ns.args[i] if len(ns.args) > i else default
    if ns.gate == "obstacle":
        row = obstacle_run(device, dtype)
        _emit({"gate": "obstacle", **row})
        return 0 if row["passed"] else 1
    fleet = load(ns.fleet or cache_path(FLEET_BATCH, FLEET_SEED, perf_mpc_params().nr_segs))
    if ns.gate == "long":
        summary, recs, diag = long_horizon(fleet, int(arg(0, 50)), int(arg(1, 3)),
                                           device=device, dtype=dtype)
        for chron in summary["worst"]:
            _emit({"gate": "long", "chronology": chron})
        _emit({"gate": "long", **{k: v for k, v in summary.items() if k != "worst"}})
        if ns.out:
            os.makedirs(ns.out, exist_ok=True)
            np.savez(os.path.join(ns.out, "replay_worst.npz"),
                     **{f"rollout.{k}": v for k, v in recs.items()},
                     **{f"diag.{k}": v for k, v in diag.items()})
        return 0
    if ns.gate == "scene":
        row = scene_replay(fleet, int(arg(0, 43)), int(arg(1, 30)), device=device, dtype=dtype)
        _emit({"gate": "scene", **row})
        return 0 if row["tracks"] else 1
    scenes = tuple(int(s) for s in arg(0, ",".join(map(str, PROBE_SCENES))).split(","))
    for row in probe_escalation(fleet, scenes, int(arg(1, 50)), int(arg(2, 4)),
                                int(arg(3, 6)), int(arg(4, 8)), device=device, dtype=dtype):
        _emit({"gate": "probe", **row})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
