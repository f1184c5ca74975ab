"""The readings that a cell's limits are set from: for each seed, the
numbers that decide ``correct`` for a sound run of the program and for
the control, in one process.

- ``fleet128.perf_f32`` (float32 with TF32 off, as the port sets it): the
  control is the program with TF32 switched on, one rollout of the cell's
  scenes and ticks on each seed, beside one with it off.
- the float64 cells: the control is the reference computed in float32 and
  put in the program's place (the fleet: its rollout of the seed's scenes;
  the arm: its periods from the program's own states).

Each seed prints one line ``{"seed", "sound": {...}, "control": {...}}``;
the sound numbers of a fleet seed come from one rollout of the program
outside a window (the same entry, scenes and ticks as the window's), the
arm's from the periods of the seed's first two legs.

    python benchmark/control.py --workload <name> --seeds 1,2,3 [--scenes N --ticks T]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def fleet_readings(c, seeds, device, log):
    import torch
    from boundplanner_tpu_torch import config as prog_config
    from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC
    from boundplanner_tpu_torch.parallel import batch, fleet_cache

    from benchmark.drivers import fleet_rollout as drv
    from benchmark.reference import fleet as ref
    from benchmark.reference.bmpc import config as ref_config

    conf, tr, lim = c["config"], c["traffic"], c["limits"]
    dtype = getattr(torch, conf["dtype"])
    path = os.path.join(harness.ROOT, tr["fleet_file"])
    cfg = harness.mpc_params(prog_config, conf)
    model = FleetMPC(cfg, device=device, dtype=dtype)
    carry_all, q0_all, obs_all = fleet_cache.load_fleet(path, device=device, dtype=dtype)
    ref64 = ref.RefFleet(harness.mpc_params(ref_config, conf), device, torch.float64,
                         conf["link_route"])
    pose = lambda q: ref64.pose(q.to(device, torch.float64))
    cpu = lambda tree: drv.tmap(lambda t: t.detach().cpu(), tree)
    for seed in seeds:
        t0 = time.perf_counter()
        index = drv.draw(seed, int(tr["pool"]), int(tr["scenes"]))
        idx = torch.as_tensor(index, device=device)
        carry, q0, obs = drv.tmap(lambda t: t[idx], (carry_all, q0_all, obs_all))
        _, prog = batch.chunked_rollout(carry, q0, obs, model, int(tr["ticks"]),
                                        chunk=int(tr["chunk"]))
        ticks = min(int(lim.get("reference_ticks", tr["ticks"])), int(tr["ticks"]))
        first = lambda recs: {k: v[:, :ticks] for k, v in cpu(recs).items()}
        rc, rq, ro = ref.load_scenes(path, index, device, torch.float64)
        _, truth = ref64.rollout(rc, rq, ro, ticks)
        truth = cpu(truth)
        sound, _ = ref.compare(first(prog), truth, q0.cpu(), pose, lim["wrong_at"])
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                fresh = FleetMPC(cfg, device=device, dtype=dtype)
                _, ctl = batch.chunked_rollout(carry, q0, obs, fresh, int(tr["ticks"]),
                                               chunk=int(tr["chunk"]))
                ctl = first(ctl)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            kind = "program, TF32 on"
        else:
            low = ref.RefFleet(harness.mpc_params(ref_config, conf), device, torch.float32,
                               conf["link_route"])
            lc, lq, lo = ref.load_scenes(path, index, device, torch.float32)
            _, ctl = low.rollout(lc, lq, lo, ticks)
            ctl = first(ctl)
            kind = "reference in float32"
        control, _ = ref.compare(ctl, truth, q0.cpu(), pose, lim["wrong_at"])
        log({"seed": seed, "control_kind": kind, "sound": sound, "control": control,
             "seconds": time.perf_counter() - t0})


def arm_readings(c, seeds, device, log, periods):
    import numpy as np
    import torch

    from benchmark.drivers import arm_shuttle as drv
    from benchmark.reference import arm as ref
    from benchmark.reference.bmpc import config as ref_config

    conf = c["config"]
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = {"seed": seed, "seconds": 0.0, "trace": False, "device": torch.device(device),
               "config": conf,
               "traffic": {**c["traffic"], "judged_periods": periods, "judged_handoffs": 2,
                           "judged_within": 2 * int(c["traffic"]["leg_periods"])},
               "workload": c["workload"]["name"], "t0": time.perf_counter()}
        s = drv.ArmSession(ctx)
        for k in range(2 * s.leg):
            s.log.append(s._period(k))
        s.release()
        models = {dt: ref.RefArm(harness.mpc_params(ref_config, conf), device, dt, conf["link_route"])
                  for dt in (torch.float64, torch.float32)}
        obs = {dt: {d: m.obstacles(s.plans[d]) for d in drv.DIRECTIONS}
               for dt, m in models.items()}
        keys = (("period_q_gap_max", "q", "q"), ("period_dq_gap_max", "dq", "dq"),
                ("period_pose_gap_max", "p", "p_lie"))
        out = {"sound": dict.fromkeys((k for k, _, _ in keys), 0.0),
               "control": dict.fromkeys((k for k, _, _ in keys), 0.0)}
        for e in s.judged["periods"]:
            r = {dt: m.period(e["before"], drv.to_device(e["carry"], device, dt),
                              obs[dt][e["direction"]]) for dt, m in models.items()}
            for name, rk, pk in keys:
                truth = r[torch.float64][rk]
                out["sound"][name] = max(out["sound"][name],
                                         float(np.abs(e["after"][pk] - truth).max()))
                out["control"][name] = max(out["control"][name],
                                           float(np.abs(r[torch.float32][rk] - truth).max()))
        for name in ("sound", "control"):
            out[name]["handoff_carry_gap_max"] = 0.0
        for e in s.judged["handoffs"]:
            h = e["handoff"]
            carries = {dt: m.handoff(s.plans[e["direction"]], h["before"]["p_lie"],
                                     h["before"]["v"],
                                     drv.to_device(h["carry_before"], device, dt))
                       for dt, m in models.items()}
            truth = carries[torch.float64]
            for name, got in (("sound", e["carry"]), ("control", carries[torch.float32])):
                out[name]["handoff_carry_gap_max"] = max(out[name]["handoff_carry_gap_max"],
                                                         ref.carry_gap(got, truth))
        log({"seed": seed, "control_kind": "reference in float32", **out,
             "periods": len(s.judged["periods"]), "seconds": time.perf_counter() - t0})


def main(argv=None):
    parser = argparse.ArgumentParser(description="sound and control readings of a cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--scenes", type=int)
    parser.add_argument("--ticks", type=int)
    parser.add_argument("--periods", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    harness.cache_env()
    import torch

    c = harness.cell(harness.manifest(), args.workload)
    if args.scenes:
        c["traffic"].update(scenes=args.scenes, chunk=args.scenes)
    if args.ticks:
        c["traffic"]["ticks"] = args.ticks
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device(args.device)
    log = lambda obj: print(json.dumps(obj), flush=True)
    if c["traffic"]["driver"] == "fleet_rollout":
        fleet_readings(c, seeds, device, log)
    else:
        arm_readings(c, seeds, device, log, args.periods)
    return 0


if __name__ == "__main__":
    sys.exit(main())
