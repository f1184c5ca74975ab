"""Make the arm's frozen plans: ``data/e2e_plans.json``.

The single-arm traffic (``traffic/arm_shuttle.json``) shuttles one arm
between the start and the goal of the e2e scene: a floor and a pillar
between the demo pose and a goal behind the pillar, as the port's
``mpc/e2e.py`` defines it. This script plans both directions with the
port's ``BoundPlanner`` in float64, once for each planner seed, and writes
what ``MPCNode.update_reference`` takes, as plain numbers. The benchmark
reads the file; it never plans.

    python benchmark/make_plans.py [--device cpu] [--seeds 16] [--commit <hash>]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "e2e_plans.json")


def plan_leg(planner_cls, device, seed, start, goal, r_start, r_goal, scene):
    import torch

    planner = planner_cls(e_p_max=0.5, obstacles=scene["obstacles"],
                          workspace_max=scene["ws_max"], workspace_min=scene["ws_min"],
                          seed=seed, device=device, dtype=torch.float64)
    p_via, r_via, bp1, sets_via = planner.plan_convex_set_path(
        np.array(start, dtype=np.float64), np.array(goal, dtype=np.float64), r_start, r_goal)
    n = len(bp1)
    return {
        "p_via": [np.asarray(p, dtype=np.float64).tolist() for p in p_via],
        "r_via": [np.asarray(r, dtype=np.float64).tolist() for r in r_via],
        "bp1": [np.asarray(b, dtype=np.float64).tolist() for b in bp1],
        "br1": [[0.0, 0.0, 1.0]] * n,
        "e_r_bound": [scene["e_r_bound"]] * n,
        "a_sets": [np.asarray(s[0], dtype=np.float64).tolist() for s in sets_via],
        "b_sets": [np.asarray(s[1], dtype=np.float64).tolist() for s in sets_via],
        "obstacles": scene["obstacles"],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--seeds", type=int, default=16)
    parser.add_argument("--commit", default="unknown")
    args = parser.parse_args(argv)

    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    from scipy.spatial.transform import Rotation as R

    from boundplanner_tpu_torch.demo import DEMO_Q0
    from boundplanner_tpu_torch.mpc import e2e
    from boundplanner_tpu_torch.parallel.fleet import DEFAULT_ER_BOUND
    from boundplanner_tpu_torch.planner.planner import BoundPlanner
    from boundplanner_tpu_torch.robot.model import RobotModel

    torch.set_num_threads(2)
    device = torch.device(args.device)
    q0 = DEMO_Q0.copy()
    pose0 = RobotModel(device=device).fk(q0)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    goal = np.asarray(e2e.E2E_GOAL, dtype=np.float64)
    scene = {"obstacles": [list(map(float, o)) for o in e2e.E2E_OBSTACLES],
             "ws_min": list(e2e.E2E_WS_MIN), "ws_max": list(e2e.E2E_WS_MAX),
             "e_r_bound": np.asarray(DEFAULT_ER_BOUND, dtype=np.float64).tolist()}
    plans = {}
    for seed in range(args.seeds):
        t0 = time.perf_counter()
        plans[str(seed)] = {
            "out": plan_leg(BoundPlanner, device, seed, pose0[:3], goal, r0, r1, scene),
            "back": plan_leg(BoundPlanner, device, seed, goal, pose0[:3], r1, r0, scene),
        }
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s, vias "
              f"{len(plans[str(seed)]['out']['p_via'])} / {len(plans[str(seed)]['back']['p_via'])}",
              flush=True)
    payload = {
        "made_by": "benchmark/make_plans.py",
        "commit": args.commit,
        "device": str(device),
        "dtype": "float64",
        "planner": {"class": "boundplanner_tpu_torch.planner.planner.BoundPlanner",
                    "e_p_max": 0.5, "seeds": list(range(args.seeds))},
        "q0": q0.tolist(),
        "scene": scene,
        "plans": plans,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
