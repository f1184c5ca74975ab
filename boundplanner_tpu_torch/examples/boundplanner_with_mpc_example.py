"""Planner + receding-horizon MPC loop (counterpart of the JAX package's
``examples/boundplanner_with_mpc_example.py``; ref
`boundplanner_with_mpc_example.py`): plan the example scene, hand the plan
to `mpc.MPCNode` and track it to the path end (or ``max_ticks``).

    python -m boundplanner_tpu_torch.examples.boundplanner_with_mpc_example [--device cpu] [--max-ticks N] [--plot]
"""

import argparse
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..config import MPCParams
from ..mpc import MPCNode
from ..planner import BoundPlanner
from ..utils.device import DEFAULT_DEVICE
from .scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles


def main(plot: bool = False, seed: int = 0, max_ticks: int = 200, device=DEFAULT_DEVICE,
         params: MPCParams | None = None, plan_dtype=torch.float32):
    """The MPC runs in float64 (``params``, default ``MPCParams()``), the
    planner in ``plan_dtype``. Returns (EE trajectory (ticks, 3), via
    points)."""
    q0 = np.zeros(7)
    q0[3] = -np.pi / 2
    q0[5] = np.pi / 2

    mpc_node = MPCNode(q0, params=params, device=device)
    mpc_node.step()

    p0fk, _, _ = mpc_node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.45, -0.5, 0.2])
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    obstacles = example_obstacles()
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=WORKSPACE_MAX,
        workspace_min=WORKSPACE_MIN,
        seed=seed,
        verbose=True,
        device=device,
        dtype=plan_dtype,
    )
    start = time.time()
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    print(f"Path planning took {time.time() - start:.2f}s")

    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1_list = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    e_r_bound = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    mpc_node.update_reference(
        p_via, r_via, bp1_list, br1_list, e_r_bound, a_sets, b_sets, obstacles
    )

    traj = []
    ticks = 0
    while (
        float(mpc_node.mpc.phi_current[0]) < float(mpc_node.mpc.phi_max[0]) - 0.001
        and ticks < max_ticks
    ):
        mpc_node.step(verbose=True)
        traj.append(mpc_node.p_lie[:3].copy())
        ticks += 1

    traj = np.array(traj)
    goal_err = np.linalg.norm(traj[-1] - p1)
    print(f"Finished after {ticks} ticks; final EE error to goal: {goal_err*1000:.1f} mm")

    if plot:
        import matplotlib.pyplot as plt

        from ..viz import plot_via_path

        plot_via_path(p_via, r_via, sets_via, planner.obs_sets)
        plt.plot(traj[:, 0], traj[:, 1], traj[:, 2], linewidth=2, color="black")
        plt.show()
    return traj, p_via


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-ticks", type=int, default=200)
    ap.add_argument("--plot", action="store_true")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(plot=args.plot, seed=args.seed, max_ticks=args.max_ticks, device=args.device)
