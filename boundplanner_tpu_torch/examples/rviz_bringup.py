"""RViz bringup (counterpart of the JAX package's
``examples/rviz_bringup.py``; ref `launch/rviz.launch.py:1-66`): plan the
example scene, create the `ros_compat.RosPublisher` (real rclpy publishers
when ROS 2 is sourced, payload dicts otherwise), register the
Trajectory/MPCParams host services, and stream markers, paths, joint
states and telemetry while the MPC tracks.

With ROS 2 + RViz:  ros2 run rviz2 rviz2   (frame `world`), then the command below
Headless:           the same command: payloads are built and logged, publishing is a no-op

    python -m boundplanner_tpu_torch.examples.rviz_bringup [--device cpu] [--max-ticks N]
"""

import argparse

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..config import MPCParams
from ..mpc import MPCNode
from ..planner import BoundPlanner
from ..robot import kinematics as kin
from ..robot.model import COL_JOINT_SIZES
from ..ros_compat import MpcHostServices, RosPublisher
from ..utils.device import DEFAULT_DEVICE
from .scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles


def main(seed: int = 0, max_ticks: int = 30, device=DEFAULT_DEVICE,
         params: MPCParams | None = None, pub: RosPublisher | None = None,
         plan_dtype=torch.float32):
    """The MPC runs in float64 (``params``, default ``MPCParams()``), the
    planner in ``plan_dtype``; ``pub`` defaults to a fresh `RosPublisher`.
    Returns the number of ticks published."""
    q0 = np.zeros(7)
    q0[3] = -np.pi / 2
    q0[5] = np.pi / 2

    node = MPCNode(q0, params=params, device=device)
    pub = RosPublisher() if pub is None else pub
    services = MpcHostServices(node)
    if pub.ros is not None:  # real srv servers need the IDL package
        services.register(pub)

    p0fk, _, _ = node.robot_model.forward_kinematics(q0, 0 * q0)
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
        device=device,
        dtype=plan_dtype,
    )
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)

    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    services.trajectory(p_via, r_via, bp1_list, br1, erb, a_sets, b_sets, obstacles)

    # scene markers once (ref RvizTools.publish_sets / via points)
    pub.publish_sets(sets_via)
    pub.publish_via_points(p_via, r_via)
    obstacle_sets = [(a, b) for a, b in planner.obs_sets_orig]
    pub.publish_sets(obstacle_sets, color=(1.0, 0.0, 0.0), alpha=0.4)

    # the collision spheres come from the card's kinematics as tensors;
    # the publisher brings them to the host
    chain = kin.Chain().to(node.device, torch.float64)
    ticks = 0
    while (
        float(node.mpc.phi_current[0]) < float(node.mpc.phi_max[0]) - 0.001
        and ticks < max_ticks
    ):
        node.step()
        pub.publish_tick(node.telemetry.ticks[-1])
        pub.publish_joint_state(node.q)
        q = torch.as_tensor(node.q, dtype=torch.float64, device=node.device)
        pub.publish_collision_spheres(kin.fk_pos_col_all(q, chain), COL_JOINT_SIZES)
        ticks += 1
    print(
        f"rviz bringup: {ticks} ticks published, phi "
        f"{float(node.mpc.phi_current[0]):.3f} / {float(node.mpc.phi_max[0]):.3f}"
    )
    pub.shutdown()
    return ticks


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-ticks", type=int, default=30)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(seed=args.seed, max_ticks=args.max_ticks, device=args.device)
