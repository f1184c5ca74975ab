"""Fixed-dt control loop for one arm (port of
``boundplanner_tpu/mpc/node.py``): forward kinematics -> MPC step ->
apply the first jerk column -> integrate the joint state one dt, with
per-tick telemetry. The host state (q, dq, ddq, jerk, pose) is numpy;
the kinematics and the MPC run on ``device`` (the card by default),
where each step replays the tick's CUDA graph unless ``graph=False``
(`BoundMPC`). A period and a hand-off are host spans
(`telemetry.span`), whose durations are the records' timings.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from ..config import MPCParams
from ..robot.model import RobotModel
from ..telemetry import MPCTickRecord, TelemetryRecorder
from ..utils.device import DEFAULT_DEVICE
from ..utils.integration import integrate_jerk_step
from .bound_mpc import BoundMPC


class MPCNode:
    def __init__(self, q0, params: MPCParams | None = None, realtime: bool = False,
                 device=DEFAULT_DEVICE, dtype=torch.float64, graph: bool | None = None):
        self.params = params or MPCParams()
        self.graph = graph
        self.dt = self.params.dt
        self.realtime = realtime
        self.device = device
        self.dtype = dtype
        self.robot_model = RobotModel(self.params.robot, device=device, dtype=dtype)

        self.fails = []
        self.t_mpc = 0.0
        self.t_overhead = 0.0
        self.telemetry = TelemetryRecorder()

        self.q0 = np.asarray(q0, dtype=np.float64)
        self.p0, _, _ = self.robot_model.forward_kinematics(self.q0, self.q0)
        self.traj = None
        self.traj_data = None
        self.ref_data = None
        self.reset()

    def reset(self):
        """Idle MPC at the current pose."""
        from scipy.spatial.transform import Rotation as R

        self.p = self.p0.copy()
        p_via = [self.p0[:3].copy()] * 2
        r_via = [R.from_rotvec(np.array(self.p0[3:])).as_matrix()] * 2
        bp1 = [np.array([1.0, 0.0, 0.0])]
        br1 = [np.array([1.0, 0.0, 0.0])]
        e_r_bound = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180]
        a_sets = [np.zeros((15, 3))]
        b_sets = [np.ones(15)]
        self.mpc = BoundMPC(
            p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets,
            obstacles=[], p0=self.p0, params=self.params,
            device=self.device, dtype=self.dtype, graph=self.graph,
        )
        self.q = self.q0.copy()
        self.qf = self.q0.copy()
        self.dq = np.zeros(7)
        self.ddq = np.zeros(7)
        self.jerk = np.zeros(7)
        self.p_lie = self.p0.copy()
        self.v = np.zeros(6)
        self.t_current = 0.0
        self.k_current = 0

    def reconfigure(self, params: MPCParams):
        """Swap the MPC configuration and rebuild an idle MPC at the current
        pose."""
        self.params = params
        self.dt = params.dt
        self.q0 = self.q.copy()
        self.p0, _, _ = self.robot_model.forward_kinematics(self.q0, self.q0)
        self.reset()

    def update_reference(self, p_via, r_via, bp1, br1, e_r_bound, a_sets,
                         b_sets, obstacles, spiral_blend: float = 0.0,
                         spiral_sub: int = 4):
        """New plan hand-off (the span ``node.handoff``). ``spiral_blend >
        0`` blends the path's corners with euler spirals
        (`path.euler_spiral.blend_corners`)."""
        with telemetry.span("node.handoff"):
            self.p0 = self.p_lie.copy()
            self.q0 = self.q.copy()
            self.qf = self.q0.copy()
            self.mpc.update(
                p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets, obstacles,
                self.v, p0=self.p0, params=self.params,
                spiral_blend=spiral_blend, spiral_sub=spiral_sub,
            )

    def step(self, verbose: bool = False):
        """One control period, the span ``node.step``: ``node.fk`` (each
        forward kinematics), ``tick`` (`BoundMPC.step`) and
        ``node.integrate``; ``t_loop`` is its duration. The telemetry
        record is built after it, in the span ``node.record``."""
        with telemetry.span("node.step") as period:
            with telemetry.span("node.fk"):
                self.p_lie, jac_fk, _ = self.robot_model.forward_kinematics(self.q, self.dq)

            traj_data, ref_data, err_data, self.t_mpc, iters = self.mpc.step(
                self.q, self.dq, self.ddq, self.p_lie, self.v, self.jerk, self.qf
            )
            with telemetry.span("node.integrate"):
                self.traj = traj_data["p"]
                self.traj_data = traj_data
                self.ref_data = ref_data
                self.fails.append(1.0 if self.mpc.error_count > 0 else 0.0)

                self.t_current += self.dt
                self.k_current += 1

                jerk_traj = traj_data["dddq"]
                self.q, self.dq, self.ddq = integrate_jerk_step(
                    self.q, self.dq, self.ddq, jerk_traj[:, 0], jerk_traj[:, 1], self.dt
                )
                self.qf = traj_data["q"][:, -1]
                self.jerk = jerk_traj[:, 1]

            # pose and twist of the integrated state
            with telemetry.span("node.fk"):
                self.p_lie, jac, _ = self.robot_model.forward_kinematics(self.q, self.dq)
                self.v = jac @ self.dq
                self.p = self.p_lie
        t_loop = period.duration
        self.t_overhead = t_loop - self.t_mpc
        with telemetry.span("node.record"):
            carry = self.mpc.carry
            self.telemetry.record_tick(
                MPCTickRecord(
                    t=self.t_current,
                    t_comp=self.t_mpc,
                    t_loop=t_loop,
                    t_overhead=self.t_overhead,
                    cost=float(getattr(self.mpc, "last_cost", 0.0)),
                    iterations=iters,
                    phi=float(self.mpc.phi_current[0]),
                    dphi=float(carry.dphi_current),
                    phi_max=float(self.mpc.phi_max[0]),
                    sector=int(carry.path.sector),
                    success=bool(ref_data.get("success", True)),
                    viol=float(getattr(self.mpc, "last_viol", 0.0)),
                    e_p=np.asarray(err_data["e_p"][1]),
                    e_r=np.asarray(err_data["e_r"][1]),
                    p_ref=np.asarray(ref_data["p"][1]),
                    p=self.p_lie.copy(),
                    q=self.q.copy(),
                )
            )
        if verbose:
            print(
                f"(MPCNode) t={self.t_current:.1f}s phi="
                f"{self.mpc.phi_current[0]:.3f}/{self.mpc.phi_max[0]:.3f} "
                f"t_comp={self.t_mpc*1000:.0f}ms iters={iters}"
            )
        if self.realtime:
            time.sleep(max(0.0, self.dt - t_loop))
