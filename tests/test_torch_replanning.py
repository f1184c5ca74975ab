"""The replanning flow in the port (counterparts of ``tests/test_replanning.py``):

- tier 1: ``BoundMPC.update(warm_carry=True)`` keeps the previous solution
  across a replan. The JAX test's flow (3 tracked ticks, then a replan to
  a shifted goal from the current pose, then one tick from the carried
  warm start and one from a cold start) runs in both packages in float64;
  the port's first post-replan tick of each arm agrees with JAX's (the
  flags exactly, viol, cost and the trajectory within 1e-7 of their
  scale), and the warm arm is no worse than the cold one on any axis and
  better on one, the JAX test's bar;
- slow (as JAX's): a new obstacle appears mid-track, the planner replans
  from the current pose with the committed horizon, ``MPCNode`` tracks
  the new plan (``MPCParams()``, float64 on the CPU) without digging into
  the new obstacle.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import jax.numpy as jnp

from boundplanner_tpu.config import MPCParams as JaxMPCParams
from boundplanner_tpu.mpc.bound_mpc import BoundMPC as JaxBoundMPC
from boundplanner_tpu.robot import kinematics as jkin
from boundplanner_tpu.utils.integration import integrate_jerk_step as jax_integrate
from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.demo import DEMO_Q0
from boundplanner_tpu_torch.mpc import MPCNode
from boundplanner_tpu_torch.mpc.bound_mpc import BoundMPC
from boundplanner_tpu_torch.planner.planner import BoundPlanner
from boundplanner_tpu_torch.robot import kinematics as kin
from boundplanner_tpu_torch.utils.integration import integrate_jerk_step

torch.set_num_threads(1)
# perf iteration counts in f64, the configuration of the JAX test
FIELDS = dict(sqp_iters=3, qp_iters=5, qp_gondzio=1, line_search_steps=4, warm_shift=True,
              struct_ocp=True, struct_chunked=False)
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180


def jax_plant(q, dq):
    pose = np.array(jkin.fk_pose(jnp.asarray(q)))
    return pose, np.array(jkin.jacobian_fk(jnp.asarray(q)) @ dq)


def jax_step(q, dq, ddq, u0, u1, dt):
    return tuple(np.array(a) for a in jax_integrate(*(jnp.asarray(x) for x in
                                                        (q, dq, ddq, u0, u1)), dt))


def port_plant(chain):
    def plant(q, dq):
        qt = torch.from_numpy(np.asarray(q, np.float64))
        pose = kin.fk_pose(qt, chain).numpy()
        return pose, (kin.jacobian_fk(qt, chain) @ torch.from_numpy(dq)).numpy()
    return plant


def port_step(q, dq, ddq, u0, u1, dt):
    return tuple(t.numpy() for t in integrate_jerk_step(
        *(torch.from_numpy(np.asarray(x, np.float64)) for x in (q, dq, ddq, u0, u1)), dt))


def warm_carry_flow(make_mpc, plant, step, cfg):
    """The JAX test's flow. Returns {warm: (success, viol, cost, traj)} of
    the first tick after the replan."""
    q = DEMO_Q0.astype(np.float64)
    pose0, _ = plant(q, np.zeros(7))
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    goal = pose0[:3] + np.array([0.0, -0.3, 0.0])
    common = ([np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [ERB],
              [np.zeros((15, 3))], [np.ones(15)])
    mpc = make_mpc([pose0[:3].copy(), goal], [r0, r0], *common, obstacles=[], p0=pose0,
                   params=cfg)
    dq, ddq, jerk, qf = np.zeros(7), np.zeros(7), np.zeros(7), q.copy()
    for _ in range(3):
        pose, v0 = plant(q, dq)
        traj, ref, _, _, _ = mpc.step(q, dq, ddq, pose, v0, jerk, qf)
        assert ref["success"]
        u0, u1 = traj["dddq"][:, 0], traj["dddq"][:, 1]
        q, dq, ddq = step(q, dq, ddq, u0, u1, cfg.dt)
        jerk, qf = np.asarray(u1), traj["q"][:, -1]
    saved = mpc.carry
    pose, v0 = plant(q, dq)
    new_vias = [pose[:3].copy(), goal + np.array([-0.05, -0.05, 0.05])]
    results = {}
    for warm in (True, False):
        mpc.carry = saved
        mpc.update(new_vias, [r0, r0], *common, obstacles=[], v=np.asarray(v0), p0=pose,
                   warm_carry=warm)
        assert bool(np.asarray(mpc.carry.has_prev)) == warm
        traj, ref, _, _, _ = mpc.step(q, dq, ddq, pose, v0, jerk, qf)
        results[warm] = (bool(ref["success"]), mpc.last_viol, mpc.last_cost, traj)
    return results


@pytest.fixture(scope="module")
def flows():
    jax_res = warm_carry_flow(JaxBoundMPC, jax_plant, jax_step, JaxMPCParams(**FIELDS))
    cfg = MPCParams(**FIELDS)
    chain = kin.Chain().to(torch.float64)
    port_res = warm_carry_flow(
        lambda *a, **k: BoundMPC(*a, **k, device="cpu", dtype=torch.float64),
        port_plant(chain), port_step, cfg)
    return jax_res, port_res


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_first_tick_after_replan_matches_jax(flows, warm):
    jax_res, port_res = flows
    (s_j, viol_j, cost_j, traj_j), (s_t, viol_t, cost_t, traj_t) = jax_res[warm], port_res[warm]
    assert s_t == s_j
    np.testing.assert_allclose(cost_t, cost_j, rtol=1e-7)
    np.testing.assert_allclose(viol_t, viol_j, rtol=0, atol=1e-9)
    for key in ("q", "p", "dddq"):
        scale = np.abs(traj_j[key]).max()
        np.testing.assert_allclose(traj_t[key], traj_j[key], rtol=0, atol=1e-7 * scale,
                                   err_msg=key)


def test_warm_carry_first_tick_quality(flows):
    """The JAX test's bar on the port: the first post-replan solve from the
    carried warm start is no worse than the cold start, and better on at
    least one axis."""
    port_res = flows[1]
    s_w, viol_w, cost_w, _ = port_res[True]
    s_c, viol_c, cost_c, _ = port_res[False]
    assert s_w >= s_c
    assert viol_w <= viol_c + 1e-12
    assert cost_w <= cost_c * (1.0 + 1e-6)
    assert (viol_w < viol_c - 1e-9) or (cost_w < cost_c * 0.999) or (s_w > s_c)


@pytest.mark.slow
def test_replan_with_new_obstacle():
    q0 = DEMO_Q0.copy()
    node = MPCNode(q0, device="cpu")
    p0fk, _, _ = node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.45, -0.4, 0.3])
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    obstacles = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0]]
    planner = BoundPlanner(e_p_max=0.5, obstacles=obstacles, workspace_max=[1.0, 0.38, 1.0],
                           workspace_min=[-0.14, -1.0, 0.0], seed=0, device="cpu",
                           dtype=torch.float64)
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)

    def handoff(p_via, r_via, bp1_list, sets_via, obstacles):
        n = len(bp1_list)
        node.update_reference(p_via, r_via, bp1_list, [np.array([0.0, 0.0, 1.0])] * n,
                              [ERB] * n, [x[0] for x in sets_via], [x[1] for x in sets_via],
                              obstacles)

    handoff(p_via, r_via, bp1_list, sets_via, obstacles)
    for _ in range(6):
        node.step()
    assert float(node.mpc.phi_current[0]) > 0.01

    # a new obstacle appears ahead of the EE; replan from the current pose
    # with the committed horizon
    new_obstacles = obstacles + [[0.36, -0.42, 0.0, 0.5, -0.3, 0.22]]
    planner.add_obstacle_reps(new_obstacles, update=True, reset=True)
    p_now = node.p_lie[:3].copy()
    r_now = R.from_rotvec(np.array(node.p_lie[3:])).as_matrix()
    p_horizon = [np.asarray(p, float) for p in np.asarray(node.traj)[:3].T]
    p_via2, r_via2, bp1_2, sets_via2 = planner.plan_convex_set_path(
        p_now, p1, r_now, r1, replanning=True, p_horizon=p_horizon, new_obs=True)
    assert len(p_via2) >= 2
    handoff(p_via2, r_via2, bp1_2, sets_via2, new_obstacles)

    a = np.vstack([np.eye(3), -np.eye(3)])
    for _ in range(25):
        node.step()
        for ob in new_obstacles[1:]:
            b = np.concatenate([ob[3:], -np.asarray(ob[:3])])
            # the constraints are slacked and the obstacle may appear close
            # to the committed horizon: the JAX test's 1 cm
            assert np.max(a @ node.p_lie[:3] - b) > -0.01, "EE deep in new obstacle"
        if float(node.mpc.phi_current[0]) >= float(node.mpc.phi_max[0]) - 0.02:
            break
    assert float(node.mpc.phi_current[0]) > 0.5 * float(node.mpc.phi_max[0])
