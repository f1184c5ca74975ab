"""The Kinova gen3 through the port's OCP, against JAX.

The setup of tests/test_gen3_e2e.py (``MPCParams(robot="gen3")``, the
default 12 SQP x 25 dense IPM iterations in float64, start
q0 = [0, 0.5, 0, 1.2, 0, -0.8, 0]): the port plans its translation task
(a floor slab, the goal 0.35/0.35/0.55 m) once in float64 on the CPU; JAX's
``MPCNode`` and the port's take that plan and run 2 ticks; q, dq, the
measured pose and the tick telemetry agree within 1e-7. The node's
measurement uses the gen3's own chain on both sides (JAX's
``RobotModel.forward_kinematics`` does; its ``djacobian_fk``,
``velocity_ee`` and ``omega_ee``, which use the iiwa14 chain, are not on
this path).
"""

import numpy as np
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu.config import MPCParams as JParams
from boundplanner_tpu.mpc.node import MPCNode as JNode
from boundplanner_tpu_torch.config import MPCParams
from boundplanner_tpu_torch.mpc import MPCNode
from boundplanner_tpu_torch.parallel.fleet import DEFAULT_ER_BOUND
from boundplanner_tpu_torch.planner.planner import BoundPlanner

torch.set_num_threads(1)
Q0 = np.array([0.0, 0.5, 0.0, 1.2, 0.0, -0.8, 0.0])
TOL = 1e-7
TICKS = 2


def plan(node):
    pose0 = node.p0
    r0 = R.from_rotvec(np.array(pose0[3:])).as_matrix()
    floor = [[-1.0, -1.0, -0.2, 1.0, 1.0, 0.05]]
    planner = BoundPlanner(e_p_max=0.5, obstacles=floor, workspace_max=[1.0, 1.0, 1.2],
                           workspace_min=[-1.0, -1.0, 0.05], seed=0, device="cpu",
                           dtype=torch.float64)
    p_via, r_via, bp1, sets_via = planner.plan_convex_set_path(
        pose0[:3].copy(), np.array([0.35, 0.35, 0.55]), r0, r0.copy())
    n = len(bp1)
    return (p_via, r_via, bp1, [np.array([0.0, 0.0, 1.0])] * n, [DEFAULT_ER_BOUND] * n,
            [x[0] for x in sets_via], [x[1] for x in sets_via], floor)


def test_gen3_ticks_match_jax():
    port = MPCNode(Q0, MPCParams(robot="gen3"), device="cpu", dtype=torch.float64)
    ref = JNode(Q0, JParams(robot="gen3"))
    np.testing.assert_allclose(port.p0, ref.p0, rtol=0, atol=1e-12)
    args = plan(port)
    for node in (port, ref):
        node.update_reference(*args)
    for _ in range(TICKS):
        ref.step()
        port.step()
        for key in ("q", "dq", "p_lie"):
            np.testing.assert_allclose(getattr(port, key), getattr(ref, key), rtol=0, atol=TOL,
                                       err_msg=key)
    jtel, ttel = ref.telemetry.arrays(), port.telemetry.arrays()
    for key in ("cost", "phi", "dphi", "viol", "e_p", "e_r", "p_ref", "p", "q"):
        scale = max(1.0, float(np.abs(jtel[key]).max()))
        np.testing.assert_allclose(ttel[key], jtel[key], rtol=0, atol=TOL * scale, err_msg=key)
    np.testing.assert_array_equal(ttel["success"], jtel["success"])
    assert port.fails == ref.fails
    assert float(port.mpc.phi_current[0]) > 0.0

