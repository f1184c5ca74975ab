"""The port's single-arm runtime against the JAX package: ``MPCNode`` on
the straight-line scene of tests/test_mpc.py in float64 at a reduced
budget (2 SQP x 6 IPM iterations, 2 line-search candidates, the default
dense route otherwise), 3 ticks; then a warm-carry replan onto a path
with a corner (1 tick) and a replan with euler-spiral corner blending
(1 tick). q, dq, the measured pose ``p_lie`` and every non-timing
telemetry field agree within 1e-7 after each tick. Also one ``BoundMPC``
tick of the default configuration ``MPCParams()``, and the card default
of the entry points.

Both nodes run on the CPU: the port's with ``device="cpu"`` (the kernels'
plain versions), JAX's under the test suite's x64 CPU setup.
"""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import torch

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc.bound_mpc import BoundMPC as JBoundMPC
from boundplanner_tpu.mpc.node import MPCNode as JNode
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch.mpc import BoundMPC, MPCNode
from boundplanner_tpu_torch.mpc.bound_mpc import FleetMPC

torch.set_num_threads(1)
Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
TOL = 1e-7
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
FIELDS = ("t", "cost", "iterations", "phi", "dphi", "phi_max", "sector", "success",
          "viol", "e_p", "e_r", "p_ref", "p", "q")


def straight(node):
    p0 = node.p0.copy()
    r0 = R.from_rotvec(np.array(p0[3:])).as_matrix()
    return ([p0[:3].copy(), p0[:3] + np.array([0.0, -0.25, 0.0])], [r0, r0],
            [np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [ERB],
            [np.zeros((15, 3))], [np.ones(15)], [])


def corner(node):
    """Two segments from the current pose: -y, then +z, free sets."""
    p = node.p_lie[:3].copy()
    r0 = R.from_rotvec(np.array(node.p_lie[3:])).as_matrix()
    vias = [p, p + np.array([0.0, -0.12, 0.0]), p + np.array([0.0, -0.12, 0.12])]
    return (vias, [r0] * 3, [np.array([0.0, 0.0, 1.0])] * 2,
            [np.array([0.0, 0.0, 1.0])] * 2, [ERB] * 2,
            [np.zeros((15, 3))] * 2, [np.ones(15)] * 2, [[0.7, -0.6, 0.0, 0.9, -0.5, 0.3]])


def snapshot(node):
    return {"q": node.q.copy(), "dq": node.dq.copy(), "p_lie": np.array(node.p_lie)}


@pytest.fixture(scope="module")
def runs():
    """Both nodes through the same script; per step (name, state, fails)."""
    out = {}
    for name, make in (("jax", lambda: JNode(Q0, MPCParams(**SMALL))),
                       ("port", lambda: MPCNode(Q0, tconfig.MPCParams(**SMALL),
                                                device="cpu", dtype=torch.float64))):
        node = make()
        steps = []
        node.update_reference(*straight(node))
        for _ in range(3):
            node.step()
            steps.append(("straight", snapshot(node)))
        node.update_reference(*corner(node))
        node.step()
        steps.append(("warm_replan", snapshot(node)))
        node.update_reference(*corner(node), spiral_blend=0.03, spiral_sub=2)
        node.step()
        steps.append(("spiral_replan", snapshot(node)))
        out[name] = (steps, node.telemetry.arrays(), list(node.fails),
                     node.mpc.carry.path.num_sectors)
    return out


@pytest.mark.parametrize("i", range(5), ids=["tick1", "tick2", "tick3", "warm_replan",
                                              "spiral_replan"])
def test_node_state_matches_jax(runs, i):
    (jname, jstate), (tname, tstate) = runs["jax"][0][i], runs["port"][0][i]
    assert jname == tname
    for key in ("q", "dq", "p_lie"):
        np.testing.assert_allclose(tstate[key], jstate[key], rtol=0, atol=TOL, err_msg=key)


def test_telemetry_matches_jax(runs):
    jtel, ttel = runs["jax"][1], runs["port"][1]
    assert set(jtel) == set(ttel)
    for key in FIELDS:
        j, t = np.asarray(jtel[key]), np.asarray(ttel[key])
        assert t.shape == j.shape, key
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(t, j, err_msg=key)
        else:
            scale = max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL * scale, err_msg=key)
    assert runs["port"][2] == runs["jax"][2]
    assert ttel["t_comp"].shape == (5,) and (ttel["t_comp"] > 0).all()


def test_spiral_replan_blended_the_corner(runs):
    """The spiral hand-off really blended: sub-segments sampled on the
    clothoid replace the corner, so the path has more than the corner
    path's 2 segments (num_sectors 1), the same number in both."""
    assert int(runs["port"][3]) == int(np.asarray(runs["jax"][3])) > 1


def test_entry_points_default_to_the_card():
    """MPCNode, BoundMPC and RobotModel default to the card and raise at
    once without one (run where no CUDA device is present)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from boundplanner_tpu_torch.robot.model import RobotModel

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPCNode(Q0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RobotModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BoundMPC([np.zeros(3), np.ones(3)], [np.eye(3)] * 2, [np.ones(3)], [np.ones(3)],
                 [ERB], [np.zeros((15, 3))], [np.ones(15)], [])


def test_reconfigure_rebuilds_at_current_pose():
    node = MPCNode(Q0, tconfig.MPCParams(**SMALL), device="cpu")
    node.update_reference(*straight(node))
    node.step()
    cfg = dataclasses.replace(tconfig.MPCParams(**SMALL), manual_jac=True)
    node.reconfigure(cfg)
    assert node.mpc.cfg == cfg and isinstance(node.mpc.model, FleetMPC)
    np.testing.assert_allclose(node.p0, node.p_lie, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(node.q0, node.q)
    node.step()
    assert np.isfinite(node.q).all() and len(node.fails) == 2


def test_default_config_tick_matches_jax():
    """One ``BoundMPC.step`` of the default configuration ``MPCParams()``
    (12 SQP x 25 IPM iterations, forward-mode Jacobian, dense QP on 2439
    rows) from the straight-line scene, against JAX in float64."""
    node = MPCNode(Q0, device="cpu")
    p0 = node.p0
    args = straight(node)
    z7, z6 = np.zeros(7), np.zeros(6)
    jm = JBoundMPC(*args, p0=p0)
    tm = BoundMPC(*args, p0=p0, device="cpu")
    assert tm.cfg == tconfig.MPCParams() and tm.dtype == torch.float64
    jout = jm.step(Q0, z7, z7, p0, z6, z7)
    tout = tm.step(Q0, z7, z7, p0, z6, z7)
    for key in ("q", "dq", "dddq", "p", "phi"):
        scale = max(1.0, np.abs(jout[0][key]).max())
        np.testing.assert_allclose(tout[0][key], jout[0][key], rtol=0, atol=TOL * scale)
    assert tout[1]["success"] == jout[1]["success"]
    assert tout[4] == jout[4]
    np.testing.assert_allclose(tm.last_cost, jm.last_cost, rtol=1e-9)
