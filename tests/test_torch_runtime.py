"""The single-arm runtime's parts against the JAX package, on the CPU:

- the kinematics extras and ``RobotModel`` for the iiwa14 and the gen3,
  to 1e-12; the gen3's ``djacobian_fk``/``velocity_ee``/``omega_ee``
  against a jvp of JAX's gen3 chain (the JAX package's own functions use
  the iiwa14 chain there: a reference fault the port does not copy);
- IK (60 damped Gauss-Newton steps) to 1e-9;
- the numpy ports: euler-spiral blending and ``build_path(spiral_blend)``
  to 1e-12, the jerk spline to 1e-12, the demo scenes exactly;
- telemetry arrays and summary exactly; checkpoints written by either
  package load in the other bit for bit, a schema mismatch raises, and a
  resumed ``BoundMPC`` steps exactly as the uninterrupted one;
- ``closed_loop_rollout`` of the demo scene against JAX in float64.
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp
import torch

from boundplanner_tpu import checkpoint as jckpt
from boundplanner_tpu import demo as jdemo
from boundplanner_tpu import telemetry as jtel
from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc import bound_mpc as jmpc
from boundplanner_tpu.parallel import batch as jbatch
from boundplanner_tpu.path import euler_spiral as jspiral
from boundplanner_tpu.path import reference_path as jpath
from boundplanner_tpu.robot import kinematics as jkin
from boundplanner_tpu.robot import model as jmodel
from boundplanner_tpu.utils import jerk_spline as jjerk
from boundplanner_tpu_torch import checkpoint as tckpt
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch import demo as tdemo
from boundplanner_tpu_torch import telemetry as ttel
from boundplanner_tpu_torch.mpc import bound_mpc as tmpc
from boundplanner_tpu_torch.parallel import batch as tbatch
from boundplanner_tpu_torch.path import euler_spiral as tspiral
from boundplanner_tpu_torch.path import reference_path as tpath
from boundplanner_tpu_torch.robot import kinematics as tkin
from boundplanner_tpu_torch.robot import model as tmodel
from boundplanner_tpu_torch.utils import jerk_spline as tjerk
from boundplanner_tpu_torch.utils.tree import to_numpy, to_torch

torch.set_num_threads(1)
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
ROBOTS = ["iiwa14", "gen3"]
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180


def close(j, t, tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0, atol=tol)


def joint_samples(seed=31, count=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2.0, 2.0, size=(count, 7)), rng.normal(size=(count, 7))


def jchain(robot):
    return jkin.chain_by_name(robot)


def tchain(robot):
    return tkin.Chain(robot).to("cpu", torch.float64)


@pytest.mark.parametrize("robot", ROBOTS)
def test_kinematics_extras_match_jax(robot):
    qs, dqs = joint_samples()
    jc, tc = jchain(robot), tchain(robot)
    t = torch.from_numpy
    for q, dq in zip(qs, dqs):
        jq, jdq = jnp.asarray(q), jnp.asarray(dq)
        close(jkin.fk_ee_htm(jq, jc), tkin.fk_ee_htm(t(q), tc), 1e-12)
        close(jkin.fk_pos(jq, jc), tkin.fk_pos(t(q), tc), 1e-12)
        jdj = jax.jvp(lambda qq: jkin.jacobian_fk(qq, jc), (jq,), (jdq,))[1]
        close(jdj, tkin.djacobian_fk(t(q), t(dq), tc), 1e-12)
        jv = jkin.jacobian_fk(jq, jc) @ jdq
        close(jv[:3], tkin.velocity_ee(t(q), t(dq), tc), 1e-12)
        close(jv[3:], tkin.omega_ee(t(q), t(dq), tc), 1e-12)
        pose, jac, dj = tkin.forward_kinematics(t(q), t(dq), tc)
        close(jkin.fk_pose(jq, jc), pose, 1e-12)
        close(jkin.jacobian_fk(jq, jc), jac, 1e-12)
        close(jdj, dj, 1e-12)
        for i in (0, 4, 6):
            jcol = lambda qq: jkin.fk_frames(qq, jc)["p_col"][i]
            close(jcol(jq), tkin.fk_pos_col(t(q), i, tc), 1e-12)
            close(jax.jacfwd(jcol)(jq), tkin.jacobian_col(t(q), i, tc), 1e-12)
    # batched inputs: the leading dims pass through
    close(np.stack([np.asarray(jkin.fk_ee_htm(jnp.asarray(q), jc)) for q in qs]),
          tkin.fk_ee_htm(t(qs), tc), 1e-12)


def test_iiwa14_free_functions_match_jax():
    """The JAX package's chain-less iiwa14 functions."""
    qs, dqs = joint_samples(32)
    tc = tchain("iiwa14")
    for q, dq in zip(qs, dqs):
        tq, tdq = torch.from_numpy(q), torch.from_numpy(dq)
        jq, jdq = jnp.asarray(q), jnp.asarray(dq)
        close(jkin.djacobian_fk(jq, jdq), tkin.djacobian_fk(tq, tdq, tc), 1e-12)
        close(jkin.velocity_ee(jq, jdq), tkin.velocity_ee(tq, tdq, tc), 1e-12)
        close(jkin.omega_ee(jq, jdq), tkin.omega_ee(tq, tdq, tc), 1e-12)
        close(jkin.jacobian_col(jq, 3), tkin.jacobian_col(tq, 3, tc), 1e-12)
        for j, t in zip(jkin.forward_kinematics(jq, jdq), tkin.forward_kinematics(tq, tdq, tc)):
            close(j, t, 1e-12)


@pytest.mark.parametrize("robot", ROBOTS)
def test_robot_model_matches_jax(robot):
    """The numpy facade. For the gen3, JAX's ``djacobian_fk``/
    ``velocity_ee``/``omega_ee`` differentiate the iiwa14 chain (reference
    fault (f)): the port's are held to a jvp of the gen3 chain instead,
    and shown to differ from JAX's faulty ones."""
    jm, tm = jmodel.RobotModel(robot), tmodel.RobotModel(robot, device="cpu")
    for j, t in zip(jm.get_robot_limits(), tm.get_robot_limits()):
        np.testing.assert_array_equal(t, j)
    qs, dqs = joint_samples(33)
    jc = jchain(robot)
    for q, dq in zip(qs, dqs):
        for j, t in zip(jm.forward_kinematics(q, dq), tm.forward_kinematics(q, dq)):
            close(j, t, 1e-12)
        close(jm.fk(q), tm.fk(q), 1e-12)
        close(jm.fk_pos(q), tm.fk_pos(q), 1e-12)
        close(jm.hom_transform_endeffector(q), tm.hom_transform_endeffector(q), 1e-12)
        close(jm.jacobian_fk(q), tm.jacobian_fk(q), 1e-12)
        close(jm.fk_pos_col(q, 2), tm.fk_pos_col(q, 2), 1e-12)
        jq, jdq = jnp.asarray(q), jnp.asarray(dq)
        dj = jax.jvp(lambda qq: jkin.jacobian_fk(qq, jc), (jq,), (jdq,))[1]
        close(dj, tm.djacobian_fk(q, dq), 1e-12)
        twist = np.asarray(jkin.jacobian_fk(jq, jc) @ jdq)
        close(twist[:3], tm.velocity_ee(q, dq), 1e-12)
        close(twist[3:], tm.omega_ee(q, dq), 1e-12)
        if robot == "iiwa14":
            close(jm.djacobian_fk(q, dq), tm.djacobian_fk(q, dq), 1e-12)
            close(jm.velocity_ee(q, dq), tm.velocity_ee(q, dq), 1e-12)
            close(jm.omega_ee(q, dq), tm.omega_ee(q, dq), 1e-12)
        else:   # fault (f) trips: JAX's gen3 facade answers with the iiwa14
            assert np.abs(jm.djacobian_fk(q, dq) - tm.djacobian_fk(q, dq)).max() > 1e-3
            assert np.abs(jm.velocity_ee(q, dq) - tm.velocity_ee(q, dq)).max() > 1e-3


@pytest.mark.parametrize("robot", ROBOTS)
def test_inverse_kinematics_matches_jax(robot):
    jm, tm = jmodel.RobotModel(robot), tmodel.RobotModel(robot, device="cpu")
    q0 = np.array([0.0, 0.3, 0.0, -1.2, 0.0, 1.0, 0.0])
    pose = tm.fk(q0 + np.array([0.2, -0.1, 0.15, 0.1, -0.2, 0.1, 0.3]))
    pd, rd = pose[:3], R.from_rotvec(pose[3:]).as_matrix()
    qj = jm.inverse_kinematics(pd, rd, q0)
    qt = tm.inverse_kinematics(pd, rd, q0)
    close(qj, qt, 1e-9)
    assert np.abs(tm.fk_pos(qt) - pd).max() < 1e-6


def corner_scene():
    """Three vias with a right-angle corner inside two overlapping boxes."""
    def box(lo, hi):
        a = np.vstack([np.eye(3), -np.eye(3), np.zeros((9, 3))])
        return a, np.concatenate([hi, -lo, 10.0 * np.ones(9)])

    p_via = [np.array([0.4, 0.2, 0.5]), np.array([0.4, -0.1, 0.5]),
             np.array([0.4, -0.1, 0.7])]
    r = R.from_rotvec([[0.0, 0.0, 0.0], [0.0, 0.0, 0.4], [0.3, 0.0, 0.4]]).as_matrix()
    sets = [box(np.array([0.3, -0.2, 0.4]), np.array([0.5, 0.3, 0.6])),
            box(np.array([0.3, -0.2, 0.4]), np.array([0.5, 0.0, 0.8]))]
    return (p_via, list(r), [np.array([0.0, 0.0, 1.0])] * 2,
            [np.array([0.0, 0.0, 1.0])] * 2, [ERB] * 2,
            [s[0] for s in sets], [s[1] for s in sets])


@pytest.mark.parametrize("n_sub", [2, 4])
def test_euler_spiral_and_blended_path_match_jax(n_sub):
    scene = corner_scene()
    s = np.linspace(0.0, 0.1, 7)
    close(jspiral.eval_euler_spiral(3.0, s), tspiral.eval_euler_spiral(3.0, s), 1e-12)
    jout = jspiral.blend_corners(*scene, length=0.05, n_sub=n_sub)
    tout = tspiral.blend_corners(*scene, length=0.05, n_sub=n_sub)
    assert len(tout[0]) == len(jout[0]) == 3 + n_sub
    for jl, tl in zip(jout, tout):
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            close(j, t, 1e-12)
    jp = jpath.build_path(*scene, nr_segs=4, spiral_blend=0.05, spiral_sub=n_sub)
    tp = tpath.build_path(*scene, nr_segs=4, spiral_blend=0.05, spiral_sub=n_sub)
    for j, t in zip(jp, tp):
        close(j, t, 1e-12)


@pytest.mark.parametrize("t", [0.0, 0.05, 0.1, 0.23, 0.5, 0.9])
def test_jerk_spline_matches_jax(t):
    rng = np.random.default_rng(34)
    for u in (rng.normal(size=6), rng.normal(size=(6, 7))):
        kw = dict(q0=0.3, v0=-0.2, a0=0.5)
        for j, tt in zip(jjerk.eval_spline(jnp.asarray(u), 0.1, t, **kw),
                         tjerk.eval_spline(torch.from_numpy(u), 0.1, t, **kw)):
            close(j, tt, 1e-12)
    close(jjerk.eval_position(jnp.asarray(u), 0.1, 0.1, 0.2, 0.3, t),
          tjerk.eval_position(u, 0.1, 0.1, 0.2, 0.3, t), 1e-12)


def leaves(tree):
    """Leaves in one order for both packages' trees (dict keys sorted, as
    JAX flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def assert_trees_equal(j, t):
    jl, tl = leaves(j), leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_demo_scenes_equal_jax(dtype):
    cfg, tcfg = MPCParams(**SMALL), tconfig.MPCParams(**SMALL)
    assert_trees_equal(jdemo.demo_scene(cfg, dtype), tdemo.demo_scene(tcfg, dtype))
    assert_trees_equal(jdemo.demo_fleet(cfg, 3, dtype), tdemo.demo_fleet(tcfg, 3, dtype))
    carry, meas, obs, _ = tdemo.demo_scene(tcfg, dtype)
    assert_trees_equal(jdemo.stack_scenes(carry, meas, obs, 2),
                       tdemo.stack_scenes(carry, meas, obs, 2))


def test_telemetry_matches_jax():
    records = []
    for k in range(6):
        rng = np.random.default_rng(k)
        records.append(dict(
            t=0.1 * k, t_comp=rng.uniform(), t_loop=rng.uniform(), t_overhead=0.01,
            cost=rng.uniform(), iterations=k, phi=0.05 * k, dphi=0.1, phi_max=1.0,
            sector=k // 3, success=k != 2, viol=rng.uniform() * 1e-3,
            e_p=rng.normal(size=3), e_r=rng.normal(size=3), p_ref=rng.normal(size=6),
            p=rng.normal(size=6), q=rng.normal(size=7)))
    jr, tr = jtel.TelemetryRecorder(), ttel.TelemetryRecorder()
    for rec in records:
        jr.record_tick(jtel.MPCTickRecord(**rec))
        tr.record_tick(ttel.MPCTickRecord(**rec))
    ja, ta = jr.arrays(), tr.arrays()
    assert list(ja) == list(ta)
    for key in ja:
        np.testing.assert_array_equal(ta[key], ja[key])
    assert tr.summary() == jr.summary()


def random_carry(seed):
    """The demo scene's carry with every float leaf filled from a seed."""
    carry = jdemo.demo_scene(MPCParams(**SMALL), np.float64)[0]
    rng = np.random.default_rng(seed)
    fill = lambda a: (rng.normal(size=np.shape(a)).astype(np.asarray(a).dtype)
                      if np.asarray(a).dtype.kind == "f" else np.asarray(a))
    return jax.tree.map(fill, carry)


def test_checkpoints_cross_load_bit_exact(tmp_path):
    carry = random_carry(35)
    jckpt.save_carry(tmp_path / "jax.npz", carry)
    loaded = tckpt.load_carry(tmp_path / "jax.npz", device="cpu", dtype=torch.float64)
    assert isinstance(loaded, tmpc.MPCCarry)
    assert_trees_equal(carry, to_numpy(loaded))
    tckpt.save_carry(tmp_path / "port.npz", loaded)
    assert_trees_equal(carry, jckpt.load_carry(tmp_path / "port.npz"))
    # a batched fleet's carry round-trips the same way
    fleet = to_torch(tdemo.demo_fleet(tconfig.MPCParams(**SMALL), 3, np.float64)[0],
                     "cpu", torch.float64)
    tckpt.save_carry(tmp_path / "fleet.npz", fleet)
    assert_trees_equal(to_numpy(fleet), jckpt.load_carry(tmp_path / "fleet.npz"))


def test_checkpoint_schema_mismatch_raises(tmp_path):
    carry = to_numpy(to_torch(random_carry(36), "cpu", torch.float64))
    arrays = {"x_prev": carry.x_prev}
    np.savez(tmp_path / "short.npz", __version__=2, **arrays)
    with pytest.raises(ValueError, match="schema mismatch"):
        tckpt.load_carry(tmp_path / "short.npz", device="cpu")
    np.savez(tmp_path / "v1.npz", __version__=1, **arrays)
    with pytest.raises(ValueError, match="format v1"):
        tckpt.load_carry(tmp_path / "v1.npz", device="cpu")


def straight_mpc():
    q0 = tdemo.DEMO_Q0
    p0 = tdemo._fk_pose_np(q0)
    r0 = R.from_rotvec(p0[3:]).as_matrix()
    args = ([p0[:3].copy(), p0[:3] + np.array([0.0, -0.25, 0.0])], [r0, r0],
            [np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [ERB],
            [np.zeros((15, 3))], [np.ones(15)], [[0.7, -0.2, 0.0, 0.9, 0.0, 0.4]])
    return q0, p0, args


def test_resumed_bound_mpc_steps_as_uninterrupted(tmp_path):
    q0, p0, args = straight_mpc()
    cfg = tconfig.MPCParams(**SMALL)
    z7, z6 = np.zeros(7), np.zeros(6)
    a = tmpc.BoundMPC(*args, p0=p0, params=cfg, device="cpu")
    a.step(q0, z7, z7, p0, z6, z7)
    tckpt.save_carry(tmp_path / "carry.npz", a.carry)
    b = tmpc.BoundMPC(*args, p0=p0, params=cfg, device="cpu")
    b.carry = tckpt.load_carry(tmp_path / "carry.npz", device="cpu")
    out_a, out_b = a.step(q0, z7, z7, p0, z6, z7), b.step(q0, z7, z7, p0, z6, z7)
    for key in out_a[0]:
        np.testing.assert_array_equal(out_b[0][key], out_a[0][key])
    assert_trees_equal(to_numpy(a.carry), to_numpy(b.carry))


def test_cartesian_acc_matches_jax():
    rng = np.random.default_rng(37)
    q, dq, ddq = rng.normal(size=(3, 14, 7))
    for robot in ROBOTS:
        j = jmpc._cartesian_acc(jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq), robot=robot)
        t = tmpc._cartesian_acc(*(torch.from_numpy(a) for a in (q, dq, ddq)), tchain(robot))
        close(j, t, 1e-12)


def test_closed_loop_rollout_matches_jax():
    """The demo scene's single-scene closed loop, 2 ticks, float64."""
    cfg, tcfg = MPCParams(**SMALL), tconfig.MPCParams(**SMALL)
    carry, _, obs, q0 = tdemo.demo_scene(tcfg, np.float64)
    jcarry = jmpc.MPCCarry(jmpc.PathState(*carry.path), *carry[1:])
    jfinal, jrecs = jbatch.closed_loop_rollout(jcarry, jnp.asarray(q0), jmpc.ObstacleArrays(*obs),
                                               cfg, 2)
    model = tmpc.FleetMPC(tcfg, device="cpu", dtype=torch.float64)
    tfinal, trecs = tbatch.closed_loop_rollout(*to_torch((carry, q0, obs), "cpu", torch.float64),
                                               model, 2)
    trecs = to_numpy(trecs)
    for key in ("q", "p", "phi", "viol"):
        assert trecs[key].shape == np.asarray(jrecs[key]).shape
        close(jrecs[key], trecs[key], 1e-7)
    np.testing.assert_array_equal(trecs["success"], np.asarray(jrecs["success"]))
    close(jfinal.x_prev, to_numpy(tfinal.x_prev),
          1e-7 * max(1.0, np.abs(np.asarray(jfinal.x_prev)).max()))
