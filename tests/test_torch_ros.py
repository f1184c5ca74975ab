"""The port's ROS edges against the JAX package: ``idl`` (the schema files,
``load_msg``/``load_srv`` and ``validate``) and ``ros_compat`` (the dict
payloads, the typed converters, ``RosPublisher`` over injected fake
``rclpy``/``boundmpcmsg`` modules, as tests/test_ros_compat.py and
tests/test_idl.py do, and ``MpcHostServices`` driving the port's
``MPCNode``). Payloads are equal dict for dict; tensors given to the port
give the payloads of the same numpy arrays given to JAX; the node's tick
after the services' calls matches JAX's within 1e-7 (float64, CPU).
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

import tests.test_idl as jtest_idl
import tests.test_ros_compat as jtest_ros
from boundplanner_tpu import idl as jidl
from boundplanner_tpu import ros_compat as jrc
from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc.node import MPCNode as JNode
from boundplanner_tpu.telemetry import MPCTickRecord as JRecord
from boundplanner_tpu_torch import config as tconfig
from boundplanner_tpu_torch import idl as tidl
from boundplanner_tpu_torch import ros_compat as trc
from boundplanner_tpu_torch.mpc import MPCNode
from boundplanner_tpu_torch.telemetry import MPCTickRecord as TRecord

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMAS = ["msg/MPCData.msg", "msg/Vector.msg", "srv/MPCParams.srv", "srv/Trajectory.srv"]


# --- idl --------------------------------------------------------------------

@pytest.mark.parametrize("rel", SCHEMAS)
def test_schema_files_are_the_jax_packages(rel):
    port = os.path.join(ROOT, "boundplanner_tpu_torch", "idl", rel)
    assert tidl._IDL_DIR == os.path.join(ROOT, "boundplanner_tpu_torch", "idl")
    assert filecmp.cmp(port, os.path.join(ROOT, "boundplanner_tpu", "idl", rel), shallow=False)


@pytest.mark.parametrize("name", ["MPCData", "Vector"])
def test_load_msg_equals_jax(name):
    got, ref = tidl.load_msg(name), jidl.load_msg(name)
    assert list(got) == list(ref)
    assert [tuple(f) for f in got.values()] == [tuple(f) for f in ref.values()]
    assert len(tidl.load_msg("MPCData")) == 60


@pytest.mark.parametrize("name", ["Trajectory", "MPCParams"])
def test_load_srv_equals_jax(name):
    for got, ref in zip(tidl.load_srv(name), jidl.load_srv(name)):
        assert list(got) == list(ref)
        assert [tuple(f) for f in got.values()] == [tuple(f) for f in ref.values()]


VALIDATE_CASES = [
    {"t_comp": 0.01, "fails": [0.0], "sector": 2},
    {"not_a_field": 1.0},
    {"t_comp": [0.01]},
    {"sector": 1.5},
    {"sector": True},
    {"sector": np.int64(3), "q": [[0.0] * 7], "phi": {"x": [0.1]}},
    {"q": 0.5},
]


@pytest.mark.parametrize("payload", VALIDATE_CASES, ids=range(len(VALIDATE_CASES)))
def test_validate_raises_as_jax(payload):
    def outcome(mod):
        try:
            mod.validate(mod.load_msg("MPCData"), payload)
        except ValueError as err:
            return str(err)
        return None

    assert outcome(tidl) == outcome(jidl)


# --- ros_compat payloads -----------------------------------------------------

def box(center, half):
    a = np.vstack([np.eye(3), -np.eye(3)])
    b = np.concatenate([np.asarray(center) + half, -(np.asarray(center) - half)])
    return a, b


def as_tensors(x):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x)
    if isinstance(x, (list, tuple)):
        return type(x)(as_tensors(v) for v in x)
    return x


PAYLOADS = {
    "set_marker_box": (lambda m, a, b: m.set_marker(a, b, ns="S", marker_id=3), box([0.1, 0, 0.2], 0.3)),
    "set_marker_degenerate": (lambda m, a, b: m.set_marker(a, b),
                              (np.array([[1.0, 0, 0], [-1.0, 0, 0]]), np.array([0.5, 0.5]))),
    "via_points": (lambda m, p: m.via_point_markers(p), (np.array([[0, 0, 0.5], [0.2, 0, 0.6]]),)),
    "spheres": (lambda m, c, r: m.collision_sphere_markers(c, r),
                (np.arange(9.0).reshape(3, 3) / 10, np.array([0.1, 0.1, 0.2]))),
    "path": (lambda m, p: m.path_msg(p), (np.array([[0, 0, 0], [0.1, 0.2, 0.3]]),)),
    "joint_state": (lambda m, q: m.joint_state_msg(q), (np.arange(7.0),)),
}


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name", list(PAYLOADS))
def test_payloads_equal_jax(name, tensors):
    build, args = PAYLOADS[name]
    ref = build(jrc, *args)
    got = build(trc, *(as_tensors(args) if tensors else args))
    assert got == ref
    assert trc.delete_all_marker() == jrc.delete_all_marker()


def record(cls):
    return cls(t=0.1, t_comp=0.02, t_loop=0.03, t_overhead=0.01, cost=1.5, iterations=3,
               phi=0.25, dphi=0.4, phi_max=1.2, sector=1, success=True, viol=0.0,
               e_p=np.arange(3.0), e_r=np.ones(3), p_ref=np.arange(6.0), p=np.zeros(6),
               q=np.linspace(0, 1, 7))


# the JSON transport flattens these to scalars (their typed fields are a
# Vector and a float32[]): they are held to the schema by name only
FLAT = ("phi", "dphi", "fails")


def test_mpc_data_dict_equals_jax_and_validates():
    got = trc.mpc_data_dict(record(TRecord))
    assert got == jrc.mpc_data_dict(record(JRecord))
    schema = tidl.load_msg("MPCData")
    assert set(got) <= set(schema)
    tidl.validate(schema, {k: v for k, v in got.items() if k not in FLAT})
    # a record whose arrays are tensors gives the same payload
    rec = record(TRecord)
    rec = dataclasses.replace(rec, q=torch.as_tensor(rec.q), e_p=torch.as_tensor(rec.e_p))
    assert trc.mpc_data_dict(rec) == got


def typed_fields(msg):
    vec = jtest_idl._FakeVector
    return {k: (v.x if isinstance(v, vec) else
                [list(e.x) for e in v] if isinstance(v, list) and v and isinstance(v[0], vec)
                else v) for k, v in msg._set.items()}


def test_typed_mpc_data_equals_jax_and_matches_schema():
    msgs = {"MPCData": jtest_idl._FakeMPCData, "Vector": jtest_idl._FakeVector}
    got = typed_fields(trc.to_mpc_data_msg(msgs, record(TRecord)))
    assert got == typed_fields(jrc.to_mpc_data_msg(msgs, record(JRecord)))
    tidl.validate(tidl.load_msg("MPCData"), got)


def publish_all(mod, pub, rec):
    a, b = box([0, 0, 0], 0.5)
    out = [pub.publish_sets([(a, b), (a, b + 0.1)]),
           pub.publish_via_points([[0, 0, 0.5], [0.2, 0, 0.6]], None),
           pub.publish_path(0.0, [[0, 0, 0]], [[0.1, 0.2, 0.3]]),
           pub.publish_joint_state(np.arange(7.0)),
           pub.publish_collision_spheres(np.zeros((3, 3)), [0.1, 0.1, 0.2]),
           pub.publish_tick(rec)]
    pub.shutdown()
    return out


def test_publisher_without_ros_returns_jax_payloads():
    got = publish_all(trc, trc.RosPublisher(), record(TRecord))
    ref = publish_all(jrc, jrc.RosPublisher(), record(JRecord))
    assert got == ref


def plain(o):
    """A fake ROS message as nested dicts of the fields that were set."""
    if isinstance(o, jtest_ros._Obj):
        return {k: plain(v) for k, v in vars(o).items()}
    if isinstance(o, jtest_idl._FakeMPCData):
        return typed_fields(o)
    if isinstance(o, list):
        return [plain(v) for v in o]
    return o


def test_publisher_with_fake_rclpy_publishes_as_jax(monkeypatch):
    """Both publishers over the fake ROS stack of tests/test_ros_compat.py
    (and the fake ``boundmpcmsg`` of tests/test_idl.py): the same topics,
    the same messages on each."""
    import sys
    import types

    fake_msg = types.ModuleType("boundmpcmsg.msg")
    fake_msg.MPCData = jtest_idl._FakeMPCData
    fake_msg.Vector = jtest_idl._FakeVector
    fake_pkg = types.ModuleType("boundmpcmsg")
    fake_pkg.msg = fake_msg
    monkeypatch.setitem(sys.modules, "boundmpcmsg", fake_pkg)
    monkeypatch.setitem(sys.modules, "boundmpcmsg.msg", fake_msg)
    seen = {}
    for name, mod, rec in (("port", trc, record(TRecord)), ("jax", jrc, record(JRecord))):
        node = jtest_ros._install_fake_ros(monkeypatch)
        pub = mod.RosPublisher()
        assert pub.active and pub.typed is not None
        publish_all(mod, pub, rec)
        assert not pub.active
        seen[name] = {p.topic: [plain(m) for m in p.published] for p in node.pubs}
    assert set(seen["port"]) == {t for t, _ in trc.RosPublisher.TOPICS.values()} | {
        "/bound_mpc/mpc_data_typed"}
    assert all(seen["port"].values())
    assert seen["port"] == seen["jax"]
    sets = seen["port"]["/bound_planner/set_marker_array"][0]["markers"]
    assert sets[0]["action"] == 3 and sets[1]["type"] == 11 and len(sets[1]["points"]) >= 36


# --- MpcHostServices over the port's MPCNode ----------------------------------

Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
SMALL = dict(sqp_iters=2, qp_iters=6, line_search_steps=2)
ERB = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180


def straight(node):
    p0 = node.p0.copy()
    r0 = R.from_rotvec(np.array(p0[3:])).as_matrix()
    return ([p0[:3].copy(), p0[:3] + np.array([0.0, -0.25, 0.0])], [r0, r0],
            [np.array([0.0, 0.0, 1.0])], [np.array([0.0, 0.0, 1.0])], [ERB],
            [np.zeros((15, 3))], [np.ones(15)])


@pytest.fixture(scope="module")
def serviced_nodes():
    out = {}
    for name, mod, node in (
            ("jax", jrc, JNode(Q0, MPCParams(**SMALL))),
            ("port", trc, MPCNode(Q0, tconfig.MPCParams(**SMALL), device="cpu",
                                  dtype=torch.float64))):
        svc = mod.MpcHostServices(node)
        reply = svc.mpc_params(qp_iters=5)
        assert reply["success"] and reply["params"]["qp_iters"] == 5
        assert svc.trajectory(*straight(node), obstacles=[[0.7, -0.6, 0.0, 0.9, -0.5, 0.3]]) \
            == {"success": True}
        node.step()
        node.step()
        out[name] = (svc, node)
    return out


def test_host_services_tick_matches_jax(serviced_nodes):
    (_, jnode), (_, tnode) = serviced_nodes["jax"], serviced_nodes["port"]
    assert tnode.params.qp_iters == jnode.params.qp_iters == 5
    for key in ("q", "dq", "p_lie"):
        np.testing.assert_allclose(getattr(tnode, key), np.asarray(getattr(jnode, key)),
                                   rtol=0, atol=1e-7, err_msg=key)
    jt, tt = jnode.telemetry.arrays(), tnode.telemetry.arrays()
    for key in ("phi", "dphi", "e_p", "p_ref"):
        np.testing.assert_allclose(tt[key], jt[key], rtol=0, atol=1e-7, err_msg=key)


def test_host_services_refuse_unported_branch(serviced_nodes):
    """Updates onto the branches the port once refused (ADMM, the frozen KKT
    factor, escalation lanes) apply in both packages' services alike: the
    same replies, the same node parameters, an idle MPC rebuilt."""
    (jsvc, jnode), (tsvc, tnode) = serviced_nodes["jax"], serviced_nodes["port"]
    for update in (dict(qp_solver="admm"), dict(kkt_every=2), dict(esc_lanes=4)):
        jreply, treply = jsvc.mpc_params(**update), tsvc.mpc_params(**update)
        assert treply == jreply and treply["success"]
        assert dataclasses.asdict(tnode.params) == dataclasses.asdict(jnode.params)
        assert tnode.mpc.model.cfg == tnode.params
    assert (tnode.params.qp_solver, tnode.params.kkt_every, tnode.params.esc_lanes) == (
        "admm", 2, 4)
