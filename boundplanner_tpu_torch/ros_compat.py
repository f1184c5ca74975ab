"""Optional ROS 2 adapter: visualization and telemetry publishing (port of
``boundplanner_tpu/ros_compat.py``).

The reference ships RViz publishers and message schemas
(`bound_planner/RvizTools/RvizTools.py:13-101`, `RvizToolsMPC.py:13-174`,
`boundmpcmsg/msg/MPCData.msg`). ROS stays optional: the message payloads
(triangle meshes for convex sets, via-point spheres, EE paths, joint
states, MPCData telemetry) are plain dicts built by pure functions, and
``RosPublisher`` converts them to real messages only when rclpy is
importable; without it every publish is a no-op. Sets, poses and joint
states may be numpy arrays or tensors on any device:
`utils.tree.host_array` brings them to the host as float64 numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .utils.sets import polytope_vertices
from .utils.tree import host_array as _host


def _import_ros():
    """Resolve rclpy + message classes at call time (so tests can inject
    fakes into sys.modules and real deployments pick up the ROS overlay).
    Returns None when ROS 2 is not importable."""
    try:
        import rclpy  # type: ignore
        from geometry_msgs.msg import Point  # type: ignore
        from nav_msgs.msg import Path  # type: ignore
        from sensor_msgs.msg import JointState  # type: ignore
        from std_msgs.msg import String  # type: ignore
        from visualization_msgs.msg import Marker, MarkerArray  # type: ignore
    except Exception:
        return None
    return {
        "rclpy": rclpy,
        "Point": Point,
        "Path": Path,
        "JointState": JointState,
        "String": String,
        "Marker": Marker,
        "MarkerArray": MarkerArray,
    }


HAVE_ROS = _import_ros() is not None


# ---------------------------------------------------------------------------
# pure message-payload builders (dict-shaped visualization_msgs/Marker etc.)
# ---------------------------------------------------------------------------

def set_marker(a_set, b_set, ns: str = "Set", marker_id: int = 0,
               color=(0.0, 1.0, 0.0), alpha: float = 0.1,
               frame_id: str = "world") -> Optional[Dict]:
    """TRIANGLE_LIST marker for one convex set — the mesh construction of
    the reference `RvizTools.create_marker_msg:71-96` (hull facets
    triangulated from the H-rep vertices; cddlib replaced by the
    triple-plane enumeration in `utils.sets.polytope_vertices`)."""
    from scipy.spatial import ConvexHull

    a = _host(a_set)
    b = _host(b_set)
    keep = (b < 9.0) & (np.linalg.norm(a, axis=1) > 1e-8)
    pts = polytope_vertices(a[keep], b[keep])
    if pts.shape[0] < 4:
        return None
    hull = ConvexHull(pts)
    tri_points: List[List[float]] = []
    for face in hull.simplices:
        for idx in face:
            tri_points.append([float(c) for c in pts[idx]])
    return {
        "header": {"frame_id": frame_id},
        "ns": ns,
        "id": int(marker_id),
        "type": "TRIANGLE_LIST",
        "action": "ADD",
        "points": tri_points,
        "scale": {"x": 1.0, "y": 1.0, "z": 1.0},
        "color": {"r": float(color[0]), "g": float(color[1]),
                  "b": float(color[2]), "a": float(alpha)},
    }


def delete_all_marker(frame_id: str = "world") -> Dict:
    """DELETEALL marker (ref `RvizTools.delete_sets:56-62`)."""
    return {"header": {"frame_id": frame_id}, "action": "DELETEALL"}


def via_point_markers(p_via, diameter: float = 0.03,
                      color=(1.0, 0.5, 0.0), frame_id: str = "world") -> List[Dict]:
    """SPHERE marker per via point (ref `RvizTools.publish_via_points:37-51`)."""
    out = []
    for i, p in enumerate(_host(p_via)):
        out.append(
            {
                "header": {"frame_id": frame_id},
                "ns": "via",
                "id": i,
                "type": "SPHERE",
                "action": "ADD",
                "pose": {"position": [float(c) for c in p[:3]]},
                "scale": {"x": diameter, "y": diameter, "z": diameter},
                "color": {"r": float(color[0]), "g": float(color[1]),
                          "b": float(color[2]), "a": 1.0},
            }
        )
    return out


def collision_sphere_markers(centers, radii, color=(0.2, 0.2, 1.0),
                             alpha: float = 0.4,
                             frame_id: str = "world") -> List[Dict]:
    """SPHERE markers for the robot collision spheres (ref
    `RvizToolsMPC.py` collision visualization; radii from
    `RobotModel.py:37` col_joint_sizes)."""
    out = []
    for i, (c, r) in enumerate(zip(_host(centers), _host(radii))):
        d = 2.0 * float(r)
        out.append(
            {
                "header": {"frame_id": frame_id},
                "ns": "collision",
                "id": i,
                "type": "SPHERE",
                "action": "ADD",
                "pose": {"position": [float(x) for x in c[:3]]},
                "scale": {"x": d, "y": d, "z": d},
                "color": {"r": float(color[0]), "g": float(color[1]),
                          "b": float(color[2]), "a": float(alpha)},
            }
        )
    return out


def path_msg(points, frame_id: str = "world") -> Dict:
    """nav_msgs/Path-shaped dict: planned or reference EE path (ref
    `RvizToolsMPC.py` path publishers)."""
    return {
        "header": {"frame_id": frame_id},
        "poses": [
            {"position": [float(c) for c in _host(p)[:3]]}
            for p in points
        ],
    }


def joint_state_msg(q, names: Optional[Sequence[str]] = None) -> Dict:
    """sensor_msgs/JointState-shaped dict (ref `RvizToolsMPC.py` kinematic
    robot mover)."""
    q = _host(q).reshape(-1)
    if names is None:
        names = [f"joint_a{i + 1}" for i in range(q.shape[0])]
    return {"name": list(names), "position": [float(v) for v in q]}


def _import_boundmpcmsg():
    """Resolve the colcon-built interface package (classes generated from
    the schemas shipped in `boundplanner_tpu_torch/idl/`) at call time; tests
    inject fakes into sys.modules. None when not installed."""
    try:
        from boundmpcmsg.msg import MPCData, Vector  # type: ignore
    except Exception:
        return None
    return {"MPCData": MPCData, "Vector": Vector}


def to_mpc_data_msg(msgs: Dict, record):
    """Typed `boundmpcmsg/msg/MPCData` from a `telemetry.MPCTickRecord` —
    the schema-exact transport (fields per `idl/msg/MPCData.msg`; the
    JSON-String path of `mpc_data_dict` remains the ROS-less fallback).

    Only the fields the record carries are set; the rest keep their IDL
    defaults. `tests/test_ros_compat.py` pins that every field set here
    exists in the shipped schema with a compatible kind."""
    vec = lambda v: msgs["Vector"](x=[float(c) for c in _host(v).reshape(-1)])
    m = msgs["MPCData"]()
    get = lambda f, d=None: getattr(record, f, d)
    m.t_comp = float(get("t_comp", 0.0))
    m.t_loop = float(get("t_loop", 0.0))
    m.t_overhead = float(get("t_overhead", 0.0))
    m.phi_max = float(get("phi_max", 0.0))
    m.cost = float(get("cost", 0.0))
    m.iterations = int(get("iterations", get("sqp_iters", 0)) or 0)
    m.sector = int(get("sector", 0))
    m.fails = [0.0 if bool(get("success", True)) else 1.0]
    m.phi = vec([get("phi", 0.0)])
    m.dphi = vec([get("dphi", 0.0)])
    for f in ("q", "dq", "p", "v", "e_p", "e_r", "p_ref"):
        v = get(f)
        if v is not None:
            setattr(m, f, [vec(v)])
    return m


def mpc_data_dict(record) -> Dict:
    """MPCData.msg-shaped telemetry dict from a `telemetry.MPCTickRecord`
    (field parity with `boundmpcmsg/msg/MPCData.msg`)."""
    get = lambda f, d=None: getattr(record, f, d)
    out = {
        "t_comp": float(get("t_comp", 0.0)),
        "phi": float(get("phi", 0.0)),
        "dphi": float(get("dphi", 0.0)),
        "cost": float(get("cost", 0.0)),
        "iterations": int(get("sqp_iters", 0)),
        "sector": int(get("sector", 0)),
        "fails": int(get("fails", 0)),
    }
    for f in ("q", "dq", "p", "v", "e_p", "e_r", "p_ref"):
        v = get(f)
        if v is not None:
            out[f] = _host(v).tolist()
    return out


# ---------------------------------------------------------------------------
# payload dict -> real ROS 2 message conversion
# ---------------------------------------------------------------------------

_MARKER_TYPES = {"TRIANGLE_LIST": 11, "SPHERE": 2}
_MARKER_ACTIONS = {"ADD": 0, "DELETEALL": 3}


def to_marker_msg(ros, d: Dict):
    """visualization_msgs/Marker from a `set_marker`/`via_point_markers`
    payload dict (the real-message half of the reference's
    `RvizTools.create_marker_msg:71-96`)."""
    m = ros["Marker"]()
    m.header.frame_id = d.get("header", {}).get("frame_id", "world")
    m.ns = d.get("ns", "")
    m.id = int(d.get("id", 0))
    m.action = _MARKER_ACTIONS[d.get("action", "ADD")]
    if d.get("action", "ADD") == "DELETEALL":
        return m
    m.type = _MARKER_TYPES[d["type"]]
    for axis in ("x", "y", "z"):
        setattr(m.scale, axis, float(d["scale"][axis]))
    for ch in ("r", "g", "b", "a"):
        setattr(m.color, ch, float(d["color"][ch]))
    pos = d.get("pose", {}).get("position")
    if pos is not None:
        m.pose.position.x, m.pose.position.y, m.pose.position.z = map(float, pos)
    m.pose.orientation.w = 1.0
    for p in d.get("points", ()):
        pt = ros["Point"]()
        pt.x, pt.y, pt.z = map(float, p)
        m.points.append(pt)
    return m


def to_marker_array_msg(ros, dicts: Sequence[Dict]):
    arr = ros["MarkerArray"]()
    for d in dicts:
        arr.markers.append(to_marker_msg(ros, d))
    return arr


def to_path_msg(ros, d: Dict):
    """nav_msgs/Path from a `path_msg` payload dict."""
    from geometry_msgs.msg import PoseStamped  # type: ignore

    p = ros["Path"]()
    p.header.frame_id = d.get("header", {}).get("frame_id", "world")
    for pose in d.get("poses", ()):
        ps = PoseStamped()
        ps.header.frame_id = p.header.frame_id
        pos = pose["position"]
        ps.pose.position.x, ps.pose.position.y, ps.pose.position.z = map(
            float, pos
        )
        ps.pose.orientation.w = 1.0
        p.poses.append(ps)
    return p


def to_joint_state_msg(ros, d: Dict):
    js = ros["JointState"]()
    js.name = list(d["name"])
    js.position = [float(v) for v in d["position"]]
    return js


def to_string_msg(ros, d: Dict):
    import json

    s = ros["String"]()
    s.data = json.dumps(d)
    return s


class RosPublisher:
    """Publishes markers/paths/joint states/telemetry over real ROS 2
    topics when rclpy is importable; builds and returns the payload dicts
    either way so ROS-less callers/tests can inspect them. API mirrors the
    reference RvizTools surface (`RvizTools.py:13-101`,
    `RvizToolsMPC.py:13-174`); the MPCData telemetry goes out as a JSON
    std_msgs/String (deviation: the `boundmpcmsg/msg/MPCData` IDL package
    is a colcon artifact we do not ship; field names match the .msg)."""

    TOPICS = {
        "sets": ("/bound_planner/set_marker_array", "MarkerArray"),
        "via": ("/bound_planner/via_marker_array", "MarkerArray"),
        "collision": ("/bound_mpc/collision_marker_array", "MarkerArray"),
        "planned": ("/bound_mpc/planned_traj", "Path"),
        "reference": ("/bound_mpc/ref_traj", "Path"),
        "joints": ("/joint_states", "JointState"),
        "mpc_data": ("/bound_mpc/mpc_data", "String"),
    }

    def __init__(self, node_name: str = "boundplanner_tpu_torch"):
        self.active = False
        self.ros = _import_ros()
        self.typed = _import_boundmpcmsg()
        self.pubs = {}
        if self.ros is not None:
            rclpy = self.ros["rclpy"]
            if not rclpy.ok():
                rclpy.init()
            self.node = rclpy.create_node(node_name)
            for key, (topic, type_name) in self.TOPICS.items():
                self.pubs[key] = self.node.create_publisher(
                    self.ros[type_name], topic, 10
                )
            if self.typed is not None:
                # the colcon-built interface package is installed: publish
                # schema-exact MPCData alongside the JSON-String transport
                self.pubs["mpc_data_typed"] = self.node.create_publisher(
                    self.typed["MPCData"], "/bound_mpc/mpc_data_typed", 10
                )
            self.active = True

    def _publish(self, key: str, msg):
        if self.active:
            self.pubs[key].publish(msg)

    def publish_via_points(self, p_via, r_via):
        markers = via_point_markers(p_via)
        if self.active:
            self._publish("via", to_marker_array_msg(self.ros, markers))
        self._log(f"via points: {len(markers)}")
        return markers

    def publish_sets(self, sets, color=(0.0, 1.0, 0.0), alpha: float = 0.1):
        markers = [delete_all_marker()]
        for i, (a, b) in enumerate(sets):
            m = set_marker(a, b, marker_id=i, color=color, alpha=alpha)
            if m is not None:
                markers.append(m)
        if self.active:
            self._publish("sets", to_marker_array_msg(self.ros, markers))
        self._log(f"{len(markers) - 1} convex sets")
        return markers

    def publish_path(self, t, traj, ref):
        msgs = {"planned": path_msg(traj), "reference": path_msg(ref)}
        if self.active:
            self._publish("planned", to_path_msg(self.ros, msgs["planned"]))
            self._publish("reference", to_path_msg(self.ros, msgs["reference"]))
        self._log(f"paths at t={float(t):.2f}")
        return msgs

    def publish_collision_spheres(self, centers, radii):
        markers = collision_sphere_markers(centers, radii)
        if self.active:
            self._publish("collision", to_marker_array_msg(self.ros, markers))
        return markers

    def publish_joint_state(self, q):
        msg = joint_state_msg(q)
        if self.active:
            self._publish("joints", to_joint_state_msg(self.ros, msg))
        return msg

    def publish_tick(self, record):
        """MPCData-equivalent telemetry (`boundmpcmsg/msg/MPCData.msg`):
        JSON String always; the typed MPCData additionally when the
        generated interface package is importable."""
        msg = mpc_data_dict(record)
        if self.active:
            self._publish("mpc_data", to_string_msg(self.ros, msg))
            if self.typed is not None:
                self._publish(
                    "mpc_data_typed", to_mpc_data_msg(self.typed, record)
                )
        self._log(f"phi={msg['phi']:.3f} t_comp={msg['t_comp'] * 1e3:.0f}ms")
        return msg

    def _log(self, text: str):
        if self.active:
            self.node.get_logger().info(text)

    def shutdown(self):
        if self.active:
            self.node.destroy_node()
            self.ros["rclpy"].shutdown()
            self.active = False


class MpcHostServices:
    """Host-side equivalents of the reference's service surface
    (`boundmpcmsg/srv/Trajectory.srv`, `srv/MPCParams.srv`): the same
    request semantics exposed as plain methods on the running MPC node, so
    non-ROS deployments (and tests) drive them directly. When the
    `boundmpcmsg` IDL package is importable, `register` additionally wires
    them up as real ROS 2 services on the publisher's node."""

    def __init__(self, mpc_node):
        self.mpc_node = mpc_node

    # Trajectory.srv: new via-point plan hand-off -> MPC update
    # (srv fields p_via/r_via/bp1/br1/e_r_*/a_set/b_set/obstacles,
    #  `boundmpcmsg/srv/Trajectory.srv`)
    def trajectory(self, p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets,
                   obstacles=()):
        self.mpc_node.update_reference(
            p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets, list(obstacles)
        )
        return {"success": True}

    # MPCParams.srv: runtime-tunable solver/horizon knobs
    # (srv fields n/nr_segs/dt/weights, `boundmpcmsg/srv/MPCParams.srv`;
    #  the build/simulate/use_acados flags have no analog here)
    def mpc_params(self, **updates):
        import dataclasses

        params = dataclasses.replace(self.mpc_node.params, **updates)
        self.mpc_node.reconfigure(params)
        return {"success": True, "params": dataclasses.asdict(params)}

    def register(self, publisher: RosPublisher):  # pragma: no cover - needs IDL pkg
        try:
            from boundmpcmsg.srv import MPCParams, Trajectory  # type: ignore
        except Exception:
            return False

        def _traj_cb(req, resp):
            vecs = lambda vs: [_host(v.data) for v in vs]
            out = self.trajectory(
                vecs(req.p_via), vecs(req.r_via), vecs(req.bp1), vecs(req.br1),
                vecs(req.e_r_start), vecs(req.a_set), vecs(req.b_set),
                vecs(req.obstacles),
            )
            resp.success = out["success"]
            return resp

        def _params_cb(req, resp):
            out = self.mpc_params(
                n=int(req.n), dt=float(req.dt), nr_segs=int(req.nr_segs),
                weights=tuple(float(w) for w in req.weights),
            )
            resp.success = out["success"]
            return resp

        publisher.node.create_service(Trajectory, "bound_mpc/trajectory", _traj_cb)
        publisher.node.create_service(MPCParams, "bound_mpc/mpc_params", _params_cb)
        return True
