"""The fleet cells' plain reference and the comparison that decides
``correct``.

``load_scenes`` reads the cached fleet with an unpickler of its own (the
file's classes mapped onto the frozen copy's, nothing imported by the
file's module names). ``RefFleet`` runs the frozen tick (``bmpc``) as a
closed loop, as the port's ``parallel/batch.py::fleet_rollout`` does:
measure the plant, tick, apply the first jerk, integrate. It takes only
the cached data, never the program's state.

``compare`` holds the program's rollout to the reference's:

- the start: tick 0 of every scene, where both sides start from the same
  cached data, so the gaps are one tick's rounding;
- the plant's measurement of every tick: the pose the program measured,
  against the reference's forward kinematics of the program's own joint
  state of the tick before (the reference follows the program step by step
  here);
- the whole rollout: every tick of every scene against the reference's
  own rollout from the same start. In float64 that gap stays at rounding;
  in float32 the solver's fixed budget lets rounding grow from tick to
  tick, so that number is read as a quantile over scenes;
- the outcome: the violation of every tick, and the success flags wherever
  the reference's violation lies clear of the bar.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from .bmpc.config import MPCParams
from .bmpc.mpc import ocp_struct
from .bmpc.mpc.tick import MPCCarry, mpc_tick
from .bmpc.path.reference_path import PathState
from .bmpc.planner.obstacles import ObstacleArrays
from .bmpc.robot import kinematics as kin
from .bmpc.utils.integration import integrate_jerk_step
from .bmpc.utils.tree import to_torch, tree_map

SUCCESS_BAR = 1e-4      # a tick succeeds when its violation is under this bar

_CLASSES = {"MPCCarry": MPCCarry, "PathState": PathState, "ObstacleArrays": ObstacleArrays}
_MODULES = {"MPCCarry": "mpc.bound_mpc", "PathState": "path.reference_path",
            "ObstacleArrays": "planner.set_finder"}


class _Unpickler(pickle.Unpickler):
    """Maps the fleet file's three NamedTuples (written under either
    package's module path) onto the frozen copy's; numpy's own classes
    load as usual; anything else is refused."""

    def find_class(self, module, name):
        if name in _CLASSES and module.split(".", 1)[-1] == _MODULES[name]:
            return _CLASSES[name]
        if module.split(".")[0] == "numpy" or module in ("builtins", "collections"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"unexpected class {module}.{name} in the fleet file")


def load_scenes(path: str, index, device, dtype):
    """(carry, q0, obs) of the scenes ``index`` of the cached fleet, as
    tensors on ``device`` (floating leaves in ``dtype``)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("schema") != "fleet_cache_v1":
        raise ValueError(f"unexpected fleet file schema in {path}")
    idx = np.asarray(index)
    take = lambda a: np.asarray(a)[idx]
    tree = tree_map(take, (payload["carry"], payload["q0"], payload["obs"]))
    return to_torch(tree, device, dtype)


class RefFleet:
    """The frozen tick's static structure for ``cfg`` on ``device`` in
    ``dtype``, with the link sets' closest-point route by name."""

    def __init__(self, cfg: MPCParams, device, dtype, link_route: str):
        self.cfg = cfg
        self.st = ocp_struct.build(cfg.n, cfg.dt, cfg.robot, cfg.struct_ocp and cfg.struct_chunked,
                                   cfg.weights, cfg.nr_segs).to(device=device, dtype=dtype)
        self.st.link_route = link_route

    def measure(self, q, dq, ddq, jerk, qf):
        pose = kin.fk_pose(q, self.st.chain)
        jac = kin.jacobian_fk(q, self.st.chain)
        return {"q0": q, "dq0": dq, "ddq0": ddq, "p0": pose,
                "v0": (jac @ dq[..., None])[..., 0], "u0": jerk, "qf": qf}

    def pose(self, q):
        return kin.fk_pose(q, self.st.chain)

    @torch.no_grad()
    def rollout(self, carry, q0, obs, n_ticks: int):
        """(final carry, records (B, n_ticks, ...): phi, q, p, success,
        viol), from rest at ``q0``, without the escalation retry."""
        cfg = self.cfg
        q, dq, ddq = q0, torch.zeros_like(q0), torch.zeros_like(q0)
        jerk, qf = torch.zeros_like(q0), q0
        recs = []
        for _ in range(n_ticks):
            meas = self.measure(q, dq, ddq, jerk, qf)
            carry, out = mpc_tick(carry, meas, obs, cfg, self.st)
            u0, u1 = out["dddq"][:, 0], out["dddq"][:, 1]
            q, dq, ddq = integrate_jerk_step(q, dq, ddq, u0, u1, cfg.dt)
            jerk, qf = u1, out["q"][:, -1]
            recs.append({"phi": out["phi"][:, 1], "q": q, "p": meas["p0"],
                         "success": out["success"], "viol": out["viol"]})
        return carry, {k: torch.stack([r[k] for r in recs], dim=1) for k in recs[0]}


def _f64(t):
    return t.detach().to("cpu", torch.float64)


def compare(prog: dict, ref: dict, q0, meas_pose, wrong_at: dict) -> tuple[dict, np.ndarray]:
    """The numbers that ``correct`` compares, and the (B, T) mask of the
    solves judged wrong.

    ``prog`` and ``ref`` are the two rollouts' records (B, T, ...);
    ``q0`` (B, 7) the common start; ``meas_pose(q)`` the reference's
    forward kinematics; ``wrong_at`` the per-solve limits: ``meas_pose`` (a
    measured-pose gap) and, where the cell holds them solve by solve,
    ``start_q`` (a tick-0 joint gap) and ``track_q`` (a joint gap to the
    reference's own rollout)."""
    pq, rq = _f64(prog["q"]), _f64(ref["q"])
    bsz, ticks = pq.shape[:2]
    finite = (torch.isfinite(pq).all(-1) & torch.isfinite(_f64(prog["phi"]))
              & torch.isfinite(_f64(prog["viol"])) & torch.isfinite(_f64(prog["p"])).all(-1))
    q_gap = torch.where(finite[..., None], (pq - rq).abs(), torch.inf).amax(-1)      # (B, T)
    phi_gap = (_f64(prog["phi"]) - _f64(ref["phi"])).abs()
    viol_gap = (_f64(prog["viol"]) - _f64(ref["viol"])).abs()
    # the plant's measurement of tick t is the pose at the joint state of
    # tick t - 1 (the start for tick 0), the program's own
    q_before = torch.cat([_f64(q0)[:, None], pq[:, :-1]], dim=1)
    pose_ref = _f64(meas_pose(q_before.reshape(-1, q_before.shape[-1]))).reshape(bsz, ticks, -1)
    meas_gap = (_f64(prog["p"]) - pose_ref).abs().amax(-1)
    meas_gap = torch.where(finite, meas_gap, torch.inf)
    rv = _f64(ref["viol"])
    clear = (rv < SUCCESS_BAR / 10) | (rv > SUCCESS_BAR * 10)
    flag_diff = (prog["success"].cpu() != ref["success"].cpu()) & clear
    track = q_gap.amax(1)                                  # per scene, over all ticks
    numbers = {
        "start_q_gap_max": float(q_gap[:, 0].max()),
        "start_q_gap_med": float(torch.quantile(q_gap[:, 0], 0.5)),
        "start_phi_gap_max": float(phi_gap[:, 0].max()),
        "start_viol_gap_max": float(viol_gap[:, 0].max()),
        "meas_pose_gap_max": float(meas_gap.max()),
        "track_q_gap_med": float(torch.quantile(track, 0.5)),
        "track_q_gap_p75": float(torch.quantile(track, 0.75)),
        "track_q_gap_max": float(track.max()),
        "track_phi_gap_max": float(phi_gap.max()),
        "track_viol_gap_max": float(viol_gap.max()),
        "flag_mismatch": float(flag_diff.sum()),
        "nonfinite": float((~finite).sum()),
    }
    wrong = ~finite | (meas_gap > wrong_at["meas_pose"])
    if "start_q" in wrong_at:
        wrong[:, 0] |= q_gap[:, 0] > wrong_at["start_q"]
    if "track_q" in wrong_at:
        wrong |= q_gap > wrong_at["track_q"]
    return numbers, wrong.numpy()
