"""The single-arm cell's plain reference and the comparison that decides
``correct``.

A control period of the port's ``MPCNode.step`` is: forward kinematics of
the joint state, one tick at batch 1 (``BoundMPC.step``), the integration
of the first jerk, forward kinematics again. ``RefArm.period`` computes
the same with the frozen tick from the state the period started from: the
node's joint state and the tick's carry, both the program's own (the
reference follows the program period by period). ``RefArm.handoff``
builds the carry of a new leg from the frozen plan, as
``BoundMPC.update`` does, so that the start of each leg is checked by
itself: everything but the warm-start fields, which are the previous
leg's.
"""

from __future__ import annotations

import numpy as np
import torch

from .bmpc.config import MPCParams
from .bmpc.mpc import ocp_struct, prep
from .bmpc.mpc.tick import init_carry, mpc_tick
from .bmpc.path.reference_path import build_path
from .bmpc.planner.obstacles import build_obstacle_arrays
from .bmpc.robot import kinematics as kin
from .bmpc.utils import so3
from .bmpc.utils.integration import integrate_jerk_step
from .bmpc.utils.tree import to_torch, tree_map

WARM_FIELDS = ("x_prev", "has_prev", "prev_q", "prev_dq", "prev_ddq", "prev_u", "prev_p",
               "prev_v", "prev_pslacks")


def plan_args(plan: dict) -> tuple:
    """A frozen plan as the arrays ``MPCNode.update_reference`` takes."""
    arr = lambda xs: [np.asarray(x, dtype=np.float64) for x in xs]
    return (arr(plan["p_via"]), arr(plan["r_via"]), arr(plan["bp1"]), arr(plan["br1"]),
            arr(plan["e_r_bound"]), arr(plan["a_sets"]), arr(plan["b_sets"]),
            [list(map(float, o)) for o in plan["obstacles"]])


class RefArm:
    """The frozen tick for ``cfg`` at batch 1 on ``device`` in ``dtype``."""

    def __init__(self, cfg: MPCParams, device, dtype, link_route: str):
        self.cfg, self.device, self.dtype = cfg, torch.device(device), dtype
        self.st = ocp_struct.build(cfg.n, cfg.dt, cfg.robot, cfg.struct_ocp and cfg.struct_chunked,
                                   cfg.weights, cfg.nr_segs).to(device=self.device, dtype=dtype)
        self.st.link_route = link_route

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device,
                               dtype=self.dtype)

    def obstacles(self, plan: dict):
        return to_torch(build_obstacle_arrays(plan["obstacles"], size_increase=0.0),
                        self.device, self.dtype)

    def fk(self, q, dq):
        """(pose, J) of the end effector at the joint state (q, dq)."""
        qt = self._t(q)
        return kin.fk_pose(qt, self.st.chain), kin.jacobian_fk(qt, self.st.chain)

    @torch.no_grad()
    def handoff(self, plan: dict, p0, v, prev_carry):
        """The carry ``BoundMPC.update`` builds for ``plan`` with the arm at
        pose ``p0`` moving at twist ``v``, the warm fields taken from
        ``prev_carry``."""
        args = plan_args(plan)
        p_via, r_via = args[0], args[1]
        path = build_path(*args[:7], nr_segs=self.cfg.nr_segs)
        carry = to_torch(init_carry(path, p0, self.cfg), self.device, self.dtype)
        carry = carry._replace(**{f: getattr(prev_carry, f) for f in WARM_FIELDS})
        p_via0 = p_via[0]
        dp0 = p_via[1] - p_via0
        dp0 = dp0 / np.linalg.norm(dp0)
        phi0 = float((np.asarray(p0[:3]) - p_via0) @ dp0)
        dphi0 = float(np.asarray(v[:3]) @ dp0)
        f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)
        pr_ref = prep.integrate_rotation_reference(
            so3.matrix_to_rotvec(f64(r_via[0])), f64(path.dr[0]), f64(0.0), f64(phi0))
        iw_ref = path.iw[0] + phi0 * path.dr[0]
        return carry._replace(phi_current=self._t(phi0), dphi_current=self._t(dphi0),
                              pr_ref=pr_ref.to(self.dtype), iw_ref=self._t(iw_ref))

    @torch.no_grad()
    def period(self, state: dict, carry, obs) -> dict:
        """One control period from the node's ``state`` (q, dq, ddq, jerk,
        qf: numpy) and the tick's ``carry``: the new joint state, the
        measured pose after it and the fail flag."""
        pose, jac = self.fk(state["q"], state["dq"])
        dq_t = self._t(state["dq"])
        meas = {"q0": self._t(state["q"]), "dq0": dq_t, "ddq0": self._t(state["ddq"]),
                "p0": pose, "v0": jac @ dq_t, "u0": self._t(state["jerk"]),
                "qf": self._t(state["qf"])}
        one = lambda t: t[None]
        carry_n, out = mpc_tick(tree_map(one, carry), tree_map(one, meas), tree_map(one, obs),
                                self.cfg, self.st)
        u = out["dddq"][0]
        q, dq, ddq = integrate_jerk_step(meas["q0"], dq_t, meas["ddq0"], u[0], u[1], self.cfg.dt)
        pose_n = kin.fk_pose(q, self.st.chain)
        to_np = lambda t: t.detach().cpu().numpy().astype(np.float64)
        return {"q": to_np(q), "dq": to_np(dq), "ddq": to_np(ddq), "p": to_np(pose_n),
                "fail": bool(int(carry_n.error_count[0]) > 0),
                "viol": float(out["viol"][0]), "success": bool(out["success"][0])}


def carry_gap(a, b) -> float:
    """The widest gap between two carries' floating leaves, leaf by leaf
    (integer and flag leaves: a mismatch reads as infinite)."""
    gap = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if x.is_floating_point():
            d = (x.to(torch.float64) - y.to(torch.float64)).abs()
            both_inf = torch.isinf(x) & torch.isinf(y) & (torch.sign(x) == torch.sign(y))
            d = torch.where(both_inf, 0.0, d)
            gap = max(gap, float(d.max()) if d.numel() else 0.0)
        elif not torch.equal(x, y):
            return float("inf")
    return gap


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]
