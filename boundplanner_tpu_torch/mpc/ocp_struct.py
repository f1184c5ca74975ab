"""Block-banded structure of the condensed OCP, flat mode
(port of ``boundplanner_tpu/mpc/ocp_struct.py`` with
``struct_chunked=False``, the adopted configuration).

850 of the 2439 constraint rows (variable bounds and slack nonnegativity)
have constant Jacobians. The QP applies them structurally: per-joint
impulse-response products instead of dense rows, and their Gram as
per-joint 14x14 blocks + a diagonal + a 38x38 slack block.

``OCPStruct`` is an ``nn.Module`` holding every static tensor of the tick
as a buffer (structure matrices, sensitivities, limits, and the robot
chain as a submodule), so ``.to(device, dtype)`` moves them all. Its
products take arbitrary leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import MPC_SET_ROWS, NUM_LINK_SETS
from ..ops.qp import dense_gram
from ..robot.kinematics import Chain
from ..robot.model import DDQ_LIM, U_MAX, U_MIN, ocp_limits
from . import ocp
from .ocp_jac import _static_bound_rows, _static_sensitivities

NJ = ocp.NJ


class Layout(NamedTuple):
    """The integer row and column counts of the condensed OCP for horizon
    n, flat and chunked (the chunked mode's split point ``half`` and its
    chunk-A column support ``n_cols_a``, counted without building it)."""

    nx: int
    o: int
    per_step_g: int
    n_term_g: int
    per_step_r: int
    n_term_r: int
    m_run: int
    m_r: int
    m_tail: int
    n_slack: int
    n_b_slack: int
    half: int
    n_cols_a: int


def layout(n: int) -> Layout:
    """The counts of the JAX package's ``OCPStruct(n, dt)``, which do not
    depend on dt."""
    nx = ocp.n_vars(n)
    o = NJ * (n - 1)
    per_step_g = MPC_SET_ROWS + 6 + NUM_LINK_SETS * MPC_SET_ROWS + 1
    n_term_g = MPC_SET_ROWS + 6
    per_step_r = 15 + 3 + 7 + 2 + 9 + 4   # see ocp._step_local
    n_term_r = 5 + 6 + 6
    n_b_slack = 6 + 4 * n                 # ddsl, drs_traj, ddrs, dps_traj, ddps
    half = (n - 1) // 2
    # chunk A's columns: u_1..u_half, dslacks + rs0, drs_0..half, ps0, dps_0..half
    n_cols_a = NJ * half + 7 + (half + 1) + 1 + (half + 1)
    return Layout(
        nx=nx, o=o, per_step_g=per_step_g, n_term_g=n_term_g, per_step_r=per_step_r,
        n_term_r=n_term_r, m_run=(n - 1) * per_step_g + n_term_g,
        m_r=(n - 1) * per_step_r + n_term_r, m_tail=8 * NJ * (n - 1) + n_b_slack,
        n_slack=nx - o, n_b_slack=n_b_slack, half=half, n_cols_a=n_cols_a)


class OCPStruct(nn.Module):
    """Static structure of the condensed OCP for horizon n, period dt and
    robot (float64 buffers until ``.to()``)."""

    def __init__(self, n: int, dt: float, robot: str = "iiwa14"):
        super().__init__()
        self.n = n
        self.dt = dt
        self.robot = robot
        lay = layout(n)
        o = self.o = lay.o
        self.nx = lay.nx
        self.per_step_g, self.n_term_g = lay.per_step_g, lay.n_term_g
        self.per_step_r, self.n_term_r = lay.per_step_r, lay.n_term_r
        self.m_run, self.m_r = lay.m_run, lay.m_r
        self.m_tail, self.n_slack = lay.m_tail, lay.n_slack

        s = _static_sensitivities(n, dt)
        b_slack = np.concatenate(
            [-s["ddsl"], -s["drs_traj"], -s["ddrs"], -s["dps_traj"], -s["ddps"]]
        )[:, o:]
        assert b_slack.shape == (lay.n_b_slack, lay.n_slack), b_slack.shape

        # float64 (exact) until ``.to(dtype)``: rounding here would stick
        buf = lambda name, a: self.register_buffer(name, torch.as_tensor(a, dtype=torch.float64))
        buf("c_q", s["cq"][1:, 1:])        # jerk-chain profiles, free inputs only
        buf("c_dq", s["cdq"][1:, 1:])
        buf("c_ddq", s["cddq"][1:, 1:])
        buf("b_slack", b_slack)            # (6 + 4n, 38)
        for key, val in s.items():         # static sensitivities of ocp_jac
            buf("sens_" + key, val)
        # the tail's rows as a dense block, for the dense chain rule
        buf("tail_rows", _static_bound_rows(n, dt))   # (m_tail, nx)
        q_ub, q_lb, dq_lim, col_sizes = ocp_limits(robot)
        buf("q_ub", q_ub)
        buf("q_lb", q_lb)
        buf("dq_lim", dq_lim)
        buf("col_sizes", col_sizes)
        self.chain = Chain(robot)

    # ---- static tail: g_tail(x) = [bound rows; slack rows] --------------

    def tail_apply(self, v):
        """G_tail @ v: (..., nx) -> (..., m_tail)."""
        n, o = self.n, self.o
        vu = v[..., :o].reshape(v.shape[:-1] + (n - 1, NJ))
        yq = self.c_q @ vu
        ydq = self.c_dq @ vu
        yddq = self.c_ddq @ vu
        ys = (self.b_slack @ v[..., o:, None])[..., 0]
        f = lambda t: t.flatten(-2)
        return torch.cat(
            [f(yq), -f(yq), f(ydq), -f(ydq), f(yddq), -f(yddq), f(vu), -f(vu), ys],
            dim=-1,
        )

    def tail_apply_t(self, y):
        """G_tail^T @ y: (..., m_tail) -> (..., nx)."""
        n = self.n
        nb = NJ * (n - 1)
        blocks = y[..., : 8 * nb].reshape(y.shape[:-1] + (8, n - 1, NJ))
        b = lambda i: blocks[..., i, :, :]
        vu = (
            self.c_q.mT @ (b(0) - b(1))
            + self.c_dq.mT @ (b(2) - b(3))
            + self.c_ddq.mT @ (b(4) - b(5))
            + (b(6) - b(7))
        )
        vs = (self.b_slack.mT @ y[..., 8 * nb :, None])[..., 0]
        return torch.cat([vu.flatten(-2), vs], dim=-1)

    def tail_gram(self, w):
        """G_tail^T diag(w) G_tail: (..., m_tail) -> (..., nx, nx), assembled
        as per-joint profile Grams + a diagonal (u rows) + the slack block."""
        n, o = self.n, self.o
        lead = w.shape[:-1]
        nb = NJ * (n - 1)
        wb = w[..., : 8 * nb].reshape(lead + (8, n - 1, NJ))
        wsum = lambda i: wb[..., i, :, :] + wb[..., i + 1, :, :]
        gram = lambda c, wk: torch.einsum("ka,...kj,kb->...jab", c, wk, c)
        m = gram(self.c_q, wsum(0)) + gram(self.c_dq, wsum(2)) + gram(self.c_ddq, wsum(4))
        eye_j = torch.eye(NJ, dtype=w.dtype, device=w.device)
        uu = torch.einsum("...jab,jk->...ajbk", m, eye_j).reshape(lead + (o, o))
        uu = uu + torch.diag_embed(wsum(6).flatten(-2))
        ss = self.b_slack.mT @ (w[..., 8 * nb :, None] * self.b_slack)
        zeros = lambda r, c: torch.zeros(lead + (r, c), dtype=w.dtype, device=w.device)
        ns = self.n_slack
        return torch.cat(
            [torch.cat([uu, zeros(o, ns)], dim=-1), torch.cat([zeros(ns, o), ss], dim=-1)],
            dim=-2,
        )

    def tail_values(self, traj):
        """g_tail(x) from a rollout, row order of `ocp.evaluate`'s bound and
        slack blocks (any leading dims before the horizon axis)."""
        q, dq, ddq, u = (traj[k][..., 1:, :] for k in ("q", "dq", "ddq", "u"))
        f = lambda t: t.flatten(-2)
        return torch.cat(
            [
                f(q - self.q_ub), f(self.q_lb - q),
                f(dq - self.dq_lim), f(-self.dq_lim - dq),
                f(ddq - DDQ_LIM), f(-DDQ_LIM - ddq),
                f(u - U_MAX), f(U_MIN - u),
                -traj["dslacks"], -traj["rslacks"], -traj["drs"],
                -traj["pslacks"], -traj["dps"],
            ],
            dim=-1,
        )

    # ---- runtime Grams (flat: one full-width product each) ---------------

    def gram_g(self, g_run, w, lowp: bool = False):
        """G_run^T diag(w) G_run; ``lowp``: the bf16 Gram of
        `ops.qp.dense_gram` (G and w rounded to bfloat16, the rest in
        float32, as the JAX package's jitted Gram)."""
        if lowp:
            return dense_gram(g_run, w, lowp=True)
        return g_run.mT @ (g_run * w[..., None])

    def gram_r(self, j_res):
        """J_r^T J_r, the Gauss-Newton Hessian's dominant product."""
        return j_res.mT @ j_res


def build(n: int, dt: float, robot: str = "iiwa14", chunked: bool = False) -> OCPStruct:
    """The flat structure; the dense routes (``struct_ocp=False``) build it
    too, for the chain, the limits and ``tail_values``."""
    if chunked:
        raise NotImplementedError("struct_chunked=True is not ported (flat mode only)")
    return OCPStruct(n, dt, robot)
