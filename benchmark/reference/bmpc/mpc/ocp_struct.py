"""Block-banded structure of the condensed OCP
(port of ``boundplanner_tpu/mpc/ocp_struct.py``).

850 of the 2439 constraint rows (variable bounds and slack nonnegativity)
have constant Jacobians. The QP applies them structurally: per-joint
impulse-response products instead of dense rows, and their Gram as
per-joint 14x14 blocks + a diagonal + a 38x38 slack block. The 1260
link-collision rows factor as A_l @ acol_u - e_dslack (``link_*``,
``struct_link``). In chunked mode (``struct_chunked``) the runtime Grams
split at the causal support of the first half of the horizon.

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
    robot (float64 buffers until ``.to()``), with the tick's two
    configuration constants: the objective ``weights`` and ``split_reset``,
    the re-anchor's split indices [0, n, ..., n] over ``nr_segs`` segments
    (int32). Held as buffers, the tick copies nothing from the host."""

    def __init__(self, n: int, dt: float, robot: str = "iiwa14", chunked: bool = False,
                 weights=(), nr_segs: int = 0):
        super().__init__()
        self.n = n
        self.dt = dt
        self.robot = robot
        self.chunked = chunked
        lay = layout(n)
        o = self.o = lay.o
        self.nx = lay.nx
        self.per_step_g, self.n_term_g = lay.per_step_g, lay.n_term_g
        self.per_step_r, self.n_term_r = lay.per_step_r, lay.n_term_r
        self.m_run, self.m_r = lay.m_run, lay.m_r
        self.m_tail, self.n_slack = lay.m_tail, lay.n_slack
        # struct_link row split: dense runtime rows (set/band/phi/terminal)
        # against the factored link rows
        self.m_link = (n - 1) * NUM_LINK_SETS * MPC_SET_ROWS
        self.m_dense = self.m_run - self.m_link
        self.half = lay.half

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
        # chunk A (steps 1..half): its static column support, u_1..u_half,
        # dslacks + rs0, drs_0..half, ps0, dps_0..half
        half = self.half
        cols = list(range(NJ * half)) + list(range(o, o + 7 + half + 1))
        cols += [o + 7 + n] + list(range(o + 8 + n, o + 8 + n + half + 1))
        assert len(cols) == lay.n_cols_a
        self.register_buffer("cols_a", torch.as_tensor(cols, dtype=torch.long))
        buf("weights", np.asarray(weights, dtype=np.float64))
        self.register_buffer("split_reset", torch.as_tensor([0] + [n] * nr_segs,
                                                            dtype=torch.int32))
        self.chain = Chain(robot)

    # ---- factored link-collision rows ------------------------------------
    # J_link[k, l, r, :] = A[l, r, :] @ acol_u[k, l] - e_{dslack_l}, with
    # A = a_set_joints (..., 6, 15, 3) and acol_u (..., n-1, 6, 3, o) the
    # u-columns of d p_col / dx. Row order k-major, then link, then set row.

    def link_apply(self, acol_u, a_joints, v):
        """J_link @ v: (..., nx) -> (..., m_link)."""
        o = self.o
        t = torch.einsum("...klix,...x->...kli", acol_u, v[..., :o])
        rows = torch.einsum("...lri,...kli->...klr", a_joints, t)
        return (rows - v[..., None, o:o + NUM_LINK_SETS, None]).flatten(-3)

    def link_apply_t(self, acol_u, a_joints, y):
        """J_link^T @ y: (..., m_link) -> (..., nx)."""
        n, o = self.n, self.o
        yk = y.reshape(y.shape[:-1] + (n - 1, NUM_LINK_SETS, MPC_SET_ROWS))
        t = torch.einsum("...lri,...klr->...kli", a_joints, yk)
        vu = torch.einsum("...klix,...kli->...x", acol_u, t)
        vds = -torch.sum(yk, dim=(-3, -1))
        rest = y.new_zeros(y.shape[:-1] + (self.nx - o - NUM_LINK_SETS,))
        return torch.cat([vu, vds, rest], dim=-1)

    def link_gram(self, acol_u, a_joints, w):
        """J_link^T diag(w) J_link: (..., m_link) -> (..., nx, nx)."""
        n, o, nl = self.n, self.o, NUM_LINK_SETS
        lead = w.shape[:-1]
        wk = w.reshape(lead + (n - 1, nl, MPC_SET_ROWS))
        inner = torch.einsum("...lri,...klr,...lrj->...klij", a_joints, wk, a_joints)
        half = torch.einsum("...klij,...kljx->...klix", inner, acol_u)
        uu = torch.einsum("...klix,...kliy->...xy", acol_u, half)
        # the rows' -e_{dslack_l} against the u part and against themselves
        cross = -torch.einsum("...lri,...klr,...klix->...lx", a_joints, wk, acol_u)
        out = w.new_zeros(lead + (self.nx, self.nx))
        out[..., :o, :o] = uu
        out[..., o:o + nl, :o] = cross
        out[..., :o, o:o + nl] = cross.mT
        out[..., o:o + nl, o:o + nl] = torch.diag_embed(torch.sum(wk, dim=(-3, -1)))
        return out

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

    # ---- runtime Grams, flat or with the causal chunk split --------------

    def gram_g(self, g_run, w, lowp: bool = False):
        """G_run^T diag(w) G_run; ``lowp``: the bf16 Gram of
        `ops.qp.dense_gram` (G and w rounded to bfloat16, the rest in
        float32, as the JAX package's jitted Gram). Chunked, ``g_run`` must
        carry the full m_run row layout (a partial one would be clipped
        into a wrong Gram): it raises otherwise."""
        return self._gram(g_run, self._rows_a(g_run, self.per_step_g, self.m_run, "gram_g"),
                          w, lowp)

    def gram_r(self, j_res):
        """J_r^T J_r, the Gauss-Newton Hessian's dominant product (the same
        row-layout rule as :meth:`gram_g`, m_r rows when chunked)."""
        return self._gram(j_res, self._rows_a(j_res, self.per_step_r, self.m_r, "gram_r"),
                          None, False)

    def _rows_a(self, mat, per_step: int, m_full: int, name: str) -> int:
        """Chunk A's row count (0 when flat), after checking the layout."""
        if not self.chunked:
            return 0
        if mat.shape[-2] != m_full:
            raise ValueError(
                f"{name}(chunked=True) needs the full {m_full}-row layout, got "
                f"{mat.shape[-2]} rows; build the OCPStruct with chunked=False for "
                "partial-row matrices")
        return self.half * per_step

    def _gram(self, mat, rows_a: int, w, lowp: bool):
        """mat^T diag(w) mat (w None: unweighted); rows_a > 0 splits off the
        first rows_a rows, gathered on their column support ``cols_a``."""
        def gram(a, wa):
            if wa is None:
                return a.mT @ a
            if lowp:
                return dense_gram(a, wa, lowp=True)
            return a.mT @ (a * wa[..., None])

        if rows_a == 0:
            return gram(mat, w)
        a = mat[..., :rows_a, :][..., self.cols_a]
        b = mat[..., rows_a:, :]
        wa, wb = (None, None) if w is None else (w[..., :rows_a], w[..., rows_a:])
        out = gram(b, wb)
        ca = self.cols_a
        out[..., ca[:, None], ca[None, :]] += gram(a, wa)
        return out


def build(n: int, dt: float, robot: str = "iiwa14", chunked: bool = False, weights=(),
          nr_segs: int = 0) -> OCPStruct:
    """The structure, flat or chunked; the dense routes (``struct_ocp=False``)
    build it too, for the chain, the limits and ``tail_values``."""
    return OCPStruct(n, dt, robot, chunked, weights, nr_segs)
