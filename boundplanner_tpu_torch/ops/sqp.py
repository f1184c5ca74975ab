"""Batched Gauss-Newton SQP over the dense QP-IPM
(port of the structured branch of ``boundplanner_tpu/ops/sqp.py``).

Problem form per scene:  min |r(x)|^2  s.t.  g(x) <= 0. Fixed-trip
iteration with per-scene ``done`` masks keeps the batch in lockstep (no
host sync inside the loop).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .qp import solve_qp


class SQPResult(NamedTuple):
    x: torch.Tensor        # (B, nx)
    cost: torch.Tensor     # (B,)
    viol: torch.Tensor     # (B,)
    iters: torch.Tensor    # (B,) int32
    success: torch.Tensor  # (B,) bool


def _pick(t, idx):
    """Per-scene row selection: t (B, L, ...), idx (B,) -> (B, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


def gauss_newton_sqp(
    eval_fn: Callable,
    x0: torch.Tensor,
    iters: int = 12,
    qp_iters: int = 25,
    line_search_steps: int = 6,
    merit_penalty: float = 1e3,
    viol_tol: float = 1e-4,
    eval_jac_fn: Callable | None = None,
    qp_lowp: bool = False,
    struct=None,
    qp_gondzio: int = 0,
    qp_lowp_rd: bool = False,
) -> SQPResult:
    """``eval_fn``: x (B, L, nx) -> (r (B, L, mr), g (B, L, mg)), used for
    the line search's L candidates per scene. ``eval_jac_fn``: x (B, nx) ->
    (r, g, J_r, J_g_runtime) with the values of ``eval_fn``; the static
    constraint tail of ``struct`` (`mpc.ocp_struct.OCPStruct`) is applied
    structurally inside the QP. Only this structured form is ported."""
    if eval_jac_fn is None or struct is None:
        raise NotImplementedError("only the eval_jac_fn + struct SQP branch is ported")
    dtype, dev = x0.dtype, x0.device
    bsz, n_x = x0.shape
    eye = torch.eye(n_x, dtype=dtype, device=dev)
    alphas = 2.0 ** -torch.arange(line_search_steps, dtype=dtype, device=dev)
    m_run = struct.m_run

    def merit_of(r, g):
        return torch.sum(r * r, dim=-1) + merit_penalty * torch.sum(
            torch.clamp(g, min=0.0), dim=-1
        )

    r_cur, g_cur = (t[:, 0] for t in eval_fn(x0[:, None]))
    m0 = merit_of(r_cur, g_cur)
    merit_prev = torch.where(torch.isfinite(m0), m0, torch.inf)
    x = x0
    lam = torch.full((bsz,), 1e-4, dtype=dtype, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    used = torch.zeros(bsz, dtype=torch.int32, device=dev)

    for _ in range(iters):
        r, g, jr, jg = eval_jac_fn(x)
        grad = 2.0 * (jr.mT @ r[..., None])[..., 0]
        hess = 2.0 * struct.gram_r(jr) + lam[:, None, None] * eye
        qp = solve_qp(hess, grad, jg, -g[:, :m_run], iters=qp_iters, tol=1e-10,
                      lowp=qp_lowp, struct=struct, h_tail=-g[:, m_run:],
                      gondzio=qp_gondzio, lowp_rd=qp_lowp_rd)
        d = qp.x

        cand = x[:, None, :] + alphas[None, :, None] * d[:, None, :]
        r_c, g_c = eval_fn(cand)
        merits = merit_of(r_c, g_c)
        merits = torch.where(torch.isfinite(merits), merits, torch.inf)
        # tie band toward the LARGEST step: the first candidate within a
        # relative band of the best merit (alphas descend); first-True
        # argmax, on a float cast since argmax takes no bool
        m_min = torch.amin(merits, dim=-1)
        band = 1e-5 * torch.abs(m_min) + 1e-9
        best = torch.argmax((merits <= (m_min + band)[:, None]).to(dtype), dim=-1)
        merit_new = _pick(merits, best)
        improved = merit_new < merit_prev - 1e-12

        imp = improved[:, None]
        r_new = torch.where(imp, _pick(r_c, best), r_cur)
        g_new = torch.where(imp, _pick(g_c, best), g_cur)
        x_new = torch.where(imp, _pick(cand, best), x)
        lam_new = torch.where(improved, torch.clamp(lam * 0.5, min=1e-8), lam * 10.0)
        merit_next = torch.where(improved, merit_new, merit_prev)

        step_norm = torch.linalg.vector_norm(alphas[best][:, None] * d, dim=-1)
        conv = improved & (step_norm < 1e-7)

        dd = done[:, None]
        x = torch.where(dd, x, x_new)
        lam = torch.where(done, lam, lam_new)
        merit_prev = torch.where(done, merit_prev, merit_next)
        r_cur = torch.where(dd, r_cur, r_new)
        g_cur = torch.where(dd, g_cur, g_new)
        used = used + (~done).to(torch.int32)
        done = done | conv | (lam > 1e8)

    viol = torch.amax(torch.clamp(g_cur, min=0.0), dim=-1)
    return SQPResult(
        x=x,
        cost=torch.sum(r_cur * r_cur, dim=-1),
        viol=viol,
        iters=used,
        success=viol < viol_tol,
    )
