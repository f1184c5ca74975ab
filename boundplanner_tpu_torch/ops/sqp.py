"""Batched Gauss-Newton SQP over the dense QP-IPM or ADMM
(port of ``boundplanner_tpu/ops/sqp.py``: the generic branch, whose
Jacobian is forward-mode AD of the evaluation, the manual-Jacobian dense
branch, and the structured branch of the MPC with or without factored
link rows; every QP knob of the JAX engine).

Problem form per scene:  min |r(x)|^2  s.t.  g(x) <= 0. Fixed-trip
iteration with per-scene ``done`` masks keeps the batch in lockstep (no
host sync inside the loop).

Inside a tick (`telemetry.device_tick`), each iteration marks three
phases on the card (`telemetry.device_phase`): ``ocp`` (the evaluation
and Jacobians, with the first evaluation before the loop), ``qp`` (the
gradient, Gram and Hessian and the QP solve) and ``line_search`` (the
candidates through the iterate's update). Elsewhere (the planner) it
marks nothing.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import torch

from .. import telemetry
from .qp import solve_qp, solve_qp_admm


class SQPResult(NamedTuple):
    x: torch.Tensor        # (B, nx)
    cost: torch.Tensor     # (B,)
    viol: torch.Tensor     # (B,)
    iters: torch.Tensor    # (B,) int32
    success: torch.Tensor  # (B,) bool


def _pick(t, idx):
    """Per-scene row selection: t (B, L, ...), idx (B,) -> (B, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), idx]


# torch.func's forward-AD levels are process-global: two threads whose jvp
# (or vmap) calls interleave corrupt each other's levels. The generic
# branch, which planner threads run concurrently, evaluates under this lock.
_TRANSFORMS = threading.RLock()


def _locked(fn):
    def run(*args):
        with _TRANSFORMS:
            return fn(*args)
    return run


def jac_fwd(eval_fn, x):
    """Per-problem Jacobians of ``eval_fn`` at x (B, nx): one forward-mode
    tangent per coordinate (``torch.func.jvp`` under ``torch.func.vmap``),
    the batched form of ``jax.jacfwd``. Returns (J_r (B, mr, nx),
    J_g (B, mg, nx))."""
    bsz, n_x = x.shape

    def flat(v):
        r, g = eval_fn(v[:, None])
        return r[:, 0], g[:, 0]

    def column(t):
        return torch.func.jvp(flat, (x,), (t,))[1]

    eye = torch.eye(n_x, dtype=x.dtype, device=x.device)
    jr, jg = torch.func.vmap(column)(eye[:, None, :].expand(n_x, bsz, n_x))
    return jr.permute(1, 2, 0), jg.permute(1, 2, 0)


def gauss_newton_sqp(
    eval_fn: Callable,
    x0: torch.Tensor,
    iters: int = 12,
    qp_iters: int = 25,
    line_search_steps: int = 6,
    merit_penalty: float = 1e3,
    viol_tol: float = 1e-4,
    qp_solver: str = "ipm",
    admm_iters: int = 60,
    eval_jac_fn: Callable | None = None,
    qp_lowp: bool = False,
    kkt_every: int = 1,
    struct=None,
    qp_gondzio: int = 0,
    link_a=None,
    qp_warm_dual: bool = False,
    qp_lowp_rd: bool = False,
    qp_warm_sz: bool = False,
) -> SQPResult:
    """``eval_fn``: x (B, L, nx) -> (r (B, L, mr), g (B, L, mg)), used for
    the line search's L candidates per scene.

    Without ``eval_jac_fn`` (the generic branch) the Jacobians come from
    forward-mode AD of ``eval_fn`` (:func:`jac_fwd`) and the QP is dense.
    With it, ``eval_jac_fn``: x (B, nx) -> (r, g, J_r, J_g) with the values
    of ``eval_fn``. Without ``struct`` (e.g. `mpc.ocp_jac.evaluate_with_jac`)
    J_g covers every row and the QP is dense; with ``struct``
    (`mpc.ocp_struct.OCPStruct`, the MPC's structured branch) J_g covers the
    runtime rows only and the static constraint tail is applied
    structurally inside the QP. With ``link_a`` (the scenes' link-set
    matrices (B, 6, 15, 3)) ``eval_jac_fn`` returns (r, g, J_r, J_g_dense,
    acol_u) and the link rows are applied through their factorization,
    row order [dense | link | tail].

    ``qp_solver="admm"`` solves each subproblem with :func:`solve_qp_admm`
    (``admm_iters`` sweeps) on the dense rows. ``qp_warm_dual`` carries
    each scene's QP duals (ones at first) into the next iteration's IPM as
    ``z0``, also for scenes that are done; ``qp_warm_sz`` pairs them with
    the warm slack."""
    if struct is not None and eval_jac_fn is None:
        raise ValueError("struct needs a matching eval_jac_fn (structured branch)")
    if eval_jac_fn is None:
        eval_fn = _locked(eval_fn)
    dtype, dev = x0.dtype, x0.device
    bsz, n_x = x0.shape
    eye = torch.eye(n_x, dtype=dtype, device=dev)
    alphas = 2.0 ** -torch.arange(line_search_steps, dtype=dtype, device=dev)

    def merit_of(r, g):
        return torch.sum(r * r, dim=-1) + merit_penalty * torch.sum(
            torch.clamp(g, min=0.0), dim=-1
        )

    x = x0
    lam = torch.full((bsz,), 1e-4, dtype=dtype, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    used = torch.zeros(bsz, dtype=torch.int32, device=dev)
    ipm_kw = dict(iters=qp_iters, tol=1e-10, lowp=qp_lowp, kkt_every=kkt_every,
                  gondzio=qp_gondzio, lowp_rd=qp_lowp_rd, warm_sz=qp_warm_sz)

    with telemetry.device_phase("ocp", dev) as phase:
        r_cur, g_cur = (t[:, 0] for t in eval_fn(x0[:, None]))
        m0 = merit_of(r_cur, g_cur)
        merit_prev = torch.where(torch.isfinite(m0), m0, torch.inf)
        z_prev = torch.ones_like(g_cur) if qp_warm_dual else None

        for it in range(iters):
            if it:
                phase.to("ocp")
            acol_u = None
            if eval_jac_fn is None:
                r, g = (t[:, 0] for t in eval_fn(x[:, None]))
                with _TRANSFORMS:
                    jr, jg = jac_fwd(eval_fn, x)
            elif link_a is not None:
                r, g, jr, jg, acol_u = eval_jac_fn(x)
            else:
                r, g, jr, jg = eval_jac_fn(x)

            phase.to("qp")
            grad = 2.0 * (jr.mT @ r[..., None])[..., 0]
            gram = struct.gram_r(jr) if struct is not None else jr.mT @ jr
            hess = 2.0 * gram + lam[:, None, None] * eye

            if qp_solver == "admm":
                qp = solve_qp_admm(hess, grad, jg, -g, iters=admm_iters)
            elif struct is not None and link_a is not None:
                md, ml = struct.m_dense, struct.m_link
                qp = solve_qp(hess, grad, jg, -g[:, :md], struct=struct, h_tail=-g[:, md + ml:],
                              link=(acol_u, link_a), h_link=-g[:, md:md + ml], z0=z_prev,
                              **ipm_kw)
            elif struct is not None:
                m_run = struct.m_run
                qp = solve_qp(hess, grad, jg, -g[:, :m_run], struct=struct,
                              h_tail=-g[:, m_run:], z0=z_prev, **ipm_kw)
            else:
                qp = solve_qp(hess, grad, jg, -g, z0=z_prev, **ipm_kw)
            d = qp.x

            phase.to("line_search")
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
            if qp_warm_dual:
                z_prev = qp.z

    viol = torch.amax(torch.clamp(g_cur, min=0.0), dim=-1)
    return SQPResult(
        x=x,
        cost=torch.sum(r_cur * r_cur, dim=-1),
        viol=viol,
        iters=used,
        success=viol < viol_tol,
    )
