"""Batched SQP solve of the condensed BoundMPC OCP
(port of ``boundplanner_tpu/mpc/solver.py``).

Three Jacobian routes, chosen by the configuration as in the JAX package:

- ``struct_ocp=True``: the structured chain rule
  (`ocp_jac.evaluate_with_jac_structured`); with ``struct_tail`` the
  static bound/slack tail is applied structurally inside the IPM (flat, or
  with the causal chunk split of ``struct_chunked``; the link rows
  factored with ``struct_link``), without it every row goes to a dense QP;
- ``manual_jac=True``: the dense chain rule (`ocp_jac.evaluate_with_jac`)
  and a dense QP on all constraint rows;
- neither (``MPCParams()``, the default): forward-mode AD of the vmapped
  ``ocp.evaluate`` (136 tangents, `ops.sqp.jac_fwd`) and a dense QP.

Each subproblem is solved by the IPM or, with ``qp_solver="admm"``, by
ADMM. Every KKT matrix is factored through `ops.linalg.kkt_inverse`:
kernel A on a CUDA tensor, its plain version on the CPU. ``pallas_kkt``
therefore chooses nothing in the port: the JAX package's two
factorizations (`pallas_kkt` True or False) compute the same function.
"""

from __future__ import annotations

from torch.func import vmap

from ..config import MPCParams
from ..ops.sqp import SQPResult, gauss_newton_sqp
from . import ocp, ocp_jac


def check_supported(cfg: MPCParams) -> None:
    """Raise ``ValueError`` for the combinations the JAX package rejects:
    ``struct_link`` without the flat structural tail (a ``ValueError``
    there too), and ADMM with the structural tail (there a shape error
    while tracing: its ADMM branch takes the full constraint values but
    only the runtime rows of the Jacobian). ADMM runs with the dense
    routes, or with ``struct_tail=False``."""
    use_struct = cfg.struct_ocp and cfg.struct_tail
    if cfg.struct_link and not (use_struct and not cfg.struct_chunked):
        raise ValueError("struct_link requires struct_tail=True, struct_chunked=False")
    if cfg.qp_solver == "admm" and use_struct:
        raise ValueError("qp_solver='admm' with struct_ocp=True, struct_tail=True: ADMM "
                         "solves dense rows only; set struct_tail=False or struct_ocp=False")


def solve_sqp(x0, params, cfg: MPCParams, st) -> SQPResult:
    """x0 (B, nx); ``params`` leaves carry the scene axis B."""
    check_supported(cfg)

    def eval_fn(xs):  # (B, L, nx): line-search candidates per scene
        one = lambda x, p: ocp.evaluate(x, p, cfg, st)
        return vmap(vmap(one, in_dims=(0, None)))(xs, params)

    if cfg.struct_ocp:
        jac_one = ocp_jac.evaluate_with_jac_structured
    elif cfg.manual_jac:
        jac_one = ocp_jac.evaluate_with_jac
    else:
        jac_one = None
    eval_jac_fn = None
    if jac_one is not None:
        def eval_jac_fn(x):  # (B, nx)
            return vmap(lambda xx, pp: jac_one(xx, pp, cfg, st))(x, params)

    return gauss_newton_sqp(
        eval_fn=eval_fn,
        eval_jac_fn=eval_jac_fn,
        struct=st if cfg.struct_ocp and cfg.struct_tail else None,
        x0=x0,
        iters=cfg.sqp_iters,
        qp_iters=cfg.qp_iters,
        line_search_steps=cfg.line_search_steps,
        merit_penalty=cfg.merit_penalty,
        viol_tol=1e-4,
        qp_solver=cfg.qp_solver,
        admm_iters=cfg.admm_iters,
        qp_lowp=cfg.qp_bf16,
        kkt_every=cfg.kkt_every,
        qp_gondzio=cfg.qp_gondzio,
        qp_warm_dual=cfg.qp_warm_dual,
        qp_warm_sz=cfg.qp_warm_sz,
        qp_lowp_rd=cfg.qp_bf16_rd,
        link_a=params["a_set_joints"] if cfg.struct_link else None,
    )
