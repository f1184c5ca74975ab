"""Batched SQP solve of the condensed BoundMPC OCP
(port of ``boundplanner_tpu/mpc/solver.py``)."""

from __future__ import annotations

from torch.func import vmap

from ..config import MPCParams
from ..ops.sqp import SQPResult, gauss_newton_sqp
from . import ocp, ocp_jac


def check_supported(cfg: MPCParams) -> None:
    """Raise for configuration branches the port does not carry (none of
    them is taken by ``config.perf_mpc_params``)."""
    unsupported = {
        "struct_ocp=False": not cfg.struct_ocp,
        "struct_tail=False": not cfg.struct_tail,
        "struct_chunked=True": cfg.struct_chunked,
        "struct_link=True": cfg.struct_link,
        "qp_solver='admm'": cfg.qp_solver != "ipm",
        "kkt_every>1": cfg.kkt_every != 1,
        "qp_warm_dual": cfg.qp_warm_dual,
        "qp_warm_sz": cfg.qp_warm_sz,
        "esc_lanes>0": cfg.esc_lanes > 0,
    }
    asked = [name for name, bad in unsupported.items() if bad]
    if asked:
        raise NotImplementedError(f"not ported: {', '.join(asked)}")


def solve_sqp(x0, params, cfg: MPCParams, st) -> SQPResult:
    """x0 (B, nx); ``params`` leaves carry the scene axis B."""
    check_supported(cfg)

    def eval_fn(xs):  # (B, L, nx): line-search candidates per scene
        one = lambda x, p: ocp.evaluate(x, p, cfg, st)
        return vmap(vmap(one, in_dims=(0, None)))(xs, params)

    def eval_jac_fn(x):  # (B, nx)
        return vmap(lambda xx, pp: ocp_jac.evaluate_with_jac_structured(xx, pp, cfg, st))(
            x, params
        )

    return gauss_newton_sqp(
        eval_fn=eval_fn,
        eval_jac_fn=eval_jac_fn,
        struct=st,
        x0=x0,
        iters=cfg.sqp_iters,
        qp_iters=cfg.qp_iters,
        line_search_steps=cfg.line_search_steps,
        merit_penalty=cfg.merit_penalty,
        viol_tol=1e-4,
        qp_lowp=cfg.qp_bf16,
        qp_gondzio=cfg.qp_gondzio,
        qp_lowp_rd=cfg.qp_bf16_rd,
    )
