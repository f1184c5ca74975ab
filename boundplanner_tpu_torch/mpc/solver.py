"""Batched SQP solve of the condensed BoundMPC OCP
(port of ``boundplanner_tpu/mpc/solver.py``).

Three Jacobian routes, chosen by the configuration as in the JAX package:

- ``struct_ocp=True``: the structured chain rule
  (`ocp_jac.evaluate_with_jac_structured`), the static bound/slack tail
  applied structurally inside the IPM (flat mode, ``struct_chunked=False``);
- ``manual_jac=True``: the dense chain rule (`ocp_jac.evaluate_with_jac`)
  and a dense QP on all constraint rows;
- neither (``MPCParams()``, the default): forward-mode AD of the vmapped
  ``ocp.evaluate`` (136 tangents, `ops.sqp.jac_fwd`) and a dense QP.

Every route factors its KKT matrices through `ops.linalg.kkt_inverse`:
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
    """Raise for configuration branches the port does not carry. The
    ``struct_*`` sub-knobs count only under ``struct_ocp``, as in the JAX
    package (``MPCParams()`` has ``struct_chunked=True`` and runs dense)."""
    unsupported = {
        "struct_tail=False": cfg.struct_ocp and not cfg.struct_tail,
        "struct_chunked=True": cfg.struct_ocp and cfg.struct_chunked,
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

    if cfg.struct_ocp:
        jac_one, struct = ocp_jac.evaluate_with_jac_structured, st
    elif cfg.manual_jac:
        jac_one, struct = ocp_jac.evaluate_with_jac, None
    else:
        jac_one, struct = None, None
    eval_jac_fn = None
    if jac_one is not None:
        def eval_jac_fn(x):  # (B, nx)
            return vmap(lambda xx, pp: jac_one(xx, pp, cfg, st))(x, params)

    return gauss_newton_sqp(
        eval_fn=eval_fn,
        eval_jac_fn=eval_jac_fn,
        struct=struct,
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
