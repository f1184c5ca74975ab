"""Analytic FLOP model of one condensed-OCP SQP solve (port of
``boundplanner_tpu/mpc/flops.py``).

Counts the dominant dense linear algebra with true loop trip counts
(matmul = 2mnk), for the dense and the block-banded (``struct_ocp``)
routes, flat and chunked. The AD tangent sweeps and the per-step
reference/error math are excluded from both. The counts are the JAX
package's, key for key: the layout's integers come from
`ocp_struct.layout`, which counts them without building the structure.

    python -m boundplanner_tpu_torch.mpc.flops
"""

from __future__ import annotations

from ..config import MPC_SET_ROWS, NUM_LINK_SETS, MPCParams
from . import ocp
from .ocp_struct import layout

NJ = ocp.NJ


def solve_flops(cfg: MPCParams) -> dict:
    """Dominant dense-linalg FLOPs of one SQP solve under ``cfg``."""
    n = cfg.n
    st = layout(n)
    nx, m_run, m_tail, n_res = st.nx, st.m_run, st.m_tail, st.m_r
    m = m_run + m_tail
    n_cols_a = st.n_cols_a

    mm = lambda rows, inner, cols=1: 2.0 * rows * inner * cols
    factor = nx**3 / 3.0 + nx**3 / 2.0  # masked Cholesky + explicit inverse

    if cfg.struct_ocp:
        chunked = cfg.struct_chunked
        rows_ag = st.half * st.per_step_g if chunked else 0
        rows_ar = st.half * st.per_step_r if chunked else 0
        gram = (
            mm(n_cols_a, rows_ag, n_cols_a)
            + mm(nx, m_run - rows_ag, nx)
            + 3 * mm(NJ * (n - 1), n - 1, n - 1) / NJ  # per-joint profiles
            + mm(st.n_slack, st.n_b_slack, st.n_slack)
        )
        hess = mm(n_cols_a, rows_ar, n_cols_a) + mm(nx, n_res - rows_ar, nx)
        mv = mm(m_run, nx)  # G matvec (tail applies are O(n^2), negligible)
        jac = (
            mm((n - 1) * (26 + 22), 12, nx)              # NL chain einsums
            + mm((n - 1) * NUM_LINK_SETS * 3, NJ, nx)    # acol_x
            + mm((n - 1) * NUM_LINK_SETS * MPC_SET_ROWS, 3, nx)  # link rows
            + mm((n - 1) * 6, NJ, nx) * 2 + mm((n - 1) * 3, n - 1, nx)  # dv, diw
        )
    else:
        gram = mm(nx, m, nx)
        hess = mm(nx, n_res, nx)
        mv = mm(m, nx)
        jac = mm((n - 1) * (st.per_step_r + st.per_step_g), ocp.N_Z, nx) + (
            mm((n - 1) * 6, NJ, nx) * 2
            + mm((n - 1) * 3, n - 1, nx)
            + mm((n - 1) * NUM_LINK_SETS * 3, NJ, nx)
        )

    per_ipm = gram + factor + 2 * (2 * mv + 6 * 2.0 * nx * nx) + mv
    per_sqp = jac + hess + mm(n_res, nx) + cfg.qp_iters * per_ipm
    total = cfg.sqp_iters * per_sqp
    return {
        "total": total,
        "per_sqp_iter": per_sqp,
        "per_ipm_iter": per_ipm,
        "gram": gram,
        "factorization": factor,
        "hessian": hess,
        "jacobian_assembly": jac,
    }


def main():
    import dataclasses

    from ..config import perf_mpc_params

    dense = dataclasses.replace(perf_mpc_params(), struct_ocp=False)
    flat = dataclasses.replace(perf_mpc_params(), struct_ocp=True, struct_chunked=False)
    chunked = dataclasses.replace(flat, struct_chunked=True)
    fd, ff, fc = solve_flops(dense), solve_flops(flat), solve_flops(chunked)
    for k in fd:
        print(f"{k:18s} dense {fd[k]/1e6:9.2f} M   flat {ff[k]/1e6:9.2f} M"
              f"   chunked {fc[k]/1e6:9.2f} M")
    print(f"flat: {fd['total'] / ff['total']:.2f}x   "
          f"chunked: {fd['total'] / fc['total']:.2f}x")


if __name__ == "__main__":
    main()
