"""The benchmark's frozen arithmetic: the card's published peaks, the
roofline bound, the union of busy intervals, the analytic FLOPs of one SQP
solve, and the bytes and operations of the port's two kernels.

Copied from the program's measurement code as it stood at commit c40b44d
(``chip_smoke.py``: ``bound``, ``union_us``, the peaks and kernel B's
bytes; ``boundplanner_tpu_torch/mpc/flops.py``: ``solve_flops``), so that a
later change to the program cannot move the yardstick.
"""

from __future__ import annotations

# the card's published peaks (H100 SXM, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}   # outside the tensor cores

# the OCP's fixed sizes (the port's config.py and mpc/ocp.py)
NJ = 7
MPC_SET_ROWS = 15
NUM_LINK_SETS = 6
OBS_SLOTS = 16          # obstacle slots per scene (MAX_OBS)


def bound_s(bytes_moved: float, ops: float, dtype: str) -> tuple[float, str]:
    """(seconds, bound_by): the least time the card could take for work that
    moves ``bytes_moved`` and does ``ops`` operations of ``dtype``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def gaps(spans) -> list[tuple[float, float]]:
    """The idle intervals between the union's pieces, in order."""
    out, end = [], None
    for lo, hi in sorted(spans):
        if end is not None and lo > end:
            out.append((end, lo))
        end = hi if end is None else max(end, hi)
    return out


# -- kernel A: L^{-1} of a batch of SPD n x n matrices (csrc/chol_inverse.cu)

def kkt_inverse_work(batch: int, n: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of one factorization call: K's lower triangle
    read once, L^{-1} written once whole; n^3 / 3 for the Cholesky and n^3 / 3
    for the triangular inverse, a multiply and an add each."""
    bytes_moved = batch * (n * (n + 1) // 2 + n * n) * itemsize
    return float(bytes_moved), float(batch * 2 * n ** 3 / 3)


# -- kernel B: segment <-> polytope closest pair (csrc/line_polytope.cu)

def seg_poly_work(problems: int, rows: int = MPC_SET_ROWS, itemsize: int = 4) -> float:
    """Bytes of one call: a (P, R, 3), b (P, R), p0, p1 (P, 3) in; x (P, 3),
    phi, dist (P,) out. The call is bound by these bytes (its operations,
    counted over the rows the Dykstra sweeps keep, bound it less)."""
    per_problem = rows * 3 + rows + 3 + 3 + 3 + 1 + 1
    return float(problems * per_problem * itemsize)


# -- the analytic FLOPs of one SQP solve (mpc/flops.py at c40b44d)

N_Z = 61                # the OCP's per-step outputs (mpc/ocp.py)


def layout_ints(n: int) -> dict:
    """The counts of the port's ``ocp_struct.layout(n)`` at c40b44d."""
    nx = NJ * (n - 1) + 6 + 1 + n + 1 + n
    o = NJ * (n - 1)
    per_step_g = MPC_SET_ROWS + 6 + NUM_LINK_SETS * MPC_SET_ROWS + 1
    n_term_g = MPC_SET_ROWS + 6
    per_step_r = 15 + 3 + 7 + 2 + 9 + 4
    n_term_r = 5 + 6 + 6
    n_b_slack = 6 + 4 * n
    half = (n - 1) // 2
    n_cols_a = NJ * half + 7 + (half + 1) + 1 + (half + 1)
    return {"nx": nx, "o": o, "per_step_g": per_step_g, "per_step_r": per_step_r,
            "m_run": (n - 1) * per_step_g + n_term_g, "m_r": (n - 1) * per_step_r + n_term_r,
            "m_tail": 8 * NJ * (n - 1) + n_b_slack, "n_slack": nx - o,
            "n_b_slack": n_b_slack, "half": half, "n_cols_a": n_cols_a, "n_z": N_Z}


def solve_flops(cfg) -> float:
    """Dominant dense-linalg FLOPs of one SQP solve under ``cfg`` (an
    ``MPCParams``): ``mpc/flops.py::solve_flops(cfg)["total"]`` at c40b44d."""
    st = layout_ints(cfg.n)
    n = cfg.n
    nx, m_run, m_tail, n_res = st["nx"], st["m_run"], st["m_tail"], st["m_r"]
    m = m_run + m_tail
    n_cols_a = st["n_cols_a"]

    mm = lambda rows, inner, cols=1: 2.0 * rows * inner * cols
    factor = nx ** 3 / 3.0 + nx ** 3 / 2.0
    if cfg.struct_ocp:
        chunked = cfg.struct_chunked
        rows_ag = st["half"] * st["per_step_g"] if chunked else 0
        rows_ar = st["half"] * st["per_step_r"] if chunked else 0
        gram = (mm(n_cols_a, rows_ag, n_cols_a) + mm(nx, m_run - rows_ag, nx)
                + 3 * mm(NJ * (n - 1), n - 1, n - 1) / NJ
                + mm(st["n_slack"], st["n_b_slack"], st["n_slack"]))
        hess = mm(n_cols_a, rows_ar, n_cols_a) + mm(nx, n_res - rows_ar, nx)
        mv = mm(m_run, nx)
        jac = (mm((n - 1) * (26 + 22), 12, nx)
               + mm((n - 1) * NUM_LINK_SETS * 3, NJ, nx)
               + mm((n - 1) * NUM_LINK_SETS * MPC_SET_ROWS, 3, nx)
               + mm((n - 1) * 6, NJ, nx) * 2 + mm((n - 1) * 3, n - 1, nx))
    else:
        gram = mm(nx, m, nx)
        hess = mm(nx, n_res, nx)
        mv = mm(m, nx)
        jac = mm((n - 1) * (st["per_step_r"] + st["per_step_g"]), st["n_z"], nx) + (
            mm((n - 1) * 6, NJ, nx) * 2 + mm((n - 1) * 3, n - 1, nx)
            + mm((n - 1) * NUM_LINK_SETS * 3, NJ, nx))
    per_ipm = gram + factor + 2 * (2 * mv + 6 * 2.0 * nx * nx) + mv
    per_sqp = jac + hess + mm(n_res, nx) + cfg.qp_iters * per_ipm
    return cfg.sqp_iters * per_sqp
