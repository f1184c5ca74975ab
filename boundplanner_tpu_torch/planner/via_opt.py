"""Via-point optimization (port of ``boundplanner_tpu/planner/via_opt.py``).

``solve_via_rot`` is the via-point + rotation-fraction NLP, solved by the
generic Gauss-Newton SQP (`ops.sqp`, Jacobian by forward-mode AD);
``fit_ee_in_set`` probes 20 rotation fractions with one batched phase-1 QP.
Both take a leading batch axis B. The per-problem residual and constraint
functions mirror the JAX ones line by line and are batched with
``torch.func.vmap``; the EE tip is held inside the via sets at a fixed fan
of samples per segment.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from ..ops.qp import solve_feasibility
from ..ops.sqp import gauss_newton_sqp
from ..utils import so3

N_SEG_SAMPLES = 7  # interior samples per segment for tip containment


def _tip(omega_normed, omega_norm, w, l_ee):
    """EE tip offset after rotating l_ee (3,) by the fraction(s) w of the
    rotation omega_norm about omega_normed: w () -> (3,), w (S,) -> (S, 3)."""
    rot = so3.rodrigues(omega_normed, omega_norm * w)
    return rot @ l_ee


def _via_rot_problem(nr_via: int, samples):
    """(r(x), g(x)) of ONE via-rotation NLP, as functions of x (4 nr_via,)
    and that problem's data."""

    def unpack(x):
        blocks = x.reshape(nr_via, 4)
        return blocks[:, :3], blocks[:, 3]

    def ends(x, p_start, p_end):
        p, w = unpack(x)
        p_all = torch.cat([p_start[None], p, p_end[None]], dim=0)
        w_all = torch.cat([w.new_zeros(1), w, w.new_ones(1)])
        return p, w, p_all, w_all

    def residuals(x, p_start, p_end, w_size_via):
        _, _, p_all, w_all = ends(x, p_start, p_end)
        dp = p_all[1:] - p_all[:-1]                      # (nr_via+1, 3)
        dw = w_all[1:] - w_all[:-1]
        sw = torch.sqrt(w_size_via)
        return torch.cat([(sw[:, None] * dp).reshape(-1), sw * dw])

    def cons(x, p_start, p_end, l_ee, omega_normed, omega_norm,
             a_inter, b_inter, a_via, b_via):
        p, w, p_all, w_all = ends(x, p_start, p_end)
        rows = []
        # via point and its EE tip inside the intersection set
        for i in range(nr_via):
            tip = _tip(omega_normed, omega_norm, w[i], l_ee)
            rows.append(a_inter[i] @ p[i] - b_inter[i])
            rows.append(a_inter[i] @ (p[i] + tip) - b_inter[i])
        # tip containment along each segment in its via set (sampled fan)
        for i in range(nr_via + 1):
            pm = p_all[i] + samples[:, None] * (p_all[i + 1] - p_all[i])
            wm = w_all[i] + samples * (w_all[i + 1] - w_all[i])
            tip = _tip(omega_normed, omega_norm, wm, l_ee)
            rows.append(((pm + tip) @ a_via[i].mT - b_via[i]).reshape(-1))
        # 0 <= w <= 1
        rows.append(-w)
        rows.append(w - 1.0)
        return torch.cat(rows)

    def both(x, p_start, p_end, l_ee, omega_normed, omega_norm, w_size_via,
             a_inter, b_inter, a_via, b_via):
        return (residuals(x, p_start, p_end, w_size_via),
                cons(x, p_start, p_end, l_ee, omega_normed, omega_norm,
                     a_inter, b_inter, a_via, b_via))

    return both


def solve_via_rot(x0, p_start, p_end, l_ee, omega_normed, omega_norm,
                  w_size_via, a_inter, b_inter, a_via, b_via, nr_via: int):
    """Optimize via points + rotation interpolation fractions, for a batch:
    x0 (B, 4 nr_via) laid out [p_1 (3), w_1, p_2 (3), w_2, ...]; p_start,
    p_end, l_ee, omega_normed (B, 3); omega_norm (B,); w_size_via
    (B, nr_via+1); a_inter (B, nr_via, R, 3), b_inter (B, nr_via, R); a_via
    (B, nr_via+1, R, 3), b_via (B, nr_via+1, R). Returns the SQPResult."""
    dtype, dev = p_start.dtype, p_start.device
    samples = torch.linspace(0.0, 1.0, N_SEG_SAMPLES + 2, dtype=dtype, device=dev)[1:-1]
    one = _via_rot_problem(nr_via, samples)
    data = (p_start, p_end, l_ee, omega_normed, omega_norm, w_size_via,
            a_inter, b_inter, a_via, b_via)
    # inner vmap: the line search's candidates of one problem share its data
    per_problem = vmap(one, in_dims=(0,) + (None,) * len(data))
    batched = vmap(per_problem, in_dims=(0,) * (1 + len(data)))

    def eval_fn(x):                                    # x (B, L, nx)
        return batched(x, *data)

    return gauss_newton_sqp(eval_fn, x0, iters=25, qp_iters=30,
                            line_search_steps=8, merit_penalty=1e3, viol_tol=1e-5)


def fit_ee_in_set(a_set, b_set, l_ee, omega_normed, omega_norm, sample_point):
    """Does the EE segment fit into the set for one of 20 sampled rotation
    fractions? a_set (B, R, 3), b_set (B, R) (already shrunk by the
    caller), l_ee/omega_normed/sample_point (B, 3), omega_norm (B,).
    Returns (fits (B,), omega (B,) first feasible fraction, p (B, 3))."""
    dtype, dev = b_set.dtype, b_set.device
    bsz, rows = b_set.shape
    n_w = 20
    omegas = torch.linspace(0.0, 1.0, n_w, dtype=dtype, device=dev)
    rot = so3.rodrigues(omega_normed[:, None, :].expand(bsz, n_w, 3),
                        omega_norm[:, None] * omegas)               # (B, 20, 3, 3)
    tip = (rot @ l_ee[:, None, :, None])[..., 0]                    # (B, 20, 3)
    g = torch.cat([a_set, a_set], dim=1)[:, None].expand(bsz, n_w, 2 * rows, 3)
    h = torch.cat([b_set[:, None].expand(bsz, n_w, rows),
                   b_set[:, None] - (a_set[:, None] @ tip[..., None])[..., 0]], dim=-1)
    x, t, _ = solve_feasibility(
        g.reshape(bsz * n_w, 2 * rows, 3), h.reshape(bsz * n_w, 2 * rows),
        x0=sample_point[:, None].expand(bsz, n_w, 3).reshape(bsz * n_w, 3), iters=25)
    ok = (t < 1e-7).reshape(bsz, n_w)
    xs = x.reshape(bsz, n_w, 3)
    fits = ok.any(dim=-1)
    first = torch.argmax(ok.to(torch.int32), dim=-1)                # first True
    rows_b = torch.arange(bsz, device=dev)
    omega = torch.where(fits, omegas[first], 0.0)
    return fits, omega, xs[rows_b, first]
