"""Batched dense convex-QP solvers: the Mehrotra predictor-corrector IPM
and OSQP-style ADMM (port of ``solve_qp``, ``solve_qp_admm``,
``solve_projection``, ``solve_line_projection`` and ``solve_feasibility``
of ``boundplanner_tpu/ops/qp.py``).

Problem form, one per row of the leading batch axis B::

    minimize    0.5 x^T P x + q^T x
    subject to  G x <= h

Iteration is a fixed-trip loop with a per-problem ``done`` mask (no host
sync inside), so a batch stays in lockstep like the JAX ``fori_loop``.
Every branch of the JAX solvers is ported: the dense form, the structured
static tail (``struct``) with its factored link rows (``link``), the
bfloat16 search directions and Grams (``lowp``, ``lowp_rd``), Gondzio
correctors, the frozen KKT factor (``kkt_every``) and the dual and paired
warm starts (``z0``, ``warm_sz``). Every KKT factorization goes through
``ops.linalg.kkt_inverse``, which picks kernel A or its plain version by
device; JAX's ``pallas_kkt`` therefore has no counterpart here. The dense
route's KKT matrix in float64 with n >= 64 goes through
``ops.linalg.kkt_gram`` (kernel C on the card, the plain expression on
the CPU); every other route keeps its expression.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .linalg import _bf16, dense_gram, kkt_gram, kkt_inverse

# the dense route's Gram goes to `kkt_gram` (kernel C on the card) from
# this many decision variables up, in float64
KKT_GRAM_MIN_N = 64


class QPSolution(NamedTuple):
    x: torch.Tensor        # (B, n)
    z: torch.Tensor        # (B, m)
    s: torch.Tensor        # (B, m)
    r_p: torch.Tensor      # (B,)
    r_d: torch.Tensor      # (B,)
    gap: torch.Tensor      # (B,)
    success: torch.Tensor  # (B,) bool


def _mv(a, v):
    return (a @ v[..., None])[..., 0]


def _step_len(v, dv, tau=0.995):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v, per row."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(tau * torch.amin(ratio, dim=-1), max=1.0)


def solve_qp(
    p_mat,
    q_vec,
    g_mat,
    h_vec,
    x0: Optional[torch.Tensor] = None,
    iters: int = 30,
    tol: float = 1e-9,
    reg: float = 1e-10,
    lowp: bool = False,
    kkt_every: int = 1,
    struct=None,
    h_tail: Optional[torch.Tensor] = None,
    gondzio: int = 0,
    link=None,
    h_link: Optional[torch.Tensor] = None,
    z0: Optional[torch.Tensor] = None,
    lowp_rd: bool = False,
    warm_sz: bool = False,
) -> QPSolution:
    """Solve a batch of dense QPs: p_mat (B, n, n), q_vec (B, n), g_mat
    (B, m_run, n), h_vec (B, m_run).

    ``lowp``: the search-direction products (rhs, G dx, Gram) use
    bfloat16-rounded G with float32 accumulation; residuals stay exact.
    Ignored for float64. ``struct``/``h_tail``: the static bound/slack rows
    (`mpc.ocp_struct.OCPStruct`) are applied structurally after the
    runtime rows of ``g_mat``; with ``link`` = (acol_u, a_set_joints) and
    ``h_link`` the link-collision rows are applied through their
    factorization too, row order [runtime | link | tail], always exactly.

    ``kkt_every`` > 1 refreshes the factor only when the iteration index is
    a multiple of it; every iteration then refines twice against the
    current KKT operator applied implicitly (P v + G^T (w G v) + reg v).
    ``z0``: the dual warm start, clipped into [1e-6, 1e6] against the cold
    slack; with ``warm_sz`` too, the paired Mehrotra start (s from h - G x0,
    centring shifts). ``warm_sz`` without ``z0`` is the cold start."""
    n = q_vec.shape[-1]
    m_run = h_vec.shape[-1]
    m_link = 0 if link is None else h_link.shape[-1]
    dtype = q_vec.dtype
    dev = q_vec.device
    lowp = lowp and dtype == torch.float32

    if struct is not None:
        h_vec = torch.cat([h_vec] + ([h_link] if link is not None else []) + [h_tail], dim=-1)
    m = h_vec.shape[-1]

    x = torch.zeros_like(q_vec) if x0 is None else x0
    # bf16-rounded copy of G, kept in the working dtype: every product
    # with it is a bf16 x bf16 product accumulated in f32
    g_dir = _bf16(g_mat) if lowp else g_mat
    g_dir_t = g_dir.mT
    g_mat_t = g_mat.mT

    def _structured(v):
        if struct is None:
            return []
        if link is None:
            return [struct.tail_apply(v)]
        return [struct.link_apply(link[0], link[1], v), struct.tail_apply(v)]

    def _structured_t(y):
        if struct is None:
            return 0.0
        if link is None:
            return struct.tail_apply_t(y[..., m_run:])
        return (struct.link_apply_t(link[0], link[1], y[..., m_run:m_run + m_link])
                + struct.tail_apply_t(y[..., m_run + m_link:]))

    def gmv(v):
        run = _mv(g_dir, _bf16(v)) if lowp else _mv(g_mat, v)
        return run if struct is None else torch.cat([run] + _structured(v), dim=-1)

    def gtmv(v):
        run = _mv(g_dir_t, _bf16(v[..., :m_run])) if lowp else _mv(g_mat_t, v[..., :m_run])
        return run + _structured_t(v)

    def gmv_exact(v):
        run = _mv(g_mat, v)
        return run if struct is None else torch.cat([run] + _structured(v), dim=-1)

    def gtmv_exact(v):
        return _mv(g_mat_t, v[..., :m_run]) + _structured_t(v)

    if warm_sz and z0 is not None:
        # paired Mehrotra start: s from the warm point's slack, z from the
        # inherited duals, both shifted into the cone, then the
        # complementarity scale equalized
        s_hat = h_vec - gmv_exact(x)
        z_hat = torch.clamp(z0, 0.0, 1e6)
        d_s = torch.clamp(-1.5 * torch.amin(s_hat, dim=-1), min=0.0)[..., None]
        d_z = torch.clamp(-1.5 * torch.amin(z_hat, dim=-1), min=0.0)[..., None]
        s1 = s_hat + d_s
        z1 = z_hat + d_z
        mu0 = torch.sum(s1 * z1, dim=-1)
        s = s1 + (0.5 * mu0 / torch.clamp(torch.sum(z1, dim=-1), min=1e-12))[..., None]
        z = z1 + (0.5 * mu0 / torch.clamp(torch.sum(s1, dim=-1), min=1e-12))[..., None]
        s = torch.clamp(s, min=1e-8)
        z = torch.clamp(z, min=1e-8)
    else:
        s = torch.clamp(h_vec - gmv_exact(x), min=1.0)
        z = torch.ones_like(s) if z0 is None else torch.clamp(z0, 1e-6, 1e6)
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    def assemble_kkt(w):
        if struct is not None:
            kkt = p_mat + struct.gram_g(g_mat, w[..., :m_run], lowp) + reg * eye_n
            if link is not None:
                kkt = kkt + struct.link_gram(link[0], link[1], w[..., m_run:m_run + m_link])
            return kkt + struct.tail_gram(w[..., m_run + m_link:])
        if dtype == torch.float64 and n >= KKT_GRAM_MIN_N:   # lowp is off in float64
            return kkt_gram(p_mat, g_mat, w, reg)
        return p_mat + dense_gram(g_mat, w, lowp) + reg * eye_n

    tiny = torch.finfo(dtype).tiny
    r_p = gmv_exact(x) + s - h_vec
    done = torch.zeros(q_vec.shape[:-1], dtype=torch.bool, device=dev)

    for it in range(iters):
        r_d = _mv(p_mat, x) + q_vec + (gtmv(z) if lowp_rd else gtmv_exact(z))
        mu = torch.sum(s * z, dim=-1) / m
        w = z / s
        if kkt_every == 1:
            kkt = assemble_kkt(w)
            l_inv = kkt_inverse(kkt.contiguous())
            kkt_mv = lambda v: _mv(kkt, v)
            n_refine = 1
        else:
            # frozen factor: refreshed (a Python branch, so frozen
            # iterations launch no factorization) every kkt_every-th
            # iteration; refinement against the current operator
            if it % kkt_every == 0:
                l_inv = kkt_inverse(assemble_kkt(w).contiguous())
            kkt_mv = lambda v: _mv(p_mat, v) + gtmv(w * gmv(v)) + reg * v
            n_refine = 2
        l_inv_t = l_inv.mT

        def solve_dx(r_c):
            rhs = -r_d + gtmv((r_c - z * r_p) / s)
            dx = _mv(l_inv_t, _mv(l_inv, rhs))
            for _ in range(n_refine):             # refinement sweeps
                resid = rhs - kkt_mv(dx)
                dx = dx + _mv(l_inv_t, _mv(l_inv, resid))
            ds = -r_p - gmv(dx)
            dz = -(r_c + z * ds) / s
            return dx, ds, dz

        # predictor (affine)
        dx_a, ds_a, dz_a = solve_dx(s * z)
        alpha_p = _step_len(s, ds_a)
        alpha_d = _step_len(z, dz_a)
        mu_aff = torch.sum(
            (s + alpha_p[..., None] * ds_a) * (z + alpha_d[..., None] * dz_a), dim=-1
        ) / m
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=tiny)) ** 3, 0.0, 1.0)

        # corrector
        r_c = s * z - (sigma * mu)[..., None] + ds_a * dz_a
        dx, ds, dz = solve_dx(r_c)
        alpha_p = _step_len(s, ds)
        alpha_d = _step_len(z, dz)

        # Gondzio centrality correctors against the same factorization
        mu_t = torch.clamp(sigma * mu, min=tiny)[..., None]
        for _ in range(gondzio):
            a_try_p = torch.clamp(alpha_p + 0.08, max=1.0)[..., None]
            a_try_d = torch.clamp(alpha_d + 0.08, max=1.0)[..., None]
            v_try = (s + a_try_p * ds) * (z + a_try_d * dz)
            t_corr = torch.minimum(torch.maximum(v_try, 0.1 * mu_t), 10.0 * mu_t) - v_try
            dx2, ds2, dz2 = solve_dx(r_c - t_corr)
            a2_p = _step_len(s, ds2)
            a2_d = _step_len(z, dz2)
            better = torch.minimum(a2_p, a2_d) >= torch.minimum(alpha_p, alpha_d)
            bb = better[..., None]
            dx = torch.where(bb, dx2, dx)
            ds = torch.where(bb, ds2, ds)
            dz = torch.where(bb, dz2, dz)
            alpha_p = torch.where(better, a2_p, alpha_p)
            alpha_d = torch.where(better, a2_d, alpha_d)
        alpha = torch.minimum(alpha_p, alpha_d)[..., None]

        x_new = x + alpha * dx
        s_new = torch.clamp(s + alpha * ds, min=1e-14)
        z_new = torch.clamp(z + alpha * dz, min=1e-14)
        r_p_new = (1.0 - alpha) * r_p + (s_new - (s + alpha * ds))

        finite = (
            torch.isfinite(x_new).all(dim=-1)
            & torch.isfinite(s_new).all(dim=-1)
            & torch.isfinite(z_new).all(dim=-1)
            & torch.isfinite(alpha[..., 0])
        )
        keep = (done | ~finite)[..., None]
        x = torch.where(keep, x, x_new)
        s = torch.where(keep, s, s_new)
        z = torch.where(keep, z, z_new)
        r_p = torch.where(keep, r_p, r_p_new)
        done = done | ~finite

        conv = (
            (torch.amax(torch.abs(r_p), dim=-1) < tol)
            & (torch.amax(torch.abs(r_d), dim=-1) < tol)
            & (mu < tol)
        )
        done = done | conv

    r_d = torch.amax(torch.abs(_mv(p_mat, x) + q_vec + gtmv_exact(z)), dim=-1)
    r_p = torch.amax(torch.clamp(gmv_exact(x) - h_vec, min=0.0), dim=-1)
    gap = torch.sum(s * z, dim=-1) / m
    success = (r_p < 1e-6) & (r_d < 1e-4)
    return QPSolution(x=x, z=z, s=s, r_p=r_p, r_d=r_d, gap=gap, success=success)


def solve_projection(g_mat, h_vec, target, iters: int = 30):
    """min |x - target|^2  s.t.  G x <= h, for a batch: g_mat (B, m, n),
    h_vec (B, m), target (B, n)."""
    n = target.shape[-1]
    eye = torch.eye(n, dtype=target.dtype, device=target.device)
    p_mat = (2.0 * eye).expand(target.shape[:-1] + (n, n))
    return solve_qp(p_mat, -2.0 * target, g_mat, h_vec, iters=iters)


def solve_feasibility(g_mat, h_vec, x0=None, iters: int = 30, eps: float = 1e-6):
    """Phase-1: minimize the worst violation t of G x <= h + t, for a batch:
    g_mat (B, m, n), h_vec (B, m), optional warm start x0 (B, n). Returns
    (x (B, n), t (B,), sol): feasible iff t <~ 0.

    The eps-regularization keeps the QP strongly convex; on rows that bound
    neither x nor t, t drifts to -1/(2 eps). Planner callers pad with
    inactive rows (0 x <= 10 + t clamps t >= -10) or carry workspace rows,
    as the JAX package documents."""
    bsz, m, n = g_mat.shape
    dtype, dev = h_vec.dtype, h_vec.device
    p_mat = (torch.eye(n + 1, dtype=dtype, device=dev) * eps).expand(bsz, n + 1, n + 1)
    q_vec = torch.zeros((bsz, n + 1), dtype=dtype, device=dev)
    q_vec[:, n].fill_(1.0)          # fill_: an assignment copies from the host
    g_full = torch.cat([g_mat, -torch.ones((bsz, m, 1), dtype=dtype, device=dev)], dim=-1)
    x0_full = None
    if x0 is not None:
        t0 = torch.amax(_mv(g_mat, x0) - h_vec, dim=-1) + 1.0
        x0_full = torch.cat([x0, t0[:, None]], dim=-1)
    sol = solve_qp(p_mat, q_vec, g_full, h_vec, x0=x0_full, iters=iters)
    return sol.x[:, :n], sol.x[:, n], sol


def solve_line_projection(g_mat, h_vec, p0, p1, iters: int = 30):
    """min |p0 + phi (p1 - p0) - x|^2  s.t.  G x <= h, 0 <= phi <= 1, for a
    batch: g_mat (P, m, 3), h_vec (P, m), p0/p1 (P, 3). Decision y = (x,
    phi). Returns (x (P, 3), phi (P,), sol)."""
    dtype, dev = p0.dtype, p0.device
    bsz = p0.shape[0]
    d = p1 - p0
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dd = torch.sum(d * d, dim=-1)
    top = torch.cat([2.0 * eye3.expand(bsz, 3, 3), (-2.0 * d)[..., None]], dim=-1)
    bottom = torch.cat([-2.0 * d, (2.0 * dd + 1e-9)[..., None]], dim=-1)[:, None, :]
    p_mat = torch.cat([top, bottom], dim=-2)
    q_vec = torch.cat([-2.0 * p0, (2.0 * torch.sum(p0 * d, dim=-1))[..., None]], dim=-1)
    m = h_vec.shape[-1]
    # scalars written with fill_: an assignment would copy each from the host
    phi_rows = torch.zeros((2, 4), dtype=dtype, device=dev)
    phi_rows[0, 3].fill_(1.0)
    phi_rows[1, 3].fill_(-1.0)
    g_full = torch.cat(
        [
            torch.cat([g_mat, torch.zeros((bsz, m, 1), dtype=dtype, device=dev)], dim=-1),
            phi_rows.expand(bsz, 2, 4),
        ],
        dim=-2,
    )
    h_phi = torch.zeros((bsz, 2), dtype=dtype, device=dev)
    h_phi[:, 0].fill_(1.0)
    h_full = torch.cat([h_vec, h_phi], dim=-1)
    sol = solve_qp(p_mat, q_vec, g_full, h_full, iters=iters)
    return sol.x[..., :3], sol.x[..., 3], sol


def solve_qp_admm(
    p_mat,
    q_vec,
    g_mat,
    h_vec,
    x0: Optional[torch.Tensor] = None,
    iters: int = 60,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
) -> QPSolution:
    """OSQP-style ADMM for a batch of  min 0.5 x'Px + q'x  s.t.  Gx <= h:
    p_mat (B, n, n), q_vec (B, n), g_mat (B, m, n), h_vec (B, m).

    Rows are scaled to unit norm; one factorization of P + sigma I + rho
    G'G per call (``kkt_inverse``: kernel A on a CUDA tensor), then
    ``iters`` relaxed sweeps of matrix-vector products. Returns the
    ``QPSolution`` of :func:`solve_qp` with s = h - Gx, z the ADMM dual
    (clipped to >= 0) unscaled, and success r_p < 1e-4."""
    n = q_vec.shape[-1]
    m = h_vec.shape[-1]
    row_norm = torch.sqrt(torch.sum(g_mat * g_mat, dim=-1))
    scale = 1.0 / torch.clamp(row_norm, min=1e-6)
    g_s = g_mat * scale[..., None]
    h_s = h_vec * scale
    g_s_t = g_s.mT

    eye = torch.eye(n, dtype=q_vec.dtype, device=q_vec.device)
    l_inv = kkt_inverse((p_mat + sigma * eye + rho * (g_s_t @ g_s)).contiguous())
    l_inv_t = l_inv.mT

    x = torch.zeros_like(q_vec) if x0 is None else x0
    z = torch.minimum(_mv(g_s, x), h_s)
    y = torch.zeros_like(h_vec)
    for _ in range(iters):
        rhs = sigma * x - q_vec + _mv(g_s_t, rho * z - y)
        x_t = _mv(l_inv_t, _mv(l_inv, rhs))
        x = alpha * x_t + (1.0 - alpha) * x
        gx = _mv(g_s, x)
        z_new = torch.minimum(gx + y / rho, h_s)
        y = torch.clamp(y + rho * (gx - z_new), min=0.0)   # inequality dual cone
        z = z_new

    gx = _mv(g_mat, x)
    s = h_vec - gx
    r_p = torch.amax(torch.clamp(gx - h_vec, min=0.0), dim=-1)
    r_d = torch.amax(torch.abs(_mv(p_mat, x) + q_vec + _mv(g_s_t, y)), dim=-1)
    gap = torch.sum(torch.clamp(s, min=0.0) * y * scale, dim=-1) / m
    return QPSolution(x=x, z=y * scale, s=s, r_p=r_p, r_d=r_d, gap=gap, success=r_p < 1e-4)
