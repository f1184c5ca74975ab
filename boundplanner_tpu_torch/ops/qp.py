"""Batched dense convex-QP solver: Mehrotra predictor-corrector IPM
(port of ``solve_qp`` and ``solve_line_projection`` of
``boundplanner_tpu/ops/qp.py``).

Problem form, one per row of the leading batch axis B::

    minimize    0.5 x^T P x + q^T x
    subject to  G x <= h

Iteration is a fixed-trip loop with a per-problem ``done`` mask (no host
sync inside), so a batch stays in lockstep like the JAX ``fori_loop``.
Only the branches the MPC's configuration reaches are ported: the plain
dense form, the structured static tail (``struct``), the bfloat16 search
directions (``lowp``, ``lowp_rd``) and Gondzio correctors. The KKT
factorization always goes through ``ops.linalg.kkt_inverse``, which picks
kernel A or its plain version by device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .linalg import kkt_inverse


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


def _bf16(t):
    """Round to bfloat16 and widen back: the operand of a bf16 product
    with f32 accumulation (JAX's ``preferred_element_type=float32``)."""
    return t.to(torch.bfloat16).to(t.dtype)


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
    runtime rows of ``g_mat``."""
    if kkt_every != 1 or link is not None or z0 is not None or warm_sz:
        raise NotImplementedError(
            "solve_qp: kkt_every>1, link rows and dual warm starts are not ported"
        )
    n = q_vec.shape[-1]
    m_run = h_vec.shape[-1]
    dtype = q_vec.dtype
    dev = q_vec.device
    lowp = lowp and dtype == torch.float32

    if struct is not None:
        h_vec = torch.cat([h_vec, h_tail], dim=-1)
    m = h_vec.shape[-1]

    x = torch.zeros_like(q_vec) if x0 is None else x0
    # bf16-rounded copy of G, kept in the working dtype: every product
    # with it is a bf16 x bf16 product accumulated in f32
    g_dir = _bf16(g_mat) if lowp else g_mat
    g_dir_t = g_dir.mT
    g_mat_t = g_mat.mT

    def _structured(v):
        return [struct.tail_apply(v)] if struct is not None else []

    def _structured_t(y):
        return struct.tail_apply_t(y[..., m_run:]) if struct is not None else 0.0

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

    s = torch.clamp(h_vec - gmv_exact(x), min=1.0)
    z = torch.ones_like(s)
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    def assemble_kkt(w):
        if struct is not None:
            return (
                p_mat
                + struct.gram_g(g_mat, w[..., :m_run], lowp)
                + reg * eye_n
                + struct.tail_gram(w[..., m_run:])
            )
        if lowp:
            gw = (g_dir.to(torch.bfloat16) * w[..., None].to(torch.bfloat16)).to(dtype)
            return p_mat + g_dir_t @ gw + reg * eye_n
        return p_mat + (g_mat_t * w[..., None, :]) @ g_mat + reg * eye_n

    tiny = torch.finfo(dtype).tiny
    r_p = gmv_exact(x) + s - h_vec
    done = torch.zeros(q_vec.shape[:-1], dtype=torch.bool, device=dev)

    for _ in range(iters):
        r_d = _mv(p_mat, x) + q_vec + (gtmv(z) if lowp_rd else gtmv_exact(z))
        mu = torch.sum(s * z, dim=-1) / m
        w = z / s
        kkt = assemble_kkt(w)
        l_inv = kkt_inverse(kkt.contiguous())
        l_inv_t = l_inv.mT

        def solve_dx(r_c):
            rhs = -r_d + gtmv((r_c - z * r_p) / s)
            dx = _mv(l_inv_t, _mv(l_inv, rhs))
            resid = rhs - _mv(kkt, dx)            # one refinement sweep
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
    phi_rows = torch.zeros((2, 4), dtype=dtype, device=dev)
    phi_rows[0, 3] = 1.0
    phi_rows[1, 3] = -1.0
    g_full = torch.cat(
        [
            torch.cat([g_mat, torch.zeros((bsz, m, 1), dtype=dtype, device=dev)], dim=-1),
            phi_rows.expand(bsz, 2, 4),
        ],
        dim=-2,
    )
    h_full = torch.cat(
        [h_vec, torch.tensor([1.0, 0.0], dtype=dtype, device=dev).expand(bsz, 2)], dim=-1
    )
    sol = solve_qp(p_mat, q_vec, g_full, h_full, iters=iters)
    return sol.x[..., :3], sol.x[..., 3], sol
