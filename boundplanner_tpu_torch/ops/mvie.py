"""Batched maximum-volume inscribed ellipsoid (MVIE)
(port of ``boundplanner_tpu/ops/mvie.py``: ``mvie``, ``mvie_fixed_mid``,
``mvie_fixed_r``, ``_chebyshev_center``, ``_solve_barrier``).

The problem

    maximize    log det L
    subject to  ||L^T a_i|| + a_i^T d <= b_i      (ellipsoid {d + L u, |u| <= 1})

is solved by damped Newton steps on a log barrier along a fixed mu
schedule, for a batch of B polytopes at once (leading axis B).

The JAX package takes the Newton step's gradient and Hessian with
``jax.grad``/``jax.hessian``; here they are closed forms of the same
objective (the margins are norms of maps linear in the parameters), which
costs a few dozen batched tensor ops per step instead of an autodiff
graph. The floor ``max(x, 1e-300)`` is chained as autodiff chains it: it
passes the derivative where x > 1e-300, half of it at a tie and none
below. In float32 the literal flushes to 0, as in JAX, so an infeasible
iterate there makes the step NaN and the backtracking keeps the old point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .qp import solve_feasibility


class _Tri(NamedTuple):
    """Index tensors of L's 6 lower-triangular entries (row-major), built on
    the device from no host data, so that a CUDA graph can hold them."""
    rows: torch.Tensor   # [0, 1, 1, 2, 2, 2]
    cols: torch.Tensor   # [0, 0, 1, 0, 1, 2]
    diag: torch.Tensor   # [0, 2, 5]: the diagonal entries
    same: torch.Tensor   # (6, 6) 1 where two entries share a column of L


def _tri(device, dtype) -> _Tri:
    rows, cols = torch.tril_indices(3, 3, device=device)
    i = torch.arange(3, device=device)
    same = (cols[:, None] == cols[None, :]).to(dtype)
    return _Tri(rows, cols, i * (i + 3) // 2, same)


class MVIEResult(NamedTuple):
    shape: torch.Tensor    # S = L L^T, (B, 3, 3)
    center: torch.Tensor   # d, (B, 3)
    gen: torch.Tensor      # L, (B, 3, 3)
    ok: torch.Tensor       # (B,) bool: seed feasible, finite, positive diagonal


def _tri_to_mat(tri, ix: _Tri):
    """(..., 6) lower-triangular entries -> (..., 3, 3)."""
    out = tri.new_zeros(tri.shape[:-1] + (3, 3))
    out[..., ix.rows, ix.cols] = tri
    return out


def _floor_value(dtype) -> float:
    """The literal 1e-300 in ``dtype``: 0 in float32 (it flushes)."""
    return 1e-300 if torch.finfo(dtype).tiny < 1e-300 else 0.0


def _floor(x):
    """max(x, 1e-300) in x's dtype (the literal is 0 in float32)."""
    return torch.clamp(x, min=_floor_value(x.dtype))


def _log_floor_derivs(y):
    """First and second derivative of log(max(y, 1e-300)) in y, chained as
    autodiff does through the max (0 below the floor, half at a tie). At or
    below the floor the second derivative is 0 / floor^2 = 0 / 0 = NaN, as
    in ``jax.hessian``: a Newton step from an infeasible iterate is NaN and
    the backtracking keeps the iterate."""
    c = _floor_value(y.dtype)
    yc = torch.clamp(y, min=c)
    s = (y > c).to(y.dtype) + 0.5 * (y == c).to(y.dtype)
    return s / yc, -(s * s) / (yc * yc)


def _margins(gen, d, a_mat, b_vec):
    """b - A d - ||A L|| per row: gen (B, L, 3, 3), d (B, L, 3) or (B, 1, 3),
    a_mat (B, m, 3), b_vec (B, m) -> (B, L, m)."""
    at = a_mat[:, None] @ gen
    norms = torch.sqrt(torch.sum(at * at, dim=-1) + 1e-14)
    return b_vec[:, None] - (a_mat[:, None] @ d[..., None])[..., 0] - norms


def _barrier_grad_hess(theta, mu, diag_idx, marg, dm, d2m, lb=None):
    """Gradient and Hessian of
        -sum log(max(theta[diag_idx])) - mu sum_i log(max(m_i))
        [- mu log(max(theta_0 - lb))]
    from the margins' values marg (B, m), gradients dm (B, m, K) and
    Hessians d2m (B, m, K, K)."""
    k = theta.shape[-1]
    d1, d2 = _log_floor_derivs(marg)
    g = -mu * torch.einsum("bm,bmk->bk", d1, dm)
    h = -mu * (torch.einsum("bm,bmkl->bkl", d1, d2m)
               + torch.einsum("bm,bmk,bml->bkl", d2, dm, dm))
    e1, e2 = _log_floor_derivs(theta[:, diag_idx])
    g_diag = torch.zeros_like(theta)
    g_diag[:, diag_idx] = -e1
    h_diag = torch.zeros_like(theta)
    h_diag[:, diag_idx] = -e2
    g = g_diag + g
    h = torch.diag_embed(h_diag) + h
    if lb is not None:
        l1, l2 = _log_floor_derivs(theta[:, 0] - lb)
        g[:, 0] = g[:, 0] - mu * l1
        h[:, 0, 0] = h[:, 0, 0] - mu * l2
    return g, h


def _norm_derivs(u, m_cols, mtm):
    """Gradient and Hessian of n = sqrt(|u|^2 + 1e-14) in theta, where
    u = M theta per row: u (B, m, 3), m_cols = M^T u (B, m, K), mtm = M^T M
    (B, m, K, K). grad n = M^T u / n, Hess n = (M^T M - grad grad^T) / n."""
    n = torch.sqrt(torch.sum(u * u, dim=-1) + 1e-14)
    grad = m_cols / n[..., None]
    hess = (mtm - grad[..., :, None] * grad[..., None, :]) / n[..., None, None]
    return n, grad, hess


def _tri_margin_derivs(tri, a_mat, ix: _Tri):
    """Derivatives of ||L^T a_i|| in the 6 entries of L: (B, m, 6) and
    (B, m, 6, 6)."""
    u = a_mat @ _tri_to_mat(tri, ix)                   # rows a_i^T L
    a_rows = a_mat[..., ix.rows]                       # (B, m, 6)
    m_cols = u[..., ix.cols] * a_rows
    mtm = a_rows[..., :, None] * a_rows[..., None, :] * ix.same
    _, grad, hess = _norm_derivs(u, m_cols, mtm)
    return grad, hess


def _solve_barrier(theta0, objective, grad_hess, stages, newton_steps):
    """Damped Newton on f(theta, mu) along mu = 10^-1 .. 10^-stages:
    theta0 (B, K); objective(theta (B, L, K), mu) -> (B, L);
    grad_hess(theta (B, K), mu) -> (g (B, K), H (B, K, K))."""
    dtype, dev = theta0.dtype, theta0.device
    bsz, k = theta0.shape
    rows = torch.arange(bsz, device=dev)
    eye = torch.eye(k, dtype=dtype, device=dev)
    alphas = 2.0 ** -torch.arange(8, dtype=dtype, device=dev)
    mus = 10.0 ** -torch.arange(1, stages + 1, dtype=dtype, device=dev)
    theta = theta0
    for stage in range(stages):
        mu = mus[stage]
        for _ in range(newton_steps):
            g, h = grad_hess(theta, mu)
            step = torch.linalg.solve_ex(h + 1e-9 * eye, g[..., None])[0][..., 0]
            f0 = objective(theta[:, None], mu)[:, 0]
            # backtracking: the best feasible decrease among fixed trials
            cand = theta[:, None, :] - alphas[None, :, None] * step[:, None, :]
            fvals = objective(cand, mu)
            fvals = torch.where(torch.isfinite(fvals), fvals, torch.inf)
            best = torch.argmin(fvals, dim=-1)
            improved = fvals[rows, best] < f0
            theta = torch.where(improved[:, None], cand[rows, best], theta)
    return theta


def _chebyshev_center(a_mat, b_vec, radius: float = 10.0):
    """Deepest point of {A x <= b} for each of B polytopes, by the phase-1
    QP with a +-radius box appended (bounded for degenerate inputs).
    Returns (x (B, 3), margin (B,)) with the margin on the true rows."""
    dtype, dev = b_vec.dtype, b_vec.device
    bsz = b_vec.shape[0]
    eye = torch.eye(3, dtype=dtype, device=dev)
    box_a = torch.cat([eye, -eye]).expand(bsz, 6, 3)
    box_b = torch.full((bsz, 6), radius, dtype=dtype, device=dev)
    x, _, _ = solve_feasibility(torch.cat([a_mat, box_a], dim=1),
                                torch.cat([b_vec, box_b], dim=1))
    margin = torch.amin(b_vec - (a_mat @ x[..., None])[..., 0], dim=-1)
    return x, margin


def _eps0(a_mat, margin0):
    """Initial semi-axis from the seed margin (and the seed's feasibility)."""
    seed_ok = margin0 > 0
    margin0 = torch.clamp(margin0, min=1e-6)
    row_norm = torch.clamp(torch.amax(torch.linalg.vector_norm(a_mat, dim=-1), dim=-1), min=1e-9)
    return 0.5 * margin0 / row_norm, seed_ok


def _diag_positive(theta, idx):
    return torch.isfinite(theta).all(dim=-1) & (theta[:, idx] > 0).all(dim=-1)


def mvie(a_mat, b_vec, d0=None, stages: int = 7, newton_steps: int = 6) -> MVIEResult:
    """Free MVIE of B polytopes a_mat (B, m, 3), b_vec (B, m), seeded at d0
    (B, 3) or at the Chebyshev center."""
    dtype = b_vec.dtype
    if d0 is None:
        d0, margin0 = _chebyshev_center(a_mat, b_vec)
    else:
        zero = a_mat.new_zeros(d0.shape[:1] + (1, 3, 3))
        margin0 = torch.amin(_margins(zero, d0[:, None], a_mat, b_vec)[:, 0], dim=-1)
    eps0, seed_ok = _eps0(a_mat, margin0)
    ix = _tri(d0.device, dtype)
    tri0 = torch.zeros(d0.shape[:1] + (6,), dtype=dtype, device=d0.device)
    tri0[:, ix.diag] = eps0[:, None]
    theta0 = torch.cat([tri0, d0], dim=-1)

    def objective(theta, mu):
        m = _margins(_tri_to_mat(theta[..., :6], ix), theta[..., 6:], a_mat, b_vec)
        diag = theta[..., ix.diag]
        return (-torch.sum(torch.log(_floor(diag)), dim=-1)
                - mu * torch.sum(torch.log(_floor(m)), dim=-1))

    def grad_hess(theta, mu):
        tri, d = theta[:, :6], theta[:, 6:]
        marg = _margins(_tri_to_mat(tri, ix)[:, None], d[:, None], a_mat, b_vec)[:, 0]
        g_n, h_n = _tri_margin_derivs(tri, a_mat, ix)
        dm = torch.cat([-g_n, -a_mat], dim=-1)
        d2m = torch.zeros(dm.shape + (9,), dtype=dtype, device=dm.device)
        d2m[..., :6, :6] = -h_n
        return _barrier_grad_hess(theta, mu, ix.diag, marg, dm, d2m)

    theta = _solve_barrier(theta0, objective, grad_hess, stages, newton_steps)
    l_mat = _tri_to_mat(theta[:, :6], ix)
    return MVIEResult(shape=l_mat @ l_mat.mT, center=theta[:, 6:], gen=l_mat,
                      ok=seed_ok & _diag_positive(theta, ix.diag))


def mvie_fixed_mid(a_mat, b_vec, d_fixed, stages: int = 7, newton_steps: int = 6) -> MVIEResult:
    """MVIE with its center fixed at d_fixed (B, 3)."""
    dtype = b_vec.dtype
    margin0 = torch.amin(b_vec - (a_mat @ d_fixed[..., None])[..., 0], dim=-1)
    eps0, seed_ok = _eps0(a_mat, margin0)
    ix = _tri(d_fixed.device, dtype)
    theta0 = torch.zeros(d_fixed.shape[:1] + (6,), dtype=dtype, device=d_fixed.device)
    theta0[:, ix.diag] = eps0[:, None]
    d_c = d_fixed[:, None]

    def objective(theta, mu):
        m = _margins(_tri_to_mat(theta, ix), d_c, a_mat, b_vec)
        diag = theta[..., ix.diag]
        return (-torch.sum(torch.log(_floor(diag)), dim=-1)
                - mu * torch.sum(torch.log(_floor(m)), dim=-1))

    def grad_hess(theta, mu):
        marg = _margins(_tri_to_mat(theta, ix)[:, None], d_c, a_mat, b_vec)[:, 0]
        g_n, h_n = _tri_margin_derivs(theta, a_mat, ix)
        return _barrier_grad_hess(theta, mu, ix.diag, marg, -g_n, -h_n)

    theta = _solve_barrier(theta0, objective, grad_hess, stages, newton_steps)
    l_mat = _tri_to_mat(theta, ix)
    return MVIEResult(shape=l_mat @ l_mat.mT, center=d_fixed, gen=l_mat,
                      ok=seed_ok & _diag_positive(theta, ix.diag))


def mvie_fixed_r(a_mat, b_vec, d_fixed, r_mat, axis0_lb, stages: int = 7,
                 newton_steps: int = 6) -> MVIEResult:
    """MVIE with fixed center d_fixed (B, 3) and orientation r_mat (B, 3, 3):
    L = R diag(e), with the first semi-axis e_0 >= axis0_lb (B,) held by its
    own barrier term."""
    dtype = b_vec.dtype
    all_idx = torch.arange(3, device=d_fixed.device)
    margin0 = torch.amin(b_vec - (a_mat @ d_fixed[..., None])[..., 0], dim=-1)
    eps0, seed_ok = _eps0(a_mat, margin0)
    e0 = eps0[:, None].expand(-1, 3).clone()
    e0[:, 0] = torch.maximum(eps0, axis0_lb * 1.001)
    d_c = d_fixed[:, None]
    v = a_mat @ r_mat                                   # rows a_i^T R

    def objective(theta, mu):
        m = _margins(r_mat[:, None] @ torch.diag_embed(theta), d_c, a_mat, b_vec)
        lb_margin = theta[..., 0] - axis0_lb[:, None]
        return (-torch.sum(torch.log(_floor(theta)), dim=-1)
                - mu * torch.sum(torch.log(_floor(m)), dim=-1)
                - mu * torch.log(_floor(lb_margin)))

    def grad_hess(theta, mu):
        marg = _margins((r_mat @ torch.diag_embed(theta))[:, None], d_c, a_mat, b_vec)[:, 0]
        u = v * theta[:, None, :]
        _, g_n, h_n = _norm_derivs(u, u * v, torch.diag_embed(v * v))
        return _barrier_grad_hess(theta, mu, all_idx, marg, -g_n, -h_n, lb=axis0_lb)

    theta = _solve_barrier(e0, objective, grad_hess, stages, newton_steps)
    l_mat = r_mat @ torch.diag_embed(theta)
    return MVIEResult(shape=l_mat @ l_mat.mT, center=d_fixed, gen=l_mat,
                      ok=seed_ok & _diag_positive(theta, all_idx))
