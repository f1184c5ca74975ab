"""Segment-to-polytope closest points in plain PyTorch: the Dykstra
projection that kernel B computes (copied from the port's
``ops/cuda_proj.py``: 10 outer iterations of 4 sweeps) and the exact
interior-point projection (``ops/qp.py``, 25 iterations)."""

from __future__ import annotations

import torch

OUTER_ITERS = 10
DYKSTRA_SWEEPS = 4


def _seg_point(x, p0, d, denom):
    phi = torch.sum((x - p0) * d, dim=-1, keepdim=True) / denom
    phi = torch.clamp(phi, 0.0, 1.0)
    return p0 + phi * d, phi


def _dykstra(z, a, b, a_norm2):
    y = z
    e = [torch.zeros_like(z) for _ in range(a.shape[-2])]
    for _ in range(DYKSTRA_SWEEPS):
        for r in range(a.shape[-2]):
            w = y + e[r]
            viol = (torch.sum(a[..., r, :] * w, dim=-1) - b[..., r]) / a_norm2[..., r]
            step = torch.clamp(viol, min=0.0)[..., None] * a[..., r, :]
            y = w - step
            e[r] = step
    return y


def line_polytope_dykstra(a, b, p0, p1):
    """a (P, R, 3), b (P, R), p0/p1 (P, 3) -> (x (P, 3), phi (P,))."""
    d = p1 - p0
    denom = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-12)
    a_norm2 = torch.clamp(torch.sum(a * a, dim=-1), min=1e-12)
    x = _dykstra(p0, a, b, a_norm2)
    for _ in range(OUTER_ITERS):
        z, _ = _seg_point(x, p0, d, denom)
        x = _dykstra(z, a, b, a_norm2)
    _, phi = _seg_point(x, p0, d, denom)
    return x, phi[..., 0]


def seg_poly_closest(a, b, p0, p1, route: str):
    """Closest pair between segments and polytopes by ``route``
    (``"dykstra"`` or ``"ipm"``)."""
    if route == "dykstra":
        return line_polytope_dykstra(a, b, p0, p1)
    if route == "ipm":
        from .qp import solve_line_projection

        x, phi, _ = solve_line_projection(a, b, p0, p1, iters=25)
        return x, phi
    raise ValueError(f"unknown closest-point route {route!r}")
