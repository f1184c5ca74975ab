"""Segment-to-polytope closest points: the wrapper of kernel B
(``csrc/line_polytope.cu``), its plain PyTorch version, and the
``seg_poly_closest`` dispatch (port of ``boundplanner_tpu/ops/pallas_proj.py``).

The dispatch rule mirrors the JAX one with the card in the TPU's place:
a CUDA float32 batch runs the Dykstra kernel; every other case (CPU, or
float64) runs the exact 25-iteration IPM, as the JAX package does off the
TPU. The plain Dykstra version therefore serves the tests and the on-card
comparison only.
"""

from __future__ import annotations

import torch

from ._build import check, library

OUTER_ITERS = 10
DYKSTRA_SWEEPS = 4
MAX_ROWS = 16


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


def line_polytope_projection_plain(a, b, p0, p1):
    """Plain version of kernel B: a (P, R, 3), b (P, R), p0/p1 (P, 3) ->
    (x (P, 3), phi (P,), dist (P,)), same loop order and clamps."""
    d = p1 - p0
    denom = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-12)
    a_norm2 = torch.clamp(torch.sum(a * a, dim=-1), min=1e-12)
    x = _dykstra(p0, a, b, a_norm2)
    for _ in range(OUTER_ITERS):
        z, _ = _seg_point(x, p0, d, denom)
        x = _dykstra(z, a, b, a_norm2)
    seg, phi = _seg_point(x, p0, d, denom)
    dist = torch.linalg.vector_norm(x - seg, dim=-1)
    return x, phi[..., 0], dist


def line_polytope_projection(a, b, p0, p1):
    """Closest points between segments and polytopes, one problem per row
    of the leading axis: the plain version on the CPU, kernel B on a CUDA
    tensor (float32 only: every other case takes the exact IPM, see
    ``seg_poly_closest``)."""
    if a.device.type == "cpu":
        return line_polytope_projection_plain(a, b, p0, p1)
    if a.device.type != "cuda":
        raise ValueError(f"line_polytope_projection: unsupported device {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"line_polytope_projection: dtype {a.dtype} (need float32)")
    count, rows = a.shape[0], a.shape[1]
    if a.shape != (count, rows, 3) or b.shape != (count, rows) \
            or p0.shape != (count, 3) or p1.shape != (count, 3):
        raise ValueError("line_polytope_projection: need a (P,R,3), b (P,R), p0/p1 (P,3)")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"line_polytope_projection: {rows} rows (1..{MAX_ROWS})")
    for t in (b, p0, p1):
        if t.device != a.device or t.dtype != a.dtype:
            raise ValueError("line_polytope_projection: mixed devices/dtypes")
    if not all(t.is_contiguous() for t in (a, b, p0, p1)):
        raise ValueError("line_polytope_projection: inputs must be contiguous")
    x = torch.empty_like(p0)
    phi = torch.empty(count, dtype=a.dtype, device=a.device)
    dist = torch.empty_like(phi)
    if count == 0:
        return x, phi, dist
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = library().bp_line_polytope_f32(
            a.data_ptr(), b.data_ptr(), p0.data_ptr(), p1.data_ptr(),
            x.data_ptr(), phi.data_ptr(), dist.data_ptr(), count, rows, stream)
        check(err, "line_polytope")
    line_polytope_projection.launches += 1
    return x, phi, dist


line_polytope_projection.launches = 0


def _seg_closest_ipm(a, b, p0, p1):
    from .qp import solve_line_projection

    x, phi, _ = solve_line_projection(a, b, p0, p1, iters=25)
    return x, phi


def seg_poly_closest(a, b, p0, p1):
    """Closest pair between segments and polytopes on a folded problem axis:
    a (P, R, 3), b (P, R), p0/p1 (P, 3) -> (x (P, 3), phi (P,)). Callers
    fold every scene/link/obstacle axis into P, so a tick is one launch."""
    if a.device.type == "cuda" and a.dtype == torch.float32:
        x, phi, _ = line_polytope_projection(
            a.contiguous(), b.contiguous(), p0.contiguous(), p1.contiguous()
        )
        return x, phi
    return _seg_closest_ipm(a, b, p0, p1)
