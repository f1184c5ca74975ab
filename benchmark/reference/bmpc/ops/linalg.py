"""L^{-1} of a batch of SPD matrices, as the IPM takes it, in plain
PyTorch: the library's Cholesky and triangular solve, and for a matrix
that Cholesky rejects the masked column-loop form with the pivot clamp
sqrt(max(d, 1e-30)) that kernel A computes (copied from the port's
``ops/linalg.py``)."""

from __future__ import annotations

import torch


def cholesky_masked(a):
    """Lower Cholesky factor of ``a`` (..., n, n), column-loop form with the
    pivot clamp."""
    n = a.shape[-1]
    idx = torch.arange(n, device=a.device)
    aa = a.clone()
    for j in range(n):
        d = torch.sqrt(torch.clamp(aa[..., j, j], min=1e-30))[..., None]
        col_below = torch.where(idx > j, aa[..., :, j] / d, 0.0)
        aa = aa - col_below[..., :, None] * col_below[..., None, :]
        new_col = torch.where(idx == j, d, col_below)
        aa[..., :, j] = torch.where(idx >= j, new_col, aa[..., :, j])
    return torch.tril(aa)


def _lower_inverse(l):
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device).expand_as(l)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def kkt_inverse(kkt):
    """L^{-1} of ``kkt`` (..., n, n), in ``kkt``'s dtype."""
    l, info = torch.linalg.cholesky_ex(kkt)
    bad = info != 0
    if bool(bad.any()):
        l = torch.where(bad[..., None, None], cholesky_masked(kkt), l)
    return _lower_inverse(l)
