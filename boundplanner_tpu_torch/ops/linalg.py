"""Batched dense linear algebra (port of ``boundplanner_tpu/ops/linalg.py``)
and the wrapper of kernel A (``csrc/chol_inverse.cu``).

``kkt_inverse`` is the IPM's factorization: L^{-1} for a batch of SPD
matrices. On a CPU tensor it runs the plain version below (the masked
column-loop Cholesky + row-loop inversion, the JAX package's own off-TPU
path); on a CUDA tensor it launches kernel A or raises. There is no
fallback between the two.
"""

from __future__ import annotations

import torch

from ._build import check, library

# largest dynamic shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def cholesky_masked(a):
    """Lower Cholesky factor of SPD ``a`` (..., n, n), column-loop form with
    the pivot clamp sqrt(max(d, 1e-30))."""
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


def invert_lower(l):
    """Explicit inverse of lower-triangular ``l`` (..., n, n), row-loop form
    (each step one masked row-times-matrix product). Fills a fresh buffer in
    place, row by row."""
    n = l.shape[-1]
    idx = torch.arange(n, device=l.device)
    eye = torch.eye(n, dtype=l.dtype, device=l.device)
    x = torch.zeros_like(l)
    for j in range(n):
        mask = (idx < j).to(l.dtype)
        s = ((l[..., j, :] * mask)[..., None, :] @ x)[..., 0, :]
        x[..., j, :] = (eye[j] - s) / l[..., j, j, None]
    return x


def kkt_inverse_plain(kkt):
    """Plain PyTorch version of kernel A: L^{-1} of SPD ``kkt`` (..., n, n)."""
    return invert_lower(cholesky_masked(kkt))


def kkt_inverse(kkt):
    """L^{-1} of a batch of SPD matrices (..., n, n): the plain version on
    the CPU, kernel A on a CUDA tensor (f32 or f64). The result is exactly
    lower-triangular."""
    if kkt.device.type == "cpu":
        return kkt_inverse_plain(kkt)
    if kkt.device.type != "cuda":
        raise ValueError(f"kkt_inverse: unsupported device {kkt.device}")
    if kkt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kkt_inverse: dtype {kkt.dtype} (need float32/float64)")
    if kkt.dim() < 2 or kkt.shape[-1] != kkt.shape[-2]:
        raise ValueError(f"kkt_inverse: need (..., n, n), got {tuple(kkt.shape)}")
    if not kkt.is_contiguous():
        raise ValueError("kkt_inverse: input must be contiguous")
    n = kkt.shape[-1]
    if (n * n + n) * kkt.element_size() > _MAX_SMEM:
        raise ValueError(f"kkt_inverse: n={n} exceeds one block's shared memory")
    batch = kkt.numel() // (n * n)
    out = torch.empty_like(kkt)
    if batch == 0:
        return out
    fn = (library().bp_chol_inverse_f32 if kkt.dtype == torch.float32
          else library().bp_chol_inverse_f64)
    with torch.cuda.device(kkt.device):
        stream = torch.cuda.current_stream(kkt.device).cuda_stream
        check(fn(kkt.data_ptr(), out.data_ptr(), batch, n, stream), "chol_inverse")
    kkt_inverse.launches += 1
    return out


kkt_inverse.launches = 0
