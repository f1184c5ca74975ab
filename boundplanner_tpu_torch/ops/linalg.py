"""Batched dense linear algebra (port of ``boundplanner_tpu/ops/linalg.py``:
the masked Cholesky, triangular solves and inverses, their blocked forms),
the IPM's Gram, and the wrappers of kernel A (``csrc/chol_inverse.cu``)
and kernel C (``csrc/kkt_gram.cu``). Every function takes matrices (..., n,
n) with any leading batch dimensions, except ``kkt_gram`` (one batch axis).

``kkt_inverse`` is the IPM's factorization: L^{-1} for a batch of SPD
matrices. On a CPU tensor it runs the plain version below (the masked
column-loop Cholesky + row-loop inversion, the JAX package's own off-TPU
path); on a CUDA tensor it launches kernel A or raises. ``kkt_gram`` is
the dense IPM's KKT matrix P + G^T diag(w) G + reg I in float64: the plain
expression on a CPU tensor, kernel C on a CUDA tensor. There is no
fallback between the two routes of either.
"""

from __future__ import annotations

import functools

import torch

from ._build import check, library

# largest dynamic shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448
PANEL = 8


def chol_inverse_smem(n: int, itemsize: int) -> int:
    """Bytes of shared memory kernel A's block takes for one n x n matrix
    (``Layout`` in ``csrc/chol_inverse.cu``): the working matrix with a
    padded row stride (ceil8(n) plus 16 bytes), the transposed panel (8 x
    ceil8(n)), the transposed row block (ceil8(n) rows of 8 plus 16 bytes)
    and the next diagonal block's factor, reciprocal pivots and inverse
    (136 values). n = 136: 87,584 bytes in float32, 170,816 in float64."""
    n8 = -(-n // PANEL) * PANEL
    pad = 16 // itemsize
    diag = 2 * PANEL * PANEL + PANEL
    return (n * (n8 + pad) + PANEL * n8 + n8 * (PANEL + pad) + diag) * itemsize


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


def solve_lower(l, b):
    """Solve L y = b with L lower-triangular (..., n, n), b (..., n):
    forward substitution, one masked dot product per row."""
    n = b.shape[-1]
    idx = torch.arange(n, device=b.device)
    y = torch.zeros_like(b)
    for j in range(n):
        mask = (idx < j).to(b.dtype)
        s = (l[..., j, :] * mask * y).sum(-1)
        y[..., j] = (b[..., j] - s) / l[..., j, j]
    return y


def solve_upper_t(l, b):
    """Solve L^T x = b (back substitution over the lower factor)."""
    n = b.shape[-1]
    idx = torch.arange(n, device=b.device)
    x = torch.zeros_like(b)
    for j in range(n - 1, -1, -1):
        mask = (idx > j).to(b.dtype)
        s = (l[..., :, j] * mask * x).sum(-1)
        x[..., j] = (b[..., j] - s) / l[..., j, j]
    return x


def chol_solve(l, b):
    """Solve (L L^T) x = b given the factor."""
    return solve_upper_t(l, solve_lower(l, b))


def spd_solve(a, b):
    """Solve the SPD system a x = b through the masked Cholesky (pivot clamp
    1e-30)."""
    return chol_solve(cholesky_masked(a), b)


def _factor_panel(p, nb: int):
    """Factor the nb columns of the panel (..., n-k, nb) (rows k.. of
    columns k..k+nb), column loop with masked updates."""
    rows = torch.arange(p.shape[-2], device=p.device)
    cols = torch.arange(nb, device=p.device)
    p = p.clone()
    for jj in range(nb):
        d = torch.sqrt(torch.clamp(p[..., jj, jj], min=1e-30))[..., None]
        col = torch.where(rows > jj, p[..., :, jj] / d, 0.0)
        row = torch.where(cols > jj, p[..., jj, :] / d, 0.0)
        p = p - col[..., :, None] * row[..., None, :]
        new_col = torch.where(rows == jj, d, col)
        p[..., :, jj] = torch.where(rows >= jj, new_col, p[..., :, jj])
    return p


def blocked_cholesky(a, nb: int = 34):
    """Blocked right-looking Cholesky of SPD ``a`` (..., n, n): each panel
    of nb columns by the column loop, the trailing block by one matmul.
    n must be divisible by nb."""
    n = a.shape[-1]
    if n % nb:
        raise ValueError(f"blocked_cholesky: n={n} not divisible by nb={nb}")
    a = a.clone()
    for k in range(0, n, nb):
        panel = _factor_panel(a[..., k:, k:k + nb], nb)
        a[..., k:, k:k + nb] = panel
        if k + nb < n:
            l21 = panel[..., nb:, :]
            a[..., k + nb:, k + nb:] -= l21 @ l21.mT
    return torch.tril(a)


def blocked_invert_lower(l, nb: int = 34):
    """Blocked inverse of lower-triangular ``l`` (..., n, n): the diagonal
    blocks by the row loop, then X_ik = -inv(L_ii) sum_j L_ij X_jk by
    matmuls. n must be divisible by nb."""
    n = l.shape[-1]
    if n % nb:
        raise ValueError(f"blocked_invert_lower: n={n} not divisible by nb={nb}")
    nblk = n // nb
    blk = lambda t, i, k: t[..., i * nb:(i + 1) * nb, k * nb:(k + 1) * nb]
    diag_inv = [invert_lower(blk(l, i, i)) for i in range(nblk)]
    x = torch.zeros_like(l)
    for i in range(nblk):
        blk(x, i, i)[...] = diag_inv[i]
    for k in range(nblk):
        for i in range(k + 1, nblk):
            acc = torch.zeros_like(diag_inv[0])
            for j in range(k, i):
                acc = acc + blk(l, i, j) @ blk(x, j, k)
            blk(x, i, k)[...] = -diag_inv[i] @ acc
    return x


def kkt_inverse_plain(kkt):
    """Plain PyTorch version of kernel A: L^{-1} of SPD ``kkt`` (..., n, n)."""
    return invert_lower(cholesky_masked(kkt))


_ENTRY = {torch.float32: "bp_chol_inverse_f32", torch.float64: "bp_chol_inverse_f64"}


def kkt_inverse(kkt):
    """L^{-1} of a batch of SPD matrices (..., n, n): the plain version on
    the CPU, kernel A on a CUDA tensor (f32 or f64). The result is exactly
    lower-triangular."""
    device = kkt.device
    if device.type == "cpu":
        return kkt_inverse_plain(kkt)
    if device.type != "cuda":
        raise ValueError(f"kkt_inverse: unsupported device {device}")
    entry = _ENTRY.get(kkt.dtype)
    if entry is None:
        raise TypeError(f"kkt_inverse: dtype {kkt.dtype} (need float32/float64)")
    shape = kkt.shape
    if len(shape) < 2 or shape[-1] != shape[-2]:
        raise ValueError(f"kkt_inverse: need (..., n, n), got {tuple(shape)}")
    if not kkt.is_contiguous():
        raise ValueError("kkt_inverse: input must be contiguous")
    n = shape[-1]
    if chol_inverse_smem(n, kkt.element_size()) > _MAX_SMEM:
        raise ValueError(f"kkt_inverse: n={n} exceeds one block's shared memory")
    out = torch.empty_like(kkt)
    batch = kkt.numel() // (n * n)
    if batch == 0:
        return out
    fn = getattr(library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(kkt.data_ptr(), out.data_ptr(), batch, n, stream), "chol_inverse")
    kkt_inverse.launches += 1
    return out


kkt_inverse.launches = 0


def _bf16(t):
    """Round to bfloat16 and widen back: the operand of a bf16 product
    with f32 accumulation (JAX's ``preferred_element_type=float32``)."""
    return t.to(torch.bfloat16).to(t.dtype)


def dense_gram(g_mat, w, lowp: bool = False):
    """G^T diag(w) G for a batch: g_mat (B, m, n), w (B, m). ``lowp``: G
    and w rounded to bfloat16, the rest in float32. That is what the JAX
    package's jitted ``g16 * w.astype(bf16)`` computes: XLA fuses the
    product into float32 and never rounds it back to bfloat16 (excess
    precision; only eager JAX rounds it)."""
    if lowp:
        g16 = _bf16(g_mat)
        return g16.mT @ (g16 * _bf16(w)[..., None])
    return (g_mat.mT * w[..., None, :]) @ g_mat


def kkt_gram_plain(p_mat, g_mat, w, reg: float):
    """Plain PyTorch version of kernel C: P + G^T diag(w) G + reg I."""
    eye = torch.eye(p_mat.shape[-1], dtype=p_mat.dtype, device=p_mat.device)
    return p_mat + dense_gram(g_mat, w) + reg * eye


# kernel C's geometry (csrc/kkt_gram.cu): rows of G a stage, 16 x 8 tiles
# of the lower triangle a block; the fewest rows a split of the rows takes
GRAM_STAGE_ROWS = 32
GRAM_BLOCK_TILES = 96
GRAM_SPLIT_MIN_ROWS = 64


def gram_tiles(n: int) -> int:
    """The 16 x 8 tiles of an n x n lower triangle (89 at n = 136)."""
    return sum(min(2 * i + 2, -(-n // 8)) for i in range(-(-n // 16)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kkt_gram_splits(batch: int, m: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, rows a split) of kernel C's launch: one block per scene and
    tile group where that fills the card's ``sms`` SMs; at smaller batches
    the rows are split into at most sms / blocks ranges, and no more than
    ranges of GRAM_SPLIT_MIN_ROWS rows would make (each a multiple of
    GRAM_STAGE_ROWS rows, none empty), whose partials a second pass sums.
    On 132 SMs, (128, 2439, 136): (1, 2464); (1, 2439, 136): (39, 64)."""
    blocks = batch * -(-gram_tiles(n) // GRAM_BLOCK_TILES)
    splits = max(1, min(sms // blocks, -(-m // GRAM_SPLIT_MIN_ROWS)))
    rows = -(-max(m, 1) // splits)
    rows = -(-rows // GRAM_STAGE_ROWS) * GRAM_STAGE_ROWS
    return -(-max(m, 1) // rows), rows


def kkt_gram(p_mat, g_mat, w, reg: float):
    """K = P + G^T diag(w) G + reg I for a batch: p_mat (B, n, n)
    symmetric, g_mat (B, m, n), w (B, m), all float64 on one device; P and
    w contiguous, G with unit stride along its columns or its rows (the
    dense route's forward-mode Jacobian arrives with strides (m, 1, B m)).
    The plain expression (`kkt_gram_plain`) on the CPU, kernel C on a CUDA
    tensor; K is then exactly symmetric (its lower triangle mirrored, P's
    lower triangle read). ``launches`` counts kernel C's calls (one launch
    each, and a second pass where the rows are split)."""
    if g_mat.dim() != 3 or p_mat.dim() != 3 or w.dim() != 2:
        raise ValueError("kkt_gram: need p (B, n, n), g (B, m, n), w (B, m)")
    bsz, m, n = g_mat.shape
    if tuple(p_mat.shape) != (bsz, n, n) or tuple(w.shape) != (bsz, m):
        raise ValueError(f"kkt_gram: shapes p {tuple(p_mat.shape)}, g {tuple(g_mat.shape)}, "
                         f"w {tuple(w.shape)} do not match")
    if not p_mat.dtype == g_mat.dtype == w.dtype == torch.float64:
        raise TypeError(f"kkt_gram: dtypes {p_mat.dtype}, {g_mat.dtype}, {w.dtype} "
                        "(need float64)")
    device = g_mat.device
    if p_mat.device != device or w.device != device:
        raise ValueError("kkt_gram: tensors on different devices")
    if not (p_mat.is_contiguous() and w.is_contiguous()):
        raise ValueError("kkt_gram: p and w must be contiguous")
    if g_mat.stride(2) != 1 and g_mat.stride(1) != 1:
        raise ValueError(f"kkt_gram: g's strides {g_mat.stride()} have no unit stride")
    if device.type == "cpu":
        return kkt_gram_plain(p_mat, g_mat, w, reg)
    if device.type != "cuda":
        raise ValueError(f"kkt_gram: unsupported device {device}")
    out = torch.empty_like(p_mat)
    if bsz == 0 or n == 0:
        return out
    splits, rows = kkt_gram_splits(bsz, m, n, _sm_count(device.index))
    part = torch.empty((bsz, splits, n, n) if splits > 1 else (0,), dtype=out.dtype,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        check(library().bp_kkt_gram_f64(p_mat.data_ptr(), g_mat.data_ptr(), w.data_ptr(),
                                        float(reg), out.data_ptr(), part.data_ptr(),
                                        *g_mat.stride(), bsz, m, n, splits, rows, stream),
              "kkt_gram")
    kkt_gram.launches += 1
    return out


kkt_gram.launches = 0
