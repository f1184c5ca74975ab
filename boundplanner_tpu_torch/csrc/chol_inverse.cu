// Kernel A: batched Cholesky factor + explicit inverse of SPD matrices.
//
// Replaces the Pallas TPU kernel boundplanner_tpu/ops/pallas_chol.py
// `cholesky_inverse` (:386; the `_kernel_il` interleaved schedule, :179-273,
// the one the JAX package runs), reached from boundplanner_tpu/ops/linalg.py
// `kkt_inverse`. For every matrix K of a (B, n, n) batch, f32 or f64,
// row-major, it returns L^{-1}, where L is the lower Cholesky factor with
// the pivot clamp sqrt(max(d, 1e-30)) (a NaN pivot stays NaN, as in the
// plain version). The strict upper triangle of the result is exactly 0:
// the IPM solves with l_inv^T (l_inv rhs) and masks non-finite steps.
//
// What bounds it on the H100: at the main path's (128, 136, 136) f32 the
// card's own bound is 4.2 us of memory traffic (K's lower triangle read
// once, L^{-1} written once, 14.2 MB) against 3.2 us of FP32 work (2n^3/3
// per matrix). One block per matrix cannot reach it: the factorization is
// a chain of n pivots. What a design controls is the length of that chain
// and what each link costs: the number of block barriers, the dependent
// steps between them, and how many threads share the work of each step.
//
// What the design does about it:
// - One block per matrix; the batch of 128 scenes fills 128 of the 132 SMs.
//   The working matrix lives in dynamic shared memory with a row stride of
//   16 bytes times an odd number (ld = ceil8(n) + 4 floats, + 2 doubles), so
//   every row starts on a 16-byte boundary (vector row reads) and the
//   16-byte chunks of 8 consecutive rows fall into 8 different bank groups:
//   column blocks are read row by row without bank conflicts. 87.6 KB in
//   f32, 170.8 KB in f64 at n = 136.
// - Only K's lower triangle is loaded, by one TMA bulk copy per row that
//   completes on an mbarrier: the copy engine moves it, where per-thread
//   16-byte cp.async chunks made the load the longest single phase.
//   K's strict upper triangle is never read: the only upper entries used
//   later (by the inverse's sums) lie in 8 x 8 diagonal blocks, where the
//   rows of D^{-1} write them as zeros, and the store writes the whole
//   strict upper triangle as zeros.
// - Blocked right-looking Cholesky with 8-wide panels (ragged last panel).
//   The 8 x 8 diagonal block D is factored one panel ahead (lookahead): in
//   panel p's update interval the last warp applies panel p's update to
//   block p + 1 and factors it in registers (identity-padded past n; one
//   reciprocal per pivot, then multiplies), off the chain of the other
//   warps. Every thread then reads D from shared memory, and the thread
//   of each row below it solves its 8 panel entries in registers. The
//   trailing update is a rank-8 update of the lower triangle only, in 4 x 4
//   register tiles that read the panel (kept transposed, 16-byte vector
//   loads) once per panel. Each element subtracts the panel's 8 products in
//   pivot order, the plain version's order. Integer division happens once
//   per tile, never in an inner loop.
// - The inverse is blocked and interleaved as `_kernel_il` interleaves it:
//   X block-row p needs only L row-block p and X block-rows < p, so it is
//   formed in the same barrier interval as panel p's trailing update (two
//   independent chains). X_p = -D^{-1} S with S = L_p,<p X_<p. The
//   lookahead warp inverts D (lane l forms row l of D^{-1} by back
//   substitution). Each 8-lane group takes 4 columns of S, its lanes
//   splitting the sum's rows; every lane accumulates an 8 x 4 register tile
//   per row it reads, the group reduces the tiles by shuffles (lane l ends
//   with row l of S) and gathers S's 4 columns to apply row l of D^{-1}.
// - Two barriers per panel (34 at n = 136, against 544 in the column-step
//   kernel this replaces) and two at the start; cudaFuncSetAttribute runs
//   once per type and device, not once per launch.
// - No tensor cores: TF32 keeps 10 mantissa bits, and the IPM's KKT
//   matrices span four decades of interior-point weights, so their
//   condition numbers would eat those bits. The work is 1.7 MFLOP per
//   matrix, which the FP32 cores finish in microseconds; 3xTF32 mma.sync on
//   the trailing update is for a later change, if this one measures
//   compute-bound.
// The TPU's 128-lane batch padding and (n, n, B) transposes are not carried
// over: the layout stays (B, n, n) row-major.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kPanel = 8;                 // panel width
constexpr int kQuad = 4;                  // columns of S per 8-lane group
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;          // 227 KB: one block's dynamic maximum

// Shared-memory layout (mirrored by ops/linalg.py `chol_inverse_smem`):
//   a   n x ld       the working matrix: K -> L -> L^{-1}, in place
//   pan kPanel x n8  the current panel below its diagonal block, transposed
//   lb  n8 x lbs     the current row block of L left of the panel,
//                    transposed; row stride kPanel + 16 bytes, an odd
//                    number of 16-byte chunks (conflict-free row reads)
//   dg  kDiag        the next diagonal block D: its factor (8 x 8, lower
//                    part used), the reciprocal pivots, D^{-1} (8 x 8)
constexpr int kDgInv = kPanel * kPanel, kDgDinv = kDgInv + kPanel;
constexpr int kDiag = kDgDinv + kPanel * kPanel;
template <typename T>
struct Layout {
  int n, n8, ld, lbs;
  __host__ __device__ explicit Layout(int n_)
      : n(n_), n8((n_ + 7) & ~7), ld(((n_ + 7) & ~7) + 16 / static_cast<int>(sizeof(T))),
        lbs(kPanel + 16 / static_cast<int>(sizeof(T))) {}
  __host__ __device__ size_t a_elems() const { return static_cast<size_t>(n) * ld; }
  __host__ __device__ size_t pan_elems() const { return static_cast<size_t>(kPanel) * n8; }
  __host__ __device__ size_t lb_elems() const { return static_cast<size_t>(n8) * lbs; }
  __host__ __device__ size_t bytes() const {
    return (a_elems() + pan_elems() + lb_elems() + kDiag) * sizeof(T);
  }
};

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float root(float v) { return sqrtf(v); }
__device__ __forceinline__ double root(double v) { return sqrt(v); }

// 16-byte shared-memory vectors: 4 floats or 2 doubles
__device__ __forceinline__ void ld16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld16(const double* p, double* x) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ void st16(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st16(double* p, const double* x) {
  *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
}
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, T (&x)[N]) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N / per; ++q) ld16(p + q * per, x + q * per);
}
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const T (&x)[N]) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N / per; ++q) st16(p + q * per, x + q * per);
}

// TMA bulk copies global -> shared, completing on an mbarrier (sm_90)
__device__ __forceinline__ void mbar_init_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, int bytes, unsigned bar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(s), "l"(gmem), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar) {   // phase 0
  asm volatile(
      "{\n.reg .pred p;\nWAIT%=:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT%=;\n}\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_inval(unsigned bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The 8 x 8 lower factor of dl in place (rows past the matrix are
// identity): one reciprocal per pivot, then multiplies.
template <typename T>
__device__ __forceinline__ void factor8(T (&dl)[kPanel][kPanel], T (&inv)[kPanel]) {
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const T v = dl[j][j];
    const T d = root(v < T(1e-30) ? T(1e-30) : v);   // NaN passes through
    const T r = T(1) / d;
    dl[j][j] = d;
    inv[j] = r;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) dl[i][j] *= r;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i)
#pragma unroll
      for (int c = j + 1; c <= i; ++c) dl[i][c] = fmadd(-dl[i][j], dl[c][j], dl[i][c]);
  }
}

// Row l of D^{-1}: D^T y = e_l by back substitution (exactly zero past l).
template <typename T>
__device__ __forceinline__ void inverse_row(const T (&dl)[kPanel][kPanel], const T (&inv)[kPanel],
                                            int l, T (&y)[kPanel]) {
#pragma unroll
  for (int i = kPanel - 1; i >= 0; --i) {
    T t = i == l ? T(1) : T(0);
#pragma unroll
    for (int r = kPanel - 1; r > i; --r) t = fmadd(-dl[r][i], y[r], t);
    y[i] = i <= l ? t * inv[i] : T(0);
  }
}

// One warp factors the diagonal block of rows [k, k + kb) into dg, after
// applying the panel's rank-`updates` update to it (0 or kPanel) in the
// trailing update's order, so it holds what that update would have left
// in `a`. Lane t forms entries (t / 8, t % 8) and (4 + t / 8, t % 8); every
// lane factors the block, lanes 0-7 write the rows of D^{-1}.
template <typename T>
__device__ __forceinline__ void factor_diag(T* dg, const T* a, const T* pan, int ld, int n8,
                                            int k, int kb, int updates, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 4 * h + (lane >> 3), j = lane & 7;
    T v = i == j ? T(1) : T(0);
    if (i < kb && j <= i) {
      v = a[(k + i) * ld + k + j];
      if (updates) {
#pragma unroll
        for (int r = 0; r < kPanel; ++r) v = fmadd(-pan[r * n8 + i], pan[r * n8 + j], v);
      }
    }
    dg[i * kPanel + j] = v;
  }
  __syncwarp();
  T dl[kPanel][kPanel], inv[kPanel], y[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) load_vec(dg + i * kPanel, dl[i]);
  __syncwarp();
  factor8(dl, inv);
  inverse_row(dl, inv, lane & 7, y);
#pragma unroll
  for (int i = 0; i < kPanel; ++i)
    if (lane == i) store_vec(dg + i * kPanel, dl[i]);
  if (lane < kPanel) store_vec(dg + kDgDinv + lane * kPanel, y);
  if (lane == 0) store_vec(dg + kDgInv, inv);
}

// One step of an 8-lane group's reduce-scatter of S's rows. Before it,
// s[b][0, 2W) hold rows base + [0, 2W); lanes l and l ^ W each keep one
// half and add the partner's partial sums of it, so after it s[b][0, W)
// hold rows base + (l & W) + [0, W). After W = 4, 2, 1, s[b][0] holds row
// l summed over the group.
template <int W, typename T>
__device__ __forceinline__ void reduce_half(T (&s)[kQuad][kPanel], int l) {
  const bool hi = (l & W) != 0;
#pragma unroll
  for (int b = 0; b < kQuad; ++b)
#pragma unroll
    for (int jj = 0; jj < W; ++jj) {
      const T send = hi ? s[b][jj] : s[b][jj + W];
      const T keep = hi ? s[b][jj + W] : s[b][jj];
      s[b][jj] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
chol_inverse_kernel(const T* __restrict__ k, T* __restrict__ out, int n, int vec_io) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout<T> lay(n);
  const int ld = lay.ld, n8 = lay.n8, lbs = lay.lbs;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* pan = a + lay.a_elems();            // pan[r * n8 + (i - k1)] = L[i][k0 + r]
  T* lb = pan + lay.pan_elems();         // lb[c * lbs + j] = L[k0 + j][c], c < k0
  T* dg = lb + lay.lb_elems();           // the next diagonal block's factor
  const T* kg = k + static_cast<size_t>(blockIdx.x) * n * n;
  T* og = out + static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const int l = lane & 7;                // lane of an 8-lane group (B1 below)
  const int nb2 = nth - 32;              // threads of the trailing update
  constexpr int per = 16 / sizeof(T);

  // ---- load K's lower triangle: one bulk copy (TMA) per row, of its
  // 16-byte chunks up to the diagonal, completing on an mbarrier (kept in
  // lb, which is free until panel 1). K's strict upper triangle is never
  // read (see the note at the top).
  if (vec_io) {
    const unsigned bar = static_cast<unsigned>(__cvta_generic_to_shared(lb));
    if (tid == 0) {
      const unsigned m = n / per;        // chunks per row; row r copies r / per + 1
      mbar_init_expect(bar, 8u * per * m * (m + 1));
    }
    __syncthreads();
    for (int row = tid; row < n; row += nth)
      bulk_copy(a + row * ld, kg + static_cast<size_t>(row) * n, (row / per + 1) * 16, bar);
    mbar_wait(bar);
    __syncthreads();
    if (tid == 0) mbar_inval(bar);
  } else {
    for (int row = warp; row < n; row += nwarps)
      for (int col = lane; col <= row; col += 32) a[row * ld + col] = kg[row * n + col];
    __syncthreads();
  }
  // the first diagonal block; each later one is factored a panel ahead
  if (warp == nwarps - 1) factor_diag(dg, a, pan, ld, n8, 0, min(kPanel, n), 0, lane);
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int kb = min(kPanel, n - k0);
    const int k1 = k0 + kb;

    // ---- A. the diagonal block's factor D (rows >= kb: identity), its
    // reciprocal pivots and row l of D^{-1}, from dg
    T dl[kPanel][kPanel], inv[kPanel], dinv[kPanel];
#pragma unroll
    for (int i = 0; i < kPanel; ++i) load_vec(dg + i * kPanel, dl[i]);
    load_vec(dg + kDgInv, inv);
    load_vec(dg + kDgDinv + l * kPanel, dinv);
    // the panel below the diagonal block: one thread per row (kb == kPanel
    // here: only the last panel is ragged, and nothing lies below it)
    for (int i = k1 + tid; i < n; i += nth) {
      T x[kPanel];
      load_vec(a + i * ld + k0, x);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        x[j] *= inv[j];
#pragma unroll
        for (int c = j + 1; c < kPanel; ++c) x[c] = fmadd(-x[j], dl[c][j], x[c]);
      }
      store_vec(a + i * ld + k0, x);
#pragma unroll
      for (int r = 0; r < kPanel; ++r) pan[r * n8 + (i - k1)] = x[r];
    }
    // stage L row block [k0, k1) left of the panel for the inverse below
    for (int c = tid; c < k0; c += nth) {
      T x[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) x[j] = j < kb ? a[(k0 + j) * ld + c] : T(0);
      store_vec(lb + c * lbs, x);
    }
    __syncthreads();

    // ---- B0. lookahead, in the last warp: the next diagonal block, updated
    // by this panel and factored into dg while the rest of the block runs
    // B1 and B2 (dg was read before the barrier above)
    if (warp == nwarps - 1 && k1 < n)
      factor_diag(dg, a, pan, ld, n8, k1, min(kPanel, n - k1), kPanel, lane);

    // ---- B1. X block-row [k0, k1) = -D^{-1} S on columns c < k0, with
    // S[j][c] = sum_{c <= r < k0} L[k0 + j][r] X[r][c] (X[r][c] = 0 for r < c),
    // and D^{-1} on the diagonal block. Each warp takes 16 columns at a
    // time, its 8-lane groups 4 columns [c0, c0 + 4) each, lane l the rows
    // r = c0 + l + 8t.
    for (int w0 = kQuad * 4 * warp; w0 < k0; w0 += kQuad * 4 * nwarps) {
      const int c0 = w0 + kQuad * (lane >> 3);
      T s[kQuad][kPanel];
#pragma unroll
      for (int b = 0; b < kQuad; ++b)
#pragma unroll
        for (int j = 0; j < kPanel; ++j) s[b][j] = T(0);
      for (int r = c0 + l; r < k0; r += kPanel) {
        T x[kQuad], lr[kPanel];
        load_vec(a + r * ld + c0, x);
        load_vec(lb + r * lbs, lr);
#pragma unroll
        for (int b = 0; b < kQuad; ++b)
#pragma unroll
          for (int j = 0; j < kPanel; ++j) s[b][j] = fmadd(lr[j], x[b], s[b][j]);
      }
      // reduce-scatter over the group: s[b][0] becomes S[l][c0 + b]
      reduce_half<4>(s, l);
      reduce_half<2>(s, l);
      reduce_half<1>(s, l);
      T x[kQuad];
#pragma unroll
      for (int b = 0; b < kQuad; ++b) x[b] = T(0);
#pragma unroll
      for (int i = 0; i < kPanel; ++i)
#pragma unroll
        for (int b = 0; b < kQuad; ++b)
          x[b] = fmadd(-dinv[i], __shfl_sync(0xffffffffu, s[b][0], i, kPanel), x[b]);
      if (c0 < k0 && l < kb) store_vec(a + (k0 + l) * ld + c0, x);
    }
    if (tid < kPanel && l < kb) store_vec(a + (k0 + l) * ld + k0, dinv);

    // ---- B2. rank-8 update of the trailing lower triangle below the next
    // diagonal block (tiles 0-2, done in B0), 4 x 4 tiles (a diagonal tile
    // also updates its upper part, which nothing reads)
    if (k1 < n) {
      const int nt = (n - k1 + 3) >> 2;
      const int tiles = nt * (nt + 1) / 2;
      for (int tile = 3 + nb2 - 1 - tid; tid < nb2 && tile < tiles; tile += nb2) {
        int bi = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
        while (bi * (bi + 1) / 2 > tile) --bi;
        while ((bi + 1) * (bi + 2) / 2 <= tile) ++bi;
        const int bj = tile - bi * (bi + 1) / 2;
        const int i0 = k1 + 4 * bi, c0 = k1 + 4 * bj;
        T acc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q < n) {
            load_vec(a + (i0 + q) * ld + c0, acc[q]);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[q][b] = T(0);
          }
        }
#pragma unroll
        for (int r = 0; r < kPanel; ++r) {
          T pr[4], pc[4];
          load_vec(pan + r * n8 + 4 * bi, pr);
          load_vec(pan + r * n8 + 4 * bj, pc);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[q][b] = fmadd(-pr[q], pc[b], acc[q][b]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i0 + q < n) store_vec(a + (i0 + q) * ld + c0, acc[q]);
      }
    }
    __syncthreads();
  }

  // ---- store L^{-1}, its strict upper triangle as zeros
  if (vec_io) {
    const int chunks = n / per;
    for (int row = warp; row < n; row += nwarps)
      for (int q = lane; q < chunks; q += 32) {
        T x[per];
        ld16(a + row * ld + q * per, x);
#pragma unroll
        for (int e = 0; e < per; ++e)
          if (q * per + e > row) x[e] = T(0);
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float4*>(og + static_cast<size_t>(row) * n + q * per) =
              make_float4(x[0], x[1], x[2], x[3]);
        } else {
          *reinterpret_cast<double2*>(og + static_cast<size_t>(row) * n + q * per) =
              make_double2(x[0], x[1]);
        }
      }
  } else {
    for (int row = warp; row < n; row += nwarps)
      for (int col = lane; col < n; col += 32)
        og[row * n + col] = col <= row ? a[row * ld + col] : T(0);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

constexpr int kMaxDevices = 64;

template <typename T>
int launch(const T* k, T* out, int batch, int n, cudaStream_t stream) {
  // once per type and device (the attribute belongs to the device's
  // context): allow the largest dynamic shared memory; each launch asks
  // only for its own layout's size
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static std::once_flag once[kMaxDevices];
  static cudaError_t attr[kMaxDevices];
  std::call_once(once[device], [device] {
    attr[device] = cudaFuncSetAttribute(chol_inverse_kernel<T>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  if (attr[device] != cudaSuccess) return static_cast<int>(attr[device]);
  const size_t smem = Layout<T>(n).bytes();
  if (n < 1 || smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = n <= 32 ? 64 : kMaxThreads;
  const int vec_io = (n * static_cast<int>(sizeof(T))) % 16 == 0 && aligned16(k) && aligned16(out);
  chol_inverse_kernel<T><<<batch, threads, smem, stream>>>(k, out, n, vec_io);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bp_chol_inverse_f32(const float* k, float* out, int batch, int n,
                                   void* stream) {
  return launch<float>(k, out, batch, n, static_cast<cudaStream_t>(stream));
}

extern "C" int bp_chol_inverse_f64(const double* k, double* out, int batch,
                                   int n, void* stream) {
  return launch<double>(k, out, batch, n, static_cast<cudaStream_t>(stream));
}
