// Kernel C: the dense IPM's KKT matrix K = P + G^T diag(w) G + reg I for a
// batch of QPs, float64.
//
// It replaces no TPU kernel: the JAX package leaves this product to XLA
// (boundplanner_tpu/ops/qp.py `solve_qp`, `assemble_kkt` on the dense
// route). It was added because on the card the same expression in PyTorch
// (`(g.mT * w) @ g`, then `+ P`, then `+ reg I`) is four kernels: a strided,
// non-vectorised copy of G scaled by w, a batched GEMM that reads both
// copies again, and two additions. At the float64 fleet's (128, 2439, 136)
// they took ~1.15 ms a call, 300 calls a tick, about 40 % of the tick.
// Reached from boundplanner_tpu_torch/ops/linalg.py `kkt_gram`, which
// `solve_qp` calls on the dense route in float64 for n >= 64.
//
// Inputs: G (B, m, n) with unit stride along its columns (row-major scenes)
// or along its rows (the forward-mode Jacobian's layout on the dense route,
// strides (m, 1, B m)), any other strides given; w (B, m) and P (B, n, n)
// contiguous, P symmetric (its lower triangle is read). Output K (B, n, n),
// whole and exactly symmetric: every entry of the lower triangle is computed
// once and written to both (i, j) and (j, i).
//
// What bounds it on the H100: at (128, 2439, 136) the work is G read once
// (340 MB), w and P in and K out (40 MB), 0.113 ms at 3.35 TB/s; and the
// lower triangle's 2 m n (n + 1) / 2 operations a matrix, 5.8 GFLOP, 0.087
// ms on the float64 tensor cores at 67 TFLOP/s. Bytes and operations are
// nearly balanced, so the design has to stream G at the card's bandwidth
// and keep the tensor cores fed from shared memory at the same time.
//
// What the design does about it:
// - G is read from device memory exactly once. A block streams its scene's
//   rows in stages of kRows rows (with their weights) through a ring of
//   kStages shared-memory buffers by cp.async (16-byte pieces where the rows
//   allow it, consecutive threads on G's unit-stride axis), kStages - 1
//   stages in flight while the products run on the oldest. A stage keeps
//   G's layout: row-major scenes as rows of the stage, the Jacobian's layout
//   as its columns (a template parameter), so the copy is a straight one.
//   The scaling by w happens on the way from shared memory into the
//   product's A operand: no G w copy exists anywhere.
// - Only the lower triangle's tiles are computed: 16 x 8 tiles (row block
//   i, column block j) with 8 j <= 16 i + 15, 89 at n = 136. Each of the
//   block's 8 warps owns a contiguous run of at most kMaxTiles of them and
//   keeps their sums in registers for the whole stream; a warp's run spans
//   one to three row blocks, so its A operand is loaded once per row block
//   and mma. Blocks past 96 tiles (n > 144) split the tiles into groups,
//   one block each (G is then read once per group).
// - Products in full float64 on the tensor cores: mma.sync m16n8k16 .f64
//   (sm_90's deepest double-precision shape: with 16 warps a block,
//   m16n8k4 took 0.278 ms and m16n8k8 0.253 ms at (128, 2439, 136) against
//   its 0.234), one rounding of G w per entry as in the plain version, then
//   the tensor core's float64 multiply-adds. No TF32 or lower precision.
// - 8 warps a block, one block an SM at the fleet's batch: 12 and 16 warps
//   a block, 3, 5 or 6 stages and stages of 16 rows measured no faster.
//   The kernel takes 0.224 ms at (128, 2439, 136) on an H100 at 700 W,
//   half its bound: the tensor cores run at about half their peak while
//   the stream runs at half the card's bandwidth.
// - In the column layout a stage's leading dimension is kRows + 2 doubles:
//   each lane reads its four adjacent rows of a column with two 16-byte
//   loads, and the 8 lanes of a load's wavefront fall on distinct banks.
//   Row-major stages take ceil16(n) + 2 (16-byte rows for the copies).
//   The padding (zero) feeds only entries of K past n, never written.
// - The epilogue adds P (lower triangle) and reg on the diagonal, in the
//   plain version's order (P + gram, then + reg), and writes each entry
//   and its mirror.
// - At small batches one block per scene leaves most of the 132 SMs idle:
//   the wrapper then splits the rows into `splits` ranges (a count chosen
//   from the batch and the SM count), each block writes its partial lower
//   triangle to a scratch buffer, and a second pass sums the partials in a
//   fixed order and writes K. No atomics: two launches on the same inputs
//   are equal bit for bit, eager or replayed from a graph.
// - It allocates nothing, launches on the given stream, never synchronises
//   and returns cudaGetLastError(), so a CUDA graph captures it.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                 // rows of G a stage
constexpr int kStages = 4;                // the ring of stages
constexpr int kMaxTiles = 12;             // 16 x 8 tiles a warp
constexpr int kK = 16;                    // rows of G an mma takes
constexpr int kV = kK / 4;                // of which a lane holds kV, adjacent
constexpr int kGroupTiles = kWarps * kMaxTiles;
constexpr int kMaxSmem = 232448;          // 227 KB: one block's dynamic maximum
constexpr int kSumThreads = 256;

// a stage's leading dimension and size in doubles (G's block, then w)
template <bool kCol>
__host__ __device__ inline int stride_of(int n) {
  return (kCol ? kRows : (n + 15) & ~15) + 2;
}
template <bool kCol>
__host__ __device__ inline int stage_elems(int n) {
  return (kCol ? ((n + 15) & ~15) : kRows) * stride_of<kCol>(n) + kRows;
}
__host__ __device__ inline int row_tiles(int i, int n) {   // tiles of row block i
  const int cb = (n + 7) / 8;
  return 2 * i + 2 < cb ? 2 * i + 2 : cb;
}
__host__ __device__ inline int lower_tiles(int n) {
  int t = 0;
  for (int i = 0; i < (n + 15) / 16; ++i) t += row_tiles(i, n);
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// copies of `size` bytes, zero-filled past `src_bytes` (0: the whole piece)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A B for one 16 x 8 tile over kK = 16 rows of G: A (16 x 16) holds
// (G w)^T, B (16 x 8) holds G. Lane (group g = lane / 4, t = lane % 4)
// holds A's rows g and g + 8 at the depths t + 4 v (lo[v], hi[v]), B's
// column g at the same depths (b[v]), and d[0..1] = D[g][2t..2t+1], d[2..3]
// = D[g + 8][2t..2t+1]. Which row of G a depth stands for is the caller's
// choice, the same for A and B: lane t takes rows 4 t .. 4 t + 3, so its
// four values of a stage column are adjacent (two 16-byte loads).
__device__ __forceinline__ void mma(double (&d)[4], const double (&lo)[4],
                                    const double (&hi)[4], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(lo[0]), "d"(hi[0]), "d"(lo[1]), "d"(hi[1]), "d"(lo[2]), "d"(hi[2]), "d"(lo[3]),
        "d"(hi[3]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// a lane's kV consecutive rows of a stage column: 16-byte loads where the
// rows are adjacent (kCol), else one load a row (`step` apart)
template <bool kCol>
__device__ __forceinline__ void load_rows(double (&x)[kV], const double* p, int step) {
  if (kCol) {
#pragma unroll
    for (int v = 0; v < kV; v += 2) {
      const double2 q = *reinterpret_cast<const double2*>(p + v);
      x[v] = q.x;
      x[v + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int v = 0; v < kV; ++v) x[v] = p[v * step];
  }
}

// One stage: rows [r0, r0 + kRows) of the scene's G (element (r, i) at
// gb[r sr + i si]) and w into `sg` and `sw`: entry (row, i) of the stage at
// sg[row ld + i] (row-major) or sg[i ld + row] (kCol); rows at or past
// r_end are zero-filled.
template <bool kCol>
__device__ __forceinline__ void load_stage(double* sg, double* sw, const double* gb,
                                           const double* wb, long long sr, long long si,
                                           int r0, int r_end, int n, int ld, int vec, int tid) {
  if (kCol) {            // sr == 1: 16 consecutive threads copy a column's rows
    for (int q = tid; q < kRows * n; q += kThreads) {
      const int i = q / kRows, row = q % kRows;
      const bool valid = r0 + row < r_end;
      cp_async8(sg + i * ld + row, gb + i * si + (valid ? r0 + row : 0), valid ? 8 : 0);
    }
  } else if (vec) {      // si == 1, rows 16-byte aligned: 2 doubles a copy
    const int per_row = n / 2;
    for (int q = tid; q < kRows * per_row; q += kThreads) {
      const int row = q / per_row, col = 2 * (q - row * per_row);
      const bool valid = r0 + row < r_end;
      cp_async16(sg + row * ld + col, gb + (valid ? r0 + row : 0) * sr + col, valid ? 16 : 0);
    }
  } else {
    for (int q = tid; q < kRows * n; q += kThreads) {
      const int row = q / n, col = q - row * n;
      const bool valid = r0 + row < r_end;
      cp_async8(sg + row * ld + col, gb + (valid ? r0 + row : 0) * sr + col * si,
                valid ? 8 : 0);
    }
  }
  if (tid < kRows) {
    const bool valid = r0 + tid < r_end;
    cp_async8(sw + tid, wb + (valid ? r0 + tid : 0), valid ? 8 : 0);
  }
}

// grid: x = scene * splits + split, y = tile group; 256 threads. With one
// split the block writes K; with more it writes its partial lower triangle
// to part[scene][split] (n x n, row-major). G's element (b, r, i) is at
// g[b sb + r sr + i si]; kCol: sr == 1.
template <bool kCol>
__global__ void __launch_bounds__(kThreads, 1)
kkt_gram_kernel(const double* __restrict__ p, const double* __restrict__ g,
                const double* __restrict__ w, double reg, double* __restrict__ out,
                double* __restrict__ part, long long sb, long long sr, long long si, int m,
                int n, int splits, int rows_per_split, int vec) {
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int b = blockIdx.x / splits, split = blockIdx.x - b * splits;
  const int ld = stride_of<kCol>(n), se = stage_elems<kCol>(n);
  // steps between a stage's rows and between its columns
  const int rs = kCol ? 1 : ld, cs = kCol ? ld : 1;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  const int chunks = r_end > r_begin ? (r_end - r_begin + kRows - 1) / kRows : 0;
  const double* gb = g + b * sb;
  const double* wb = w + static_cast<size_t>(b) * m;

  // this warp's tiles: a balanced contiguous run of the group's tiles, in
  // row-major order over the lower triangle
  const int total = lower_tiles(n);
  const int g0 = blockIdx.y * kGroupTiles;
  const int group = min(kGroupTiles, total - g0);
  const int first = g0 + warp * group / kWarps;
  const int count = g0 + (warp + 1) * group / kWarps - first;
  int ti[kMaxTiles], tj[kMaxTiles];
  {
    int i = 0, start = 0;
    while (start + row_tiles(i, n) <= first) start += row_tiles(i++, n);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (first + t - start >= row_tiles(i, n) && t < count) start += row_tiles(i++, n);
      ti[t] = i;
      tj[t] = first + t - start;
    }
  }

  // the padding stays zero: cp.async never writes it
  for (int q = tid; q < kStages * se; q += kThreads) smem[q] = 0.0;
  __syncthreads();

  double acc[kMaxTiles][4];
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks)
      load_stage<kCol>(smem + c * se, smem + c * se + se - kRows, gb, wb, sr, si,
                       r_begin + c * kRows, r_end, n, ld, vec, tid);
    cp_async_commit();
  }

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage c landed; every warp is done with stage c - 1
    const int next = c + kStages - 1;
    if (next < chunks) {
      double* sg = smem + (next % kStages) * se;
      load_stage<kCol>(sg, sg + se - kRows, gb, wb, sr, si, r_begin + next * kRows, r_end, n,
                       ld, vec, tid);
    }
    cp_async_commit();

    const double* sg = smem + (c % kStages) * se;
    const double* sw = sg + se - kRows;
#pragma unroll
    for (int kk = 0; kk < kRows / kK; ++kk) {
      // this lane's rows kK kk + kV t + v of the stage, at its column g
      const double* at = sg + (kK * kk + kV * tig) * rs + gid * cs;
      double wr[kV], lo[kV], hi[kV], bb[kV];
      load_rows<true>(wr, sw + kK * kk + kV * tig, 1);
      int cur = -1;
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
        if (t < count) {
          if (ti[t] != cur) {
            cur = ti[t];
            load_rows<kCol>(lo, at + 16 * cur * cs, rs);
            load_rows<kCol>(hi, at + (16 * cur + 8) * cs, rs);
#pragma unroll
            for (int v = 0; v < kV; ++v) {
              lo[v] *= wr[v];
              hi[v] *= wr[v];
            }
          }
          load_rows<kCol>(bb, at + 8 * tj[t] * cs, rs);
          mma(acc[t], lo, hi, bb);
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t nn = static_cast<size_t>(n) * n;
  const double* pb = p + b * nn;
  double* dst =
      splits == 1 ? out + b * nn : part + (static_cast<size_t>(b) * splits + split) * nn;
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (t >= count) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * ti[t] + gid + 8 * (e / 2), col = 8 * tj[t] + 2 * tig + e % 2;
      if (row >= n || col > row) continue;
      if (splits == 1) {
        double v = pb[row * n + col] + acc[t][e];
        if (row == col) v += reg;
        dst[row * n + col] = v;
        dst[col * n + row] = v;
      } else {
        dst[row * n + col] = acc[t][e];
      }
    }
  }
}

// The second pass where the rows were split: each lower entry the sum of
// its partials in split order, then P and reg as the first pass's epilogue
// adds them. grid: x = scene * tiles + tile of kSumThreads entries.
__global__ void __launch_bounds__(kSumThreads)
kkt_gram_sum_kernel(const double* __restrict__ p, const double* __restrict__ part, double reg,
                    double* __restrict__ out, int n, int splits, int tiles) {
  const int b = blockIdx.x / tiles;
  const int e = (blockIdx.x - b * tiles) * kSumThreads + threadIdx.x;
  if (e >= n * n) return;
  const int row = e / n, col = e - row * n;
  if (col > row) return;
  const size_t nn = static_cast<size_t>(n) * n;
  const double* src = part + static_cast<size_t>(b) * splits * nn + e;
  double acc = src[0];
  for (int s = 1; s < splits; ++s) acc += src[s * nn];
  double v = p[b * nn + e] + acc;
  if (row == col) v += reg;
  out[b * nn + e] = v;
  out[b * nn + static_cast<size_t>(col) * n + row] = v;
}

constexpr int kMaxDevices = 64;

template <bool kCol>
cudaError_t set_smem_attribute() {
  return cudaFuncSetAttribute(kkt_gram_kernel<kCol>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

// K = P + G^T diag(w) G + reg I (see the top of the file). G's element
// (b, r, i) at g[b sb + r sr + i si], with sr == 1 or si == 1. `part` holds
// batch x splits x n x n doubles when splits > 1 (else it is not read);
// the rows are split into ranges of rows_per_split (a multiple of 16).
extern "C" int bp_kkt_gram_f64(const double* p, const double* g, const double* w, double reg,
                               double* out, double* part, long long sb, long long sr,
                               long long si, int batch, int m, int n, int splits,
                               int rows_per_split, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static std::once_flag once[kMaxDevices];
  static cudaError_t attr[kMaxDevices];
  std::call_once(once[device], [device] {
    attr[device] = set_smem_attribute<false>();
    if (attr[device] == cudaSuccess) attr[device] = set_smem_attribute<true>();
  });
  if (attr[device] != cudaSuccess) return static_cast<int>(attr[device]);
  const bool col = sr == 1 && si != 1;
  const size_t smem = static_cast<size_t>(kStages) *
                      (col ? stage_elems<true>(n) : stage_elems<false>(n)) * sizeof(double);
  if (batch < 1 || n < 1 || m < 0 || splits < 1 || rows_per_split < kRows ||
      rows_per_split % kRows || (sr != 1 && si != 1) || smem > static_cast<size_t>(kMaxSmem) ||
      static_cast<long long>(batch) * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (lower_tiles(n) + kGroupTiles - 1) / kGroupTiles;
  const int vec = !col && n % 2 == 0 && sr % 2 == 0 && sb % 2 == 0 &&
                  (reinterpret_cast<std::uintptr_t>(g) & 15) == 0;
  const dim3 grid(batch * splits, groups);
  if (col)
    kkt_gram_kernel<true><<<grid, kThreads, smem, stream>>>(p, g, w, reg, out, part, sb, sr, si,
                                                           m, n, splits, rows_per_split, vec);
  else
    kkt_gram_kernel<false><<<grid, kThreads, smem, stream>>>(p, g, w, reg, out, part, sb, sr,
                                                            si, m, n, splits, rows_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int tiles = (n * n + kSumThreads - 1) / kSumThreads;
  kkt_gram_sum_kernel<<<batch * tiles, kSumThreads, 0, stream>>>(p, part, reg, out, n, splits,
                                                                  tiles);
  return static_cast<int>(cudaGetLastError());
}
