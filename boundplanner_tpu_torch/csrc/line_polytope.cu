// Kernel B: batched closest pair between a segment and a polytope.
//
// Replaces the Pallas TPU kernel boundplanner_tpu/ops/pallas_proj.py
// `line_polytope_projection` (`_kernel`, :39-91). For each problem p it
// finds the closest pair between the segment [p0, p1] and the polytope
// {y : A y <= b} (R <= 16 rows, zero rows allowed): x = Dykstra(p0), then
// OUTER_ITERS rounds of (closed-form closest segment point z of x ->
// x = DYKSTRA_SWEEPS-sweep Dykstra projection of z onto the polytope).
// Outputs x (P, 3), phi (P,) and dist = |x - (p0 + phi (p1 - p0))| (P,).
// The clamps are those of the Pallas kernel: |d|^2 and |a_r|^2 floored at
// 1e-12, phi clipped to [0, 1].
//
// What bounds it on the H100: latency, not bytes or FLOPs. One thread
// walks its problem's dependent chain of row corrections (add, dot, IEEE
// division, clamp, scale, subtract, each waiting on the last), and a warp
// takes as long as its slowest problem. Run as written, that chain is
// 11 x 4 x R corrections (660 at R = 15) for every problem. At the tick's
// fold (12288 problems of 284 bytes in and out, 1 us of memory traffic)
// the launch has about one warp per scheduler, with nothing to hide the
// chain behind.
//
// What the design does about it: it walks only the part of the chain that
// can change a value, and walks it exactly as written.
//  - No-op rows are dropped at load. A row with a = +-0 in all three
//    components and b >= -1e26 (or NaN) has a correction t * a = +-0 (t is
//    finite: -b / 1e-12 <= 1e38), so it leaves y and its own correction
//    equal by value (only a -0 may turn into +0). The tick's inactive
//    obstacle slots and the 9 padded rows of every box are such rows. A
//    zero row with b < -1e26 stays: t overflows to inf and inf * 0 gives
//    NaN, as in the plain version. The kept rows keep their order; they are
//    re-read from memory into static register slots (rows, norms and
//    corrections stay in registers: 205 of them, no local memory). The
//    row loops branch out past the last kept row; a guard around each row
//    compiles to predicated code in which a skipped row still takes its
//    latency.
//  - A Dykstra call stops after the first sweep that leaves y and every
//    correction equal by value to their values before it. A sweep is a
//    function of that state alone, so every later sweep would repeat it.
//    (NaN != NaN: a NaN state runs every sweep.)
//  - The outer loop stops once an iteration returns its input x by value:
//    the corrections restart from 0 at every call, so the iteration is a
//    function of x alone and every later one would return x again.
// Neither exit uses a tolerance. Each kept row's arithmetic is the same
// expression as in the full chain (same operand order, IEEE division by the
// clamped |a|^2, the same clamp), so the results equal the full chain's by
// value. Division by a reciprocal, a . (y + e) rewritten as a . y + t |a|^2,
// or any reassociation would move the rounding and are not used.
// One thread per problem: Dykstra is sequential over rows, so splitting a
// problem's rows across lanes would add shuffles to the chain. Blocks of 64
// threads put every SM to work at the tick's fold (192 blocks). A row count
// made uniform over the warp (no-op rows padding the short lanes) and the
// rows kept in shared memory (127 registers) both measured slower.
// The (scene, link, obstacle) axes are folded into the problem axis by the
// caller, so one launch covers a whole tick. The TPU's 128-lane padding
// and (R, 3, B) transposes are not carried over: the layout stays
// (P, R, 3) and the ragged edge is masked by the thread index.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kOuterIters = 10;
constexpr int kDykstraSweeps = 4;
constexpr int kThreads = 64;

// A zero row whose b keeps -b / 1e-12 finite (NaN included) changes nothing.
template <typename T>
__device__ __forceinline__ bool no_op_row(T a0, T a1, T a2, T b) {
  return a0 == T(0) && a1 == T(0) && a2 == T(0) && !(b < T(-1e26));
}

// Dykstra projection of y onto the first `kept` rows, at most
// kDykstraSweeps sweeps, stopping at the first sweep that changes nothing.
template <typename T>
__device__ __forceinline__ void dykstra(const T (&a)[kMaxRows][3],
                                        const T (&b)[kMaxRows],
                                        const T (&an2)[kMaxRows], int kept,
                                        T (&y)[3]) {
  T e[kMaxRows][3];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) e[r][0] = e[r][1] = e[r][2] = T(0);
  for (int sweep = 0; sweep < kDykstraSweeps; ++sweep) {
    const T y0 = y[0], y1 = y[1], y2 = y[2];
    bool same = true;
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      // a branch past the remaining rows, not a guard around each: a
      // guarded row compiles to predicated code that still takes its time
      if (r >= kept) break;
      const T w0 = y[0] + e[r][0];
      const T w1 = y[1] + e[r][1];
      const T w2 = y[2] + e[r][2];
      const T viol = (a[r][0] * w0 + a[r][1] * w1 + a[r][2] * w2 - b[r]) / an2[r];
      const T t = viol > T(0) ? viol : T(0);
      const T s0 = t * a[r][0];
      const T s1 = t * a[r][1];
      const T s2 = t * a[r][2];
      same &= (s0 == e[r][0]) & (s1 == e[r][1]) & (s2 == e[r][2]);
      e[r][0] = s0;
      e[r][1] = s1;
      e[r][2] = s2;
      y[0] = w0 - e[r][0];
      y[1] = w1 - e[r][1];
      y[2] = w2 - e[r][2];
    }
    if (same & (y[0] == y0) & (y[1] == y1) & (y[2] == y2)) break;
  }
}

template <typename T>
__device__ __forceinline__ T seg_phi(const T (&x)[3], const T (&p0)[3],
                                     const T (&d)[3], T denom) {
  const T phi = ((x[0] - p0[0]) * d[0] + (x[1] - p0[1]) * d[1] +
                 (x[2] - p0[2]) * d[2]) / denom;
  return phi < T(0) ? T(0) : (phi > T(1) ? T(1) : phi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
line_polytope_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in,
                     const T* __restrict__ p0_in, const T* __restrict__ p1_in,
                     T* __restrict__ x_out, T* __restrict__ phi_out,
                     T* __restrict__ dist_out, int count, int rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= count) return;
  const T* a_p = a_in + static_cast<size_t>(p) * rows * 3;
  const T* b_p = b_in + static_cast<size_t>(p) * rows;

  // which rows can change a value (bit r: row r is kept)
  unsigned keep = 0;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows && !no_op_row(a_p[3 * r], a_p[3 * r + 1], a_p[3 * r + 2], b_p[r]))
      keep |= 1u << r;
  }
  const int kept = __popc(keep);

  // the kept rows, in order, into static slots 0 .. kept-1 (a second read
  // of rows the first pass brought into L1)
  T a[kMaxRows][3], b[kMaxRows], an2[kMaxRows];
  unsigned rest = keep;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j >= kept) break;
    const int r = __ffs(rest) - 1;
    rest &= rest - 1;
    a[j][0] = a_p[3 * r];
    a[j][1] = a_p[3 * r + 1];
    a[j][2] = a_p[3 * r + 2];
    b[j] = b_p[r];
    const T n2 = a[j][0] * a[j][0] + a[j][1] * a[j][1] + a[j][2] * a[j][2];
    an2[j] = n2 > T(1e-12) ? n2 : T(1e-12);
  }
  T p0[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p0[i] = p0_in[3 * static_cast<size_t>(p) + i];
    d[i] = p1_in[3 * static_cast<size_t>(p) + i] - p0[i];
  }
  const T dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const T denom = dd > T(1e-12) ? dd : T(1e-12);

  T x[3] = {p0[0], p0[1], p0[2]};
  dykstra(a, b, an2, kept, x);
  for (int it = 0; it < kOuterIters; ++it) {
    const T phi = seg_phi(x, p0, d, denom);
    T z[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) z[i] = p0[i] + phi * d[i];
    dykstra(a, b, an2, kept, z);
    const bool fixed = (z[0] == x[0]) & (z[1] == x[1]) & (z[2] == x[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = z[i];
    if (fixed) break;
  }
  const T phi = seg_phi(x, p0, d, denom);
  T dist2 = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T g = x[i] - (p0[i] + phi * d[i]);
    dist2 += g * g;
    x_out[3 * static_cast<size_t>(p) + i] = x[i];
  }
  phi_out[p] = phi;
  dist_out[p] = sqrt(dist2);
}

template <typename T>
int launch(const T* a, const T* b, const T* p0, const T* p1, T* x, T* phi,
           T* dist, int count, int rows, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (count + kThreads - 1) / kThreads;
  line_polytope_kernel<T><<<blocks, kThreads, 0, stream>>>(
      a, b, p0, p1, x, phi, dist, count, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bp_line_polytope_f32(const float* a, const float* b,
                                    const float* p0, const float* p1, float* x,
                                    float* phi, float* dist, int count,
                                    int rows, void* stream) {
  return launch<float>(a, b, p0, p1, x, phi, dist, count, rows,
                       static_cast<cudaStream_t>(stream));
}
