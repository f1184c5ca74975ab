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
// What bounds it on the H100: the dependent chain inside one problem,
// 10 x 4 x R row corrections (600 at R = 15) each waiting on the previous
// one, plus the initial projection. Data is small (76 bytes of input per
// row block per problem; 12288 problems per tick at 128 scenes), so
// neither bandwidth nor FLOPs bound it.
//
// What the design does about it: one thread per problem, with the rows,
// the row norms and the Dykstra corrections e[r] in registers (the row
// loops are unrolled to the compile-time bound of 16 rows and masked to
// R), so the chain runs at register latency with no memory traffic after
// the loads. The (scene, link, obstacle) axes are folded into the problem
// axis by the caller, so one launch covers a whole tick. The TPU's
// 128-lane padding and (R, 3, B) transposes are not carried over: the
// layout stays (P, R, 3) and the ragged edge is masked by the thread index.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kOuterIters = 10;
constexpr int kDykstraSweeps = 4;
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ void dykstra(const T (&a)[kMaxRows][3],
                                        const T (&b)[kMaxRows],
                                        const T (&an2)[kMaxRows], int rows,
                                        T (&y)[3]) {
  T e[kMaxRows][3];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) e[r][0] = e[r][1] = e[r][2] = T(0);
  for (int sweep = 0; sweep < kDykstraSweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r < rows) {
        const T w0 = y[0] + e[r][0];
        const T w1 = y[1] + e[r][1];
        const T w2 = y[2] + e[r][2];
        const T viol = (a[r][0] * w0 + a[r][1] * w1 + a[r][2] * w2 - b[r]) / an2[r];
        const T t = viol > T(0) ? viol : T(0);
        e[r][0] = t * a[r][0];
        e[r][1] = t * a[r][1];
        e[r][2] = t * a[r][2];
        y[0] = w0 - e[r][0];
        y[1] = w1 - e[r][1];
        y[2] = w2 - e[r][2];
      }
    }
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

  T a[kMaxRows][3], b[kMaxRows], an2[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      const size_t o = (static_cast<size_t>(p) * rows + r) * 3;
      a[r][0] = a_in[o];
      a[r][1] = a_in[o + 1];
      a[r][2] = a_in[o + 2];
      b[r] = b_in[static_cast<size_t>(p) * rows + r];
      const T n2 = a[r][0] * a[r][0] + a[r][1] * a[r][1] + a[r][2] * a[r][2];
      an2[r] = n2 > T(1e-12) ? n2 : T(1e-12);
    } else {
      a[r][0] = a[r][1] = a[r][2] = b[r] = T(0);
      an2[r] = T(1);
    }
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
  dykstra(a, b, an2, rows, x);
  for (int it = 0; it < kOuterIters; ++it) {
    const T phi = seg_phi(x, p0, d, denom);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = p0[i] + phi * d[i];
    dykstra(a, b, an2, rows, x);
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
