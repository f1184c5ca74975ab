// Kernel A: batched Cholesky factor + explicit inverse of SPD matrices.
//
// Replaces the Pallas TPU kernel boundplanner_tpu/ops/pallas_chol.py
// `cholesky_inverse` (the `_kernel_il` interleaved schedule, :179-273),
// reached from boundplanner_tpu/ops/linalg.py `kkt_inverse`. For every
// matrix K of a (B, n, n) batch it returns L^{-1}, where L is the lower
// Cholesky factor with the pivot clamp sqrt(max(d, 1e-30)). The result is
// exactly lower-triangular: the IPM solves with l_inv^T (l_inv rhs).
//
// What bounds it on the H100: not bytes (K is read once and L^{-1} written
// once, 74 KB each in f32 at n = 136) and not FLOPs (n^3/3 + n^3/6 per
// matrix). It is the chain of 2n dependent steps: every column step and
// every inverse-row step needs the previous one, so the time is n steps
// times the latency of one step's shared-memory pass plus a barrier.
//
// What the design does about it: one thread block per matrix keeps the
// whole working set in dynamic shared memory (n*n + n elements: 74.5 KB in
// f32, 149 KB in f64 at n = 136, above the 48 KB default, hence
// cudaFuncSetAttribute), so no step touches device memory. The factor and
// the inverse run in place in that one buffer, interleaved as `_kernel_il`
// does: step j eliminates column j (trailing update of rows/cols > j, all
// threads in parallel over the (n-j-1)^2 entries), stores L column j, then
// forms X row j from L row j and X rows < j (one thread per column).
// Blocks are independent, so the batch of 128 scenes fills 128 of the 132
// SMs. The TPU's 128-lane batch padding and (n, n, B) transposes are not
// carried over: the layout stays (B, n, n) row-major.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_inverse_kernel(const T* __restrict__ k, T* __restrict__ out, int n) {
  extern __shared__ unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);   // n * n working matrix
  T* lrow = a + n * n;                     // copy of L[j, :j]
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;

  for (int e = tid; e < n * n; e += blockDim.x) a[e] = k[base + e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // ---- factorization: eliminate column j ----
    const T d = sqrt(fmax(a[j * n + j], static_cast<T>(1e-30)));
    const int m = n - j - 1;
    for (int e = tid; e < m * m; e += blockDim.x) {
      const int i = j + 1 + e / m;
      const int c = j + 1 + e % m;
      a[i * n + c] -= (a[i * n + j] / d) * (a[j * n + c] / d);
    }
    __syncthreads();
    // L column j: rows > j scaled, the pivot on the diagonal, zeros above
    for (int i = tid; i < n; i += blockDim.x) {
      const T v = a[i * n + j];
      a[i * n + j] = i > j ? v / d : (i == j ? d : static_cast<T>(0));
    }
    __syncthreads();

    // ---- inversion: X row j = (e_j - L[j, :j] X[:j, :]) / d ----
    for (int c = tid; c < j; c += blockDim.x) lrow[c] = a[j * n + c];
    __syncthreads();
    for (int c = tid; c < n; c += blockDim.x) {
      T s = static_cast<T>(0);
      for (int r = 0; r < j; ++r) s += lrow[r] * a[r * n + c];
      a[j * n + c] = ((c == j ? static_cast<T>(1) : static_cast<T>(0)) - s) / d;
    }
    __syncthreads();
  }

  for (int e = tid; e < n * n; e += blockDim.x) out[base + e] = a[e];
}

template <typename T>
int launch(const T* k, T* out, int batch, int n, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(n) * n + n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_inverse_kernel<T><<<batch, kThreads, smem, stream>>>(k, out, n);
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
