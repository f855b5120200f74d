// Batched MALA / random-walk Metropolis proposal over a (C, D) ensemble.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwm_mala.py:_kernel
// (reached through mala_step, rwm_mala.py:42).  With one shared (D,)
// diagonal preconditioner m_inv and a scalar step eps it computes
//     sig = sqrt((2 * eps) * m_inv)
//     out = z + sig * noise
//     out = out - (eps * m_inv) * grad      (MALA only)
// in float or double (the TPU kernel computes in promote(dtype, f32)).
// HAS_GRAD = false is the random walk: the gradient operand is not passed
// and not read, so RWM moves three (C, D) arrays, not four.
//
// eps is passed by value (the ensemble's step size is a host scalar).  Each
// product, sum and square root is rounded on its own (__fmul_rn,
// __fsqrt_rn, ...), so nothing is contracted into an FMA and the kernel does
// the plain PyTorch version's IEEE operations in the same order.
//
// What bounds it: 4 * C * D elements move for MALA (three reads, one write)
// and 3 * C * D for RWM, plus the m_inv row.  At the main path's (16, 54)
// that is 14 KB: launch latency.  At (64, 1e6) it is bound by bytes.  As in
// csrc/leapfrog_batch.cu a 2-D grid (column blocks x rows) gives one thread
// per element with no padding: the thread computes sig and eps * m_inv for
// its column once and reuses them down the rows it walks.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T, bool HAS_GRAD>
__global__ void mala_step_kernel(const T* __restrict__ z,
                                 const T* __restrict__ g,
                                 const T* __restrict__ noise,
                                 const T* __restrict__ m_inv,
                                 T* __restrict__ out, T eps, T two_eps,
                                 long long rows, long long cols) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const T mi = m_inv[col];
  const T sig = sqrt_rn(mul_rn(two_eps, mi));
  const T drift = mul_rn(eps, mi);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long i = row * cols + col;
    T v = add_rn(z[i], mul_rn(sig, noise[i]));
    if (HAS_GRAD) v = sub_rn(v, mul_rn(drift, g[i]));
    out[i] = v;
  }
}

template <typename T>
cudaError_t launch(const void* z, const void* g, const void* noise,
                   const void* m_inv, void* out, double eps, long long rows,
                   long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  const int threads = 256;
  const long long col_blocks = (cols + threads - 1) / threads;
  if (col_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned row_blocks = rows < 65535 ? (unsigned)rows : 65535u;
  const T eps_t = (T)eps;
  const T two_eps = (T)2 * eps_t;  // exact: a power-of-two scaling
  dim3 grid((unsigned)col_blocks, row_blocks);
  if (g != nullptr) {
    mala_step_kernel<T, true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const T*)z, (const T*)g, (const T*)noise, (const T*)m_inv, (T*)out,
        eps_t, two_eps, rows, cols);
  } else {
    mala_step_kernel<T, false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const T*)z, nullptr, (const T*)noise, (const T*)m_inv, (T*)out,
        eps_t, two_eps, rows, cols);
  }
  return cudaGetLastError();
}

}  // namespace

// g may be null: the random-walk proposal (no drift term, grad not read).
extern "C" int mala_step_f32(const void* z, const void* g, const void* noise,
                             const void* m_inv, void* out, double eps,
                             long long rows, long long cols, void* stream) {
  return (int)launch<float>(z, g, noise, m_inv, out, eps, rows, cols, stream);
}

extern "C" int mala_step_f64(const void* z, const void* g, const void* noise,
                             const void* m_inv, void* out, double eps,
                             long long rows, long long cols, void* stream) {
  return (int)launch<double>(z, g, noise, m_inv, out, eps, rows, cols,
                             stream);
}
