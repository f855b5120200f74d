// Chain-batched leapfrog kick + drift for the ChEES ensemble (diagonal mass).
//
// Replaces the Pallas TPU kernel src/repro/kernels/leapfrog.py:_batch_kernel
// (reached through leapfrog_halfstep_batch, leapfrog.py:104).  Over a (C, D)
// ensemble with one shared (D,) m_inv row it computes
//     r' = r - (kick * eps) * g
//     z' = z + eps * (r' * m_inv)
// with kick = 0.5 (the opening half-kick of a trajectory) or 1.0 (the two
// half-kicks between interior steps merged into one pass), in float or
// double: the TPU kernel computes in promote(dtype, f32).
//
// eps and kick are passed by value: the ensemble's step size is a host
// scalar (one shared value for every chain), so no device read is needed.
// Every product and sum is rounded on its own (__fmul_rn / __dadd_rn etc.),
// so the compiler does not contract them into FMAs and the kernel does the
// same IEEE operations, in the same order, as the plain PyTorch version.
//
// What bounds it: five (C, D) arrays move (three reads, two writes) plus the
// m_inv row.  At the main path's (8, 54) that is 8.6 KB: launch latency,
// not bytes.  At (64, 1e6) it is bound by bytes.  The TPU kernel padded C
// to 8 sublanes and D to 128 lanes; here a 2-D grid (column blocks x rows)
// gives one thread per element with no padding and no integer division to
// find the m_inv column: blockIdx.y walks the rows (grid-stride past 65535),
// blockIdx.x * blockDim.x + threadIdx.x is the column, so neighbouring
// threads read neighbouring addresses.
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

template <typename T>
__global__ void leapfrog_batch_kernel(const T* __restrict__ z,
                                      const T* __restrict__ r,
                                      const T* __restrict__ g,
                                      const T* __restrict__ m_inv,
                                      T* __restrict__ z_out,
                                      T* __restrict__ r_out, T eps,
                                      T kick_eps, long long rows,
                                      long long cols) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const T mi = m_inv[col];
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long i = row * cols + col;
    const T r_new = sub_rn(r[i], mul_rn(kick_eps, g[i]));
    r_out[i] = r_new;
    z_out[i] = add_rn(z[i], mul_rn(eps, mul_rn(r_new, mi)));
  }
}

template <typename T>
cudaError_t launch(const void* z, const void* r, const void* g,
                   const void* m_inv, void* z_out, void* r_out, double eps,
                   double kick, long long rows, long long cols,
                   void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  const int threads = 256;
  const long long col_blocks = (cols + threads - 1) / threads;
  if (col_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned row_blocks = rows < 65535 ? (unsigned)rows : 65535u;
  const T eps_t = (T)eps;
  // kick is 0.5 or 1.0, so kick * eps is exact in T
  const T kick_eps = (T)kick * eps_t;
  dim3 grid((unsigned)col_blocks, row_blocks);
  leapfrog_batch_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const T*)r, (const T*)g, (const T*)m_inv, (T*)z_out,
      (T*)r_out, eps_t, kick_eps, rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" int leapfrog_halfstep_batch_f32(const void* z, const void* r,
                                           const void* g, const void* m_inv,
                                           void* z_out, void* r_out,
                                           double eps, double kick,
                                           long long rows, long long cols,
                                           void* stream) {
  return (int)launch<float>(z, r, g, m_inv, z_out, r_out, eps, kick, rows,
                            cols, stream);
}

extern "C" int leapfrog_halfstep_batch_f64(const void* z, const void* r,
                                           const void* g, const void* m_inv,
                                           void* z_out, void* r_out,
                                           double eps, double kick,
                                           long long rows, long long cols,
                                           void* stream) {
  return (int)launch<double>(z, r, g, m_inv, z_out, r_out, eps, kick, rows,
                             cols, stream);
}
