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
// chees_open_f32/f64 is the same kernel with the momentum draw in front
// (OPEN = true): from the standard-normal draw n it forms
//     r0 = n / sqrt(m_inv)                 (hmc_util.momentum_sample)
// and then the opening half-kick and drift above with kick = 0.5.  It does
// no reduction and does not write r0: the transition's closing kernel
// (csrc/chees.cu) recomputes r0 from n with the same rounding.
//
// eps is read from a one-element device tensor of the ensemble's dtype.  On
// a card ChEES replays its trajectory from two CUDA graphs (core/infer/
// ensemble.py, EnsembleTrajectory): chees_open then the potential, and this
// kernel (kick = 1.0) then the potential.  The step size changes every
// warmup iteration, so a captured launch must read the value current at
// replay, not the one of the capture; the host stages it once a transition
// with the draws, in one copy.  kick stays a value (it is 0.5 or 1.0 for
// good, so kick * eps is exact in T).  The graphs' form is in place: z_out
// is z and r_out is r (chees_open: z_out is z, r_out a fixed buffer), so
// replays chain on fixed buffers.  Each element is read and then written by
// the same thread, so z, r and the outputs carry no __restrict__.
//
// Every product, quotient, square root and sum is rounded on its own
// (__fmul_rn / __fdiv_rn / __fsqrt_rn / __dadd_rn etc.), so the compiler does
// not contract them into FMAs and the kernel does the same IEEE operations,
// in the same order, as the plain PyTorch version.
//
// What bounds it: five (C, D) arrays move (three reads, two writes) plus
// the m_inv row.  At the main path's (8, 54) that is 8.6 KB: launch
// latency, not bytes, and Hopper cannot make a 432-element kick-drift
// faster.  What the redesign removes is the host's cost around it: issued
// from a CUDA graph, the launch and the potential after it cost one graph
// replay on the host instead of ~33 eager launches.  At (64, 1e6) it is
// bound by bytes.  The TPU kernel padded C to 8 sublanes and D to 128
// lanes; here a 2-D grid (column blocks x rows) gives one thread per element
// with no padding and no integer division to find the m_inv column:
// blockIdx.y walks the rows (grid-stride past 65535), blockIdx.x *
// blockDim.x + threadIdx.x is the column, so neighbouring threads read
// neighbouring addresses.
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
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// OPEN: r_in holds the standard-normal draw n, and r = n / sqrt(m_inv).
template <typename T, bool OPEN>
__global__ void leapfrog_batch_kernel(const T* z, const T* r_in,
                                      const T* __restrict__ g,
                                      const T* __restrict__ m_inv,
                                      const T* __restrict__ eps_ptr,
                                      T* z_out, T* r_out, T kick,
                                      long long rows, long long cols) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const T eps = *eps_ptr;
  const T kick_eps = mul_rn(kick, eps);  // exact: kick is 0.5 or 1.0
  const T mi = m_inv[col];
  const T sd = OPEN ? sqrt_rn(mi) : T(1);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const long long i = row * cols + col;
    const T r = OPEN ? div_rn(r_in[i], sd) : r_in[i];
    const T r_new = sub_rn(r, mul_rn(kick_eps, g[i]));
    const T z_new = add_rn(z[i], mul_rn(eps, mul_rn(r_new, mi)));
    r_out[i] = r_new;
    z_out[i] = z_new;
  }
}

template <typename T, bool OPEN>
cudaError_t launch(const void* z, const void* r, const void* g,
                   const void* m_inv, const void* eps, void* z_out,
                   void* r_out, double kick, long long rows, long long cols,
                   void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  if (kick != 0.5 && kick != 1.0) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long col_blocks = (cols + threads - 1) / threads;
  if (col_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned row_blocks = rows < 65535 ? (unsigned)rows : 65535u;
  dim3 grid((unsigned)col_blocks, row_blocks);
  leapfrog_batch_kernel<T, OPEN><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const T*)r, (const T*)g, (const T*)m_inv,
      (const T*)eps, (T*)z_out, (T*)r_out, (T)kick, rows, cols);
  return cudaGetLastError();
}

}  // namespace

// eps: a one-element device array of the ensemble's dtype.  z_out may be z
// and r_out may be r (in place).
extern "C" int leapfrog_halfstep_batch_f32(const void* z, const void* r,
                                           const void* g, const void* m_inv,
                                           const void* eps, void* z_out,
                                           void* r_out, double kick,
                                           long long rows, long long cols,
                                           void* stream) {
  return (int)launch<float, false>(z, r, g, m_inv, eps, z_out, r_out, kick,
                                   rows, cols, stream);
}

extern "C" int leapfrog_halfstep_batch_f64(const void* z, const void* r,
                                           const void* g, const void* m_inv,
                                           const void* eps, void* z_out,
                                           void* r_out, double kick,
                                           long long rows, long long cols,
                                           void* stream) {
  return (int)launch<double, false>(z, r, g, m_inv, eps, z_out, r_out, kick,
                                    rows, cols, stream);
}

// n: the (C, D) standard-normal momentum draw.  z_out may be z.
extern "C" int chees_open_f32(const void* z, const void* n, const void* g,
                              const void* m_inv, const void* eps,
                              void* z_out, void* r_out, long long rows,
                              long long cols, void* stream) {
  return (int)launch<float, true>(z, n, g, m_inv, eps, z_out, r_out, 0.5,
                                  rows, cols, stream);
}

extern "C" int chees_open_f64(const void* z, const void* n, const void* g,
                              const void* m_inv, const void* eps,
                              void* z_out, void* r_out, long long rows,
                              long long cols, void* stream) {
  return (int)launch<double, true>(z, n, g, m_inv, eps, z_out, r_out, 0.5,
                                   rows, cols, stream);
}
