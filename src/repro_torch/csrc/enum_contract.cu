// Logsumexp contraction of discrete-latent chain elimination: forward and
// backward.
//
// Forward replaces the Pallas TPU kernel
// src/repro/kernels/enum_contract.py:_kernel (reached through enum_contract,
// enum_contract.py:50).  For B batch rows it computes
//     out[b, j] = logsumexp_i(alpha[b, i] + M[b, i, j])
// exactly as src/repro/kernels/ref.py:enum_contract writes it: the column
// max m over i, m_safe = m where m is finite else 0, the sum of
// exp(x - m_safe) strictly left to right over i, then log(s) + m_safe, and
// -inf for a column whose max is not finite (an all -inf column).
//
// Bit-identity with the plain PyTorch version: one thread owns one output
// column (b, j) and loops i = 0 .. Ki-1 twice, once for the max and once for
// the sum.  That loop order is the plain version's pinned sequential sum,
// every operation is the same single IEEE operation (add, subtract, expf,
// logf: the functions PyTorch's CUDA elementwise ops call, built without
// --use_fast_math), and no product appears that the compiler could fuse into
// an FMA.  So kernel and plain version agree bit for bit on the card.  The
// max propagates NaN as torch.amax does.
//
// Backward: there is no TPU kernel for it (the JAX package differentiates
// the jnp reference).  With p[b, i, j] = exp(alpha_i + M_ij - out_j), or 0
// where out_j = -inf (so no -inf - -inf NaN is ever formed),
//     dM[b, i, j] = g[b, j] * p[b, i, j],   dalpha[b, i] = sum_j dM[b, i, j]
// with the sum over j in fixed order.  One thread owns one (b, i) row.
//
// What bounds it: at the main path's shape (one row, Ki = K = 8) both
// kernels touch under 400 bytes: their time is the launch.  At B = 16384,
// Ki = K = 64 the forward reads 4 B * B * Ki * (K + 1) once and is bound by
// bytes; a warp's 32 threads read 32 neighbouring columns of one row of M,
// so the loads coalesce, and the second pass over i re-reads M from L1/L2.
// The Pallas kernel pads to (8, 128) tiles and walks a sequential grid over
// rows; here the grid is a flat grid-stride loop over (row, column) pairs,
// nothing is padded, and rows need no order.  Fusing the T-1 sequential
// steps of the chain into one launch is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond this

long long blocks_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

template <typename T>
__global__ void enum_contract_fwd_kernel(const T* __restrict__ alpha,
                                         const T* __restrict__ mat,
                                         T* __restrict__ out, long long rows,
                                         int ki, int k) {
  const long long total = rows * k;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / k;
    const int j = (int)(t - b * k);
    const T* a = alpha + b * ki;
    const T* m = mat + b * ki * k + j;
    T mx = a[0] + m[0];
    for (int i = 1; i < ki; ++i) {
      const T x = a[i] + m[(long long)i * k];
      if (x > mx || isnan(x)) mx = x;
    }
    const bool finite = isfinite(mx);
    const T m_safe = finite ? mx : T(0);
    T s = exp_((a[0] + m[0]) - m_safe);
    for (int i = 1; i < ki; ++i) {
      s = s + exp_((a[i] + m[(long long)i * k]) - m_safe);
    }
    out[t] = finite ? log_(s) + m_safe : T(-INFINITY);
  }
}

template <typename T>
__global__ void enum_contract_bwd_kernel(
    const T* __restrict__ alpha, const T* __restrict__ mat,
    const T* __restrict__ out, const T* __restrict__ g,
    T* __restrict__ d_alpha, T* __restrict__ d_mat, long long rows, int ki,
    int k) {
  const long long total = rows * ki;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long b = t / ki;
    const T a = alpha[t];
    const T* m = mat + t * k;  // row (b, i) of M
    const T* o = out + b * k;
    const T* gb = g + b * k;
    T* dm = d_mat + t * k;
    T acc = T(0);
    for (int j = 0; j < k; ++j) {
      const T oj = o[j];
      const T p = (oj == T(-INFINITY)) ? T(0) : exp_((a + m[j]) - oj);
      const T dmij = gb[j] * p;
      dm[j] = dmij;
      acc = acc + dmij;
    }
    d_alpha[t] = acc;
  }
}

template <typename T>
cudaError_t launch_fwd(const void* alpha, const void* mat, void* out,
                       long long rows, int ki, int k, void* stream) {
  const long long total = rows * k;
  if (total <= 0 || ki <= 0) return cudaSuccess;
  enum_contract_fwd_kernel<T><<<(unsigned)blocks_for(total), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const T*)alpha, (const T*)mat, (T*)out, rows, ki, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* alpha, const void* mat, const void* out,
                       const void* g, void* d_alpha, void* d_mat,
                       long long rows, int ki, int k, void* stream) {
  const long long total = rows * ki;
  if (total <= 0) return cudaSuccess;
  enum_contract_bwd_kernel<T><<<(unsigned)blocks_for(total), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const T*)alpha, (const T*)mat, (const T*)out, (const T*)g,
      (T*)d_alpha, (T*)d_mat, rows, ki, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int enum_contract_fwd_f32(const void* alpha, const void* mat,
                                     void* out, long long rows, int ki, int k,
                                     void* stream) {
  return (int)launch_fwd<float>(alpha, mat, out, rows, ki, k, stream);
}

extern "C" int enum_contract_fwd_f64(const void* alpha, const void* mat,
                                     void* out, long long rows, int ki, int k,
                                     void* stream) {
  return (int)launch_fwd<double>(alpha, mat, out, rows, ki, k, stream);
}

extern "C" int enum_contract_bwd_f32(const void* alpha, const void* mat,
                                     const void* out, const void* g,
                                     void* d_alpha, void* d_mat,
                                     long long rows, int ki, int k,
                                     void* stream) {
  return (int)launch_bwd<float>(alpha, mat, out, g, d_alpha, d_mat, rows, ki,
                                k, stream);
}

extern "C" int enum_contract_bwd_f64(const void* alpha, const void* mat,
                                     const void* out, const void* g,
                                     void* d_alpha, void* d_mat,
                                     long long rows, int ki, int k,
                                     void* stream) {
  return (int)launch_bwd<double>(alpha, mat, out, g, d_alpha, d_mat, rows, ki,
                                 k, stream);
}
