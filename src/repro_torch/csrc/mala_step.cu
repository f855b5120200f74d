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
//
// The accept test (mala_accept_f32/f64).  After the potential at the
// proposal, one launch does the Metropolis-Hastings step of every chain
// (src/repro/core/infer/mala.py:184-200 in the JAX package, plain jnp there):
//     MALA: logq_fwd = -0.5 * sum(noise^2)
//           diff = (z - z') + (eps * m_inv) * g'
//           logq_rev = coef * sum(diff^2 / m_inv)     coef = -0.25 / eps
//     log_accept = pe - pe' (+ logq_rev - logq_fwd), -inf where pe' is not
//     finite (a divergence); accept_prob = min(exp(log_accept), 1);
//     accept = u < accept_prob; z, pe (and MALA's grad) selected per chain.
// After warmup it updates the running mean accept probability; in warmup
// the last CTA to take an integer ticket forms the chains' harmonic-mean
// accept probability, 1 / mean(1 / max(accept_prob, 1e-10)), summing in the
// pairwise order of core/infer/hmc_util.py's chain_sum, and leaves the
// ticket at zero.  RWM (HAS_GRAD = false) reads no gradient and no noise.
// One CTA per chain; each row's two sums are a fixed-order block reduction
// in double (each term rounded in T first).
// Every selected row is copied, and the mean and the harmonic mean repeat
// the plain PyTorch version's IEEE operations on the card (a division by a
// host number is PyTorch's multiplication by its reciprocal there), so they
// are bit-identical to it for the same accept_prob.  What bounds it: the
// launch, at the main path's (16, 54); bytes at large D.
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

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ void set_neg_inf(float& a) {
  a = __int_as_float(0xff800000);
}
__device__ __forceinline__ void set_neg_inf(double& a) {
  a = __longlong_as_double((long long)0xfff0000000000000ULL);
}

constexpr int kAcceptThreads = 256;
constexpr int kAcceptWarps = kAcceptThreads / 32;
constexpr int kMaxAcceptChains = 4096;  // the harmonic mean's shared buffer

template <typename T, bool HAS_GRAD>
__global__ void __launch_bounds__(kAcceptThreads) mala_accept_kernel(
    const T* __restrict__ z, const T* __restrict__ pe,
    const T* __restrict__ g, const T* __restrict__ z_new,
    const T* __restrict__ pe_new, const T* __restrict__ g_new,
    const T* __restrict__ noise, const T* __restrict__ m_inv,
    const T* __restrict__ u, const T* __restrict__ mean_in, T eps, T coef,
    long long n_post, long long cols, T* __restrict__ z_out,
    T* __restrict__ pe_out, T* __restrict__ g_out, T* accept_prob,
    bool* __restrict__ diverging, T* __restrict__ mean_out,
    T* __restrict__ hmean, int* ticket) {
  extern __shared__ __align__(16) unsigned char fold_raw[];  // warmup: C
  __shared__ double warp_buf[kAcceptWarps * 2];
  __shared__ T sums[2];
  __shared__ int accepted;
  __shared__ int last;
  const long long c = blockIdx.x;
  const long long base = c * cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (HAS_GRAD) {
    double s0 = 0.0, s1 = 0.0;
    for (long long j = tid; j < cols; j += blockDim.x) {
      const T xi = noise[base + j];
      s0 += (double)mul_rn(xi, xi);
      const T mi = m_inv[j];
      const T d = add_rn(sub_rn(z[base + j], z_new[base + j]),
                         mul_rn(mul_rn(eps, mi), g_new[base + j]));
      s1 += (double)div_rn(mul_rn(d, d), mi);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, o);
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
    }
    if (lane == 0) {
      warp_buf[warp] = s0;
      warp_buf[kAcceptWarps + warp] = s1;
    }
    __syncthreads();
    if (tid < 2) {
      double s = warp_buf[tid * kAcceptWarps];
      for (int w = 1; w < kAcceptWarps; ++w)
        s += warp_buf[tid * kAcceptWarps + w];
      sums[tid] = (T)s;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const T pn = pe_new[c];
    T log_accept = sub_rn(pe[c], pn);
    if (HAS_GRAD) {
      const T logq_fwd = mul_rn(T(-0.5), sums[0]);
      const T logq_rev = mul_rn(coef, sums[1]);
      log_accept = sub_rn(add_rn(log_accept, logq_rev), logq_fwd);
    }
    const bool div = !(sub_rn(pn, pn) == T(0));  // inf - inf, NaN - NaN: NaN
    if (div) set_neg_inf(log_accept);
    T ap = exp_(log_accept);
    if (ap > T(1)) ap = T(1);  // torch.clamp(max=1): NaN stays NaN
    const bool acc = u[c] < ap;
    accept_prob[c] = ap;
    diverging[c] = div;
    pe_out[c] = acc ? pn : pe[c];
    if (n_post > 0) {
      const T m = mean_in[c];
      mean_out[c] = add_rn(m, mul_rn(sub_rn(ap, m), div_rn(T(1), (T)n_post)));
    }
    accepted = acc;
  }
  __syncthreads();
  const bool acc = accepted != 0;
  for (long long j = tid; j < cols; j += blockDim.x) {
    z_out[base + j] = acc ? z_new[base + j] : z[base + j];
    if (HAS_GRAD) g_out[base + j] = acc ? g_new[base + j] : g[base + j];
  }
  if (n_post > 0) return;
  // warmup: the harmonic mean, by the last chain's CTA to arrive
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(ticket, 1);
    last = t == (int)gridDim.x - 1;
    if (last) *ticket = 0;  // every chain has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  T* buf = reinterpret_cast<T*>(fold_raw);
  const int chains = (int)gridDim.x;
  for (int i = tid; i < chains; i += blockDim.x) {
    T a = __ldcg(accept_prob + i);
    if (a < T(1e-10)) a = T(1e-10);  // torch.clamp(min=1e-10)
    buf[i] = div_rn(T(1), a);
  }
  __syncthreads();
  if (tid == 0) {
    // chain_sum: add the halves, carry an odd last row, until one is left
    int m = chains;
    while (m > 1) {
      const int h = m / 2;
      for (int i = 0; i < h; ++i) buf[i] = add_rn(buf[i], buf[h + i]);
      if (m & 1) buf[h] = buf[2 * h];
      m = h + (m & 1);
    }
    const T mean = mul_rn(buf[0], div_rn(T(1), (T)chains));
    *hmean = div_rn(T(1), mean);
  }
}

template <typename T>
cudaError_t launch_accept(const void* z, const void* pe, const void* g,
                          const void* z_new, const void* pe_new,
                          const void* g_new, const void* noise,
                          const void* m_inv, const void* u,
                          const void* mean_in, double eps, double coef,
                          long long n_post, long long rows, long long cols,
                          void* z_out, void* pe_out, void* g_out,
                          void* accept_prob, void* diverging, void* mean_out,
                          void* hmean, void* ticket, void* stream) {
  const bool has_grad = g != nullptr;
  if (rows <= 0 || rows > kMaxAcceptChains || cols <= 0 ||
      has_grad != (g_new != nullptr) || has_grad != (noise != nullptr) ||
      has_grad != (g_out != nullptr) ||
      (n_post > 0 ? mean_in == nullptr || mean_out == nullptr
                  : hmean == nullptr || ticket == nullptr))
    return cudaErrorInvalidValue;
  const size_t fold = n_post > 0 ? 0 : (size_t)rows * sizeof(T);
  if (has_grad) {
    mala_accept_kernel<T, true><<<(unsigned)rows, kAcceptThreads, fold,
                                  (cudaStream_t)stream>>>(
        (const T*)z, (const T*)pe, (const T*)g, (const T*)z_new,
        (const T*)pe_new, (const T*)g_new, (const T*)noise, (const T*)m_inv,
        (const T*)u, (const T*)mean_in, (T)eps, (T)coef, n_post, cols,
        (T*)z_out, (T*)pe_out, (T*)g_out, (T*)accept_prob, (bool*)diverging,
        (T*)mean_out, (T*)hmean, (int*)ticket);
  } else {
    mala_accept_kernel<T, false><<<(unsigned)rows, kAcceptThreads, fold,
                                   (cudaStream_t)stream>>>(
        (const T*)z, (const T*)pe, nullptr, (const T*)z_new,
        (const T*)pe_new, nullptr, nullptr, (const T*)m_inv, (const T*)u,
        (const T*)mean_in, (T)eps, (T)coef, n_post, cols, (T*)z_out,
        (T*)pe_out, nullptr, (T*)accept_prob, (bool*)diverging,
        (T*)mean_out, (T*)hmean, (int*)ticket);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mala_accept_max_chains() { return kMaxAcceptChains; }

// g, g_new, noise and g_out all null: the random walk (no q terms, the
// gradient kept by the caller).  n_post > 0: after warmup (mean_in,
// mean_out); n_post == 0: warmup (hmean and the zeroed ticket).
extern "C" int mala_accept_f32(const void* z, const void* pe, const void* g,
                               const void* z_new, const void* pe_new,
                               const void* g_new, const void* noise,
                               const void* m_inv, const void* u,
                               const void* mean_in, double eps, double coef,
                               long long n_post, long long rows,
                               long long cols, void* z_out, void* pe_out,
                               void* g_out, void* accept_prob,
                               void* diverging, void* mean_out, void* hmean,
                               void* ticket, void* stream) {
  return (int)launch_accept<float>(z, pe, g, z_new, pe_new, g_new, noise,
                                   m_inv, u, mean_in, eps, coef, n_post, rows,
                                   cols, z_out, pe_out, g_out, accept_prob,
                                   diverging, mean_out, hmean, ticket,
                                   stream);
}

extern "C" int mala_accept_f64(const void* z, const void* pe, const void* g,
                               const void* z_new, const void* pe_new,
                               const void* g_new, const void* noise,
                               const void* m_inv, const void* u,
                               const void* mean_in, double eps, double coef,
                               long long n_post, long long rows,
                               long long cols, void* z_out, void* pe_out,
                               void* g_out, void* accept_prob,
                               void* diverging, void* mean_out, void* hmean,
                               void* ticket, void* stream) {
  return (int)launch_accept<double>(z, pe, g, z_new, pe_new, g_new, noise,
                                    m_inv, u, mean_in, eps, coef, n_post,
                                    rows, cols, z_out, pe_out, g_out,
                                    accept_prob, diverging, mean_out, hmean,
                                    ticket, stream);
}

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
