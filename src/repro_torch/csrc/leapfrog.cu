// Fused leapfrog half-step for HMC/NUTS with a diagonal mass matrix.
//
// Replaces the Pallas TPU kernel src/repro/kernels/leapfrog.py:_kernel
// (reached through leapfrog_halfstep, leapfrog.py:40).  One pass computes
//     r' = r - (eps / 2) * g
//     z' = z + eps * (r' * m_inv)
// over flat (D,) vectors, in float or double (the TPU kernel computes in
// promote(dtype, f32), so f32 chains stay f32 and f64 chains stay f64).
//
// eps is read from a device scalar: NUTS negates it when growing the tree
// leftwards and dual averaging rescales it every warmup step, and passing
// it as a host value would cost a device->host read per launch.
//
// What bounds it: at the main path's D = 54 the kernel moves 6 * 54 * 4 B,
// so its time is launch latency, not bytes or operations.  At D ~ 1e6 it is
// bound by bytes (four reads and two writes per element), which the
// grid-stride loop streams with neighbouring threads on neighbouring
// addresses.  The TPU wrapper pads D to the block; here the tail is simply
// masked by the loop bound.  Inside a NUTS subtree this step runs fused into
// the leaf kernel below; it stays on its own for a subtree's first leaf, the
// step-size search and HMC's fixed trajectory.
//
// The NUTS leaf (nuts_leaf_f32/f64).  Inside a subtree, one launch between
// two potential evaluations does all the work of a leaf that is not the
// potential (the JAX package runs it inside the lax.while_loop of
// src/repro/core/infer/hmc_util.py's iterative_build_subtree, around the
// TPU kernel above):
//     r_k = r_half_k - (eps / 2) * g_k                  close leapfrog k
//     ke_k = 0.5 * sum(m_inv * r_k^2)                   its kinetic energy
//     r_sum_through = r_sum + r_k  (r_k on a first leaf)
//     even leaf: r_k, r_sum_through -> checkpoint row ckpt_i (in place)
//     odd leaf: the two U-turn dots against checkpoint rows idx_min..idx_max
//     vals = [pe_k, ke_k, left dots..., right dots...]  the leaf's one read
//     r_half_{k+1} = r_k - (eps / 2) * g_k,
//     z_{k+1} = z_k + eps * (r_half_{k+1} * m_inv)      open leapfrog k + 1
// The opening is speculative: if the host stops the subtree it drops
// z_{k+1} and r_half_{k+1} unread.  nuts_turning_f32/f64 forms the same two
// dots for the merged tree's U-turn check, once per doubling.
//
// Every vector element is rounded operation by operation (__fmul_rn, ...),
// so r_k, r_sum_through, the checkpoint rows, z_{k+1} and r_half_{k+1} are
// bit-identical to the plain PyTorch version; only the sums (ke, the dots)
// are taken in another order, in double (each term rounded in T first).  What
// bounds it: at the main path's D (54,
// 176, 33) one CTA does everything and the cost is the launch.  At large D
// it is bytes: per-CTA partial sums (a fixed grid-stride partition, a
// fixed-order block reduction), then the last CTA to take an integer ticket
// folds the CTAs' partials in CTA order and leaves the ticket at zero, so
// repeated calls are bit-identical.  The dots of up to kRowsPerPass
// checkpoint rows are formed per pass over D; an odd leaf has on average
// one row.
//
// Lockstep NUTS over C chains (the JAX package's vmap of this step over
// chains) runs the batched forms at the end of the file: nuts_leaf_batch
// (one launch a lockstep leaf for every chain), nuts_turning_batch (the
// (C, 2) dots of the merged trees, once a doubling) and halfstep_chains
// (a subtree's opening per chain, and lockstep HMC's kick and drift).  Each
// chain has its own signed step size, m_inv row and active flag; a grid row
// (blockIdx.y) per chain runs exactly the CTAs and the code of the one-chain
// kernel, so each chain's results are bit-identical to a one-chain launch.
// What bounds them: at logreg's (8, 54) a launch moves ~14 KB, so its cost
// is the launch; the host's one launch for C chains is what they buy.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void leapfrog_halfstep_kernel(const T* __restrict__ eps_ptr,
                                         const T* __restrict__ z,
                                         const T* __restrict__ r,
                                         const T* __restrict__ g,
                                         const T* __restrict__ m_inv,
                                         T* __restrict__ z_out,
                                         T* __restrict__ r_out,
                                         long long n) {
  const T eps = *eps_ptr;
  const T half_eps = T(0.5) * eps;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T r_new = r[i] - half_eps * g[i];
    r_out[i] = r_new;
    z_out[i] = z[i] + eps * (r_new * m_inv[i]);
  }
}

template <typename T>
cudaError_t launch(const void* eps, const void* z, const void* r,
                   const void* g, const void* m_inv, void* z_out, void* r_out,
                   long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  leapfrog_halfstep_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)eps, (const T*)z, (const T*)r, (const T*)g, (const T*)m_inv,
      (T*)z_out, (T*)r_out, n);
  return cudaGetLastError();
}

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

constexpr int kRedThreads = 256;
constexpr int kRedWarps = kRedThreads / 32;
constexpr int kElemsPerThread = 4;  // elements a thread sums before a new CTA
constexpr int kMaxRedCtas = 264;    // 2 per SM of an H100
constexpr int kRowsPerPass = 4;     // checkpoint rows a pass over D serves
constexpr int kMaxRows = 32;        // checkpoint rows an odd leaf may read
constexpr int kPassSums = 1 + 2 * kRowsPerPass;
constexpr int kMaxSums = 1 + 2 * kMaxRows;
constexpr int kMaxBatchChains = 65535;  // gridDim.y

// The grid depends on D only, so each element's place in the sums does too.
int reduce_ctas(long long n) {
  long long b = (n + kRedThreads * kElemsPerThread - 1) /
                (kRedThreads * kElemsPerThread);
  if (b < 1) b = 1;
  if (b > kMaxRedCtas) b = kMaxRedCtas;
  return (int)b;
}

// NV per-thread sums -> out[0..NV) in shared memory, in a fixed order: a
// shuffle tree within each warp, then the warps in order.  Ends synced.
template <typename T, int NV>
__device__ void block_sums(const T (&acc)[NV], T* warp_buf, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    T x = acc[v];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = add_rn(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) warp_buf[warp * NV + v] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    T s = warp_buf[threadIdx.x];
    for (int w = 1; w < kRedWarps; ++w)
      s = add_rn(s, warp_buf[w * NV + threadIdx.x]);
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// With more than one CTA: each CTA puts its nsums totals (sums, shared) in
// part[cta * nsums ...]; the last CTA to take the ticket folds every CTA's
// totals in CTA order into sums, resets the ticket and returns true.  The
// other CTAs return false.
template <typename T>
__device__ bool fold_ctas(T* sums, int nsums, T* part, int* ticket) {
  __shared__ int last;
  for (int s = threadIdx.x; s < nsums; s += blockDim.x)
    part[(long long)blockIdx.x * nsums + s] = sums[s];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    last = t == (int)gridDim.x - 1;
    if (last) *ticket = 0;  // every CTA has counted
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int s = threadIdx.x; s < nsums; s += blockDim.x) {
    T v = __ldcg(part + s);
    for (unsigned b = 1; b < gridDim.x; ++b)
      v = add_rn(v, __ldcg(part + (long long)b * nsums + s));
    sums[s] = v;
  }
  __syncthreads();
  return true;
}

// One chain's leaf over the CTAs of gridDim.x (blockIdx.x the CTA): the
// body of nuts_leaf_kernel and, per chain, of nuts_leaf_batch_kernel, so the
// two form every vector and every sum the same way.
template <typename T>
__device__ __forceinline__ void leaf_body(
    const T eps, const T* __restrict__ pe, const T* __restrict__ r_half,
    const T* __restrict__ z, const T* __restrict__ g,
    const T* __restrict__ m_inv, const T* __restrict__ r_sum, T* r_ckpts,
    T* r_sum_ckpts, int ckpt_i, int idx_min, int rows, long long n,
    T* __restrict__ r_out, T* __restrict__ r_sum_out,
    T* __restrict__ z_next, T* __restrict__ r_half_next,
    T* __restrict__ vals, double* part, int* ticket) {
  __shared__ double warp_buf[kRedWarps * kPassSums];
  __shared__ double tot[kPassSums];
  __shared__ double sums[kMaxSums];
  const T half_eps = mul_rn(T(0.5), eps);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int passes = rows == 0 ? 1 : (rows + kRowsPerPass - 1) / kRowsPerPass;
  for (int p = 0; p < passes; ++p) {
    const int j0 = p * kRowsPerPass;
    double acc[kPassSums];
#pragma unroll
    for (int v = 0; v < kPassSums; ++v) acc[v] = 0.0;
    for (long long i = first; i < n; i += stride) {
      const T mi = m_inv[i];
      const T hg = mul_rn(half_eps, g[i]);
      const T r = sub_rn(r_half[i], hg);
      const T rs = r_sum == nullptr ? r : add_rn(r_sum[i], r);
      if (p == 0) {
        r_out[i] = r;
        if (r_sum != nullptr) r_sum_out[i] = rs;
        if (ckpt_i >= 0) {
          r_ckpts[(long long)ckpt_i * n + i] = r;
          r_sum_ckpts[(long long)ckpt_i * n + i] = rs;
        }
        const T rn = sub_rn(r, hg);
        r_half_next[i] = rn;
        z_next[i] = add_rn(z[i], mul_rn(eps, mul_rn(rn, mi)));
        acc[0] += (double)mul_rn(r, mul_rn(mi, r));
      }
      const T mr = mul_rn(mi, r);
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        if (j0 + k < rows) {
          const long long o = (long long)(idx_min + j0 + k) * n + i;
          const T rc = r_ckpts[o];
          // the subtree's momentum sum, then r_sum - (r_left + r_right) / 2
          const T sub = add_rn(sub_rn(rs, r_sum_ckpts[o]), rc);
          const T mid = sub_rn(sub, mul_rn(T(0.5), add_rn(rc, r)));
          acc[1 + k] += (double)mul_rn(mul_rn(mi, rc), mid);
          acc[1 + kRowsPerPass + k] += (double)mul_rn(mr, mid);
        }
      }
    }
    block_sums<double, kPassSums>(acc, warp_buf, tot);
    // sums: [sum r m r, left dot of each row..., right dot of each row...]
    const int v = threadIdx.x;
    if (v == 0) {
      if (p == 0) sums[0] = tot[0];
    } else if (v <= kRowsPerPass) {
      if (j0 + v - 1 < rows) sums[j0 + v] = tot[v];
    } else if (v < kPassSums) {
      const int k = v - 1 - kRowsPerPass;
      if (j0 + k < rows) sums[1 + rows + j0 + k] = tot[v];
    }
    __syncthreads();
  }
  const int nsums = 1 + 2 * rows;
  if (gridDim.x > 1 && !fold_ctas(sums, nsums, part, ticket)) return;
  if (threadIdx.x == 0) {
    vals[0] = *pe;
    vals[1] = (T)(0.5 * sums[0]);
  }
  for (int s = 1 + threadIdx.x; s < nsums; s += blockDim.x)
    vals[1 + s] = (T)sums[s];
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads) nuts_leaf_kernel(
    const T* __restrict__ eps_ptr, const T* __restrict__ pe,
    const T* __restrict__ r_half, const T* __restrict__ z,
    const T* __restrict__ g, const T* __restrict__ m_inv,
    const T* __restrict__ r_sum, T* r_ckpts, T* r_sum_ckpts, int ckpt_i,
    int idx_min, int rows, long long n, T* __restrict__ r_out,
    T* __restrict__ r_sum_out, T* __restrict__ z_next,
    T* __restrict__ r_half_next, T* __restrict__ vals, double* part,
    int* ticket) {
  leaf_body<T>(*eps_ptr, pe, r_half, z, g, m_inv, r_sum, r_ckpts,
               r_sum_ckpts, ckpt_i, idx_min, rows, n, r_out, r_sum_out,
               z_next, r_half_next, vals, part, ticket);
}

// The generalized U-turn dots of one tree: sum(m_inv r_left r_mid) and
// sum(m_inv r_right r_mid), r_mid = r_sum - (r_left + r_right) / 2.
template <typename T>
__device__ __forceinline__ void turning_body(
    const T* __restrict__ m_inv, const T* __restrict__ r_left,
    const T* __restrict__ r_right, const T* __restrict__ r_sum, long long n,
    T* __restrict__ out, double* part, int* ticket) {
  __shared__ double warp_buf[kRedWarps * 2];
  __shared__ double sums[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  double acc[2] = {0.0, 0.0};
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T mi = m_inv[i], rl = r_left[i], rr = r_right[i];
    const T mid = sub_rn(r_sum[i], mul_rn(T(0.5), add_rn(rl, rr)));
    acc[0] += (double)mul_rn(mul_rn(mi, rl), mid);
    acc[1] += (double)mul_rn(mul_rn(mi, rr), mid);
  }
  block_sums<double, 2>(acc, warp_buf, sums);
  if (gridDim.x > 1 && !fold_ctas(sums, 2, part, ticket)) return;
  if (threadIdx.x < 2) out[threadIdx.x] = (T)sums[threadIdx.x];
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads) nuts_turning_kernel(
    const T* __restrict__ m_inv, const T* __restrict__ r_left,
    const T* __restrict__ r_right, const T* __restrict__ r_sum, long long n,
    T* __restrict__ out, double* part, int* ticket) {
  turning_body<T>(m_inv, r_left, r_right, r_sum, n, out, part, ticket);
}

// ---------------------------------------------------------------------------
// The chain-batched forms for lockstep NUTS over C chains (the JAX package's
// vmap of the leaf over chains).  blockIdx.y is the chain; each chain gets
// the CTAs nuts_leaf would run for it alone (blockIdx.x), with its own rows
// of every (C, D) operand, its own m_inv row, its own signed eps and pe, its
// own checkpoint block (C, depth, D), its own slice of the partials and its
// own fold ticket.  So chain c's vectors and sums are bit-identical to a
// nuts_leaf / nuts_turning launch on chain c alone.  A chain whose active
// flag is 0 (its tree has stopped, or its subtree has) is copied through:
// r_out and r_half_next are r_half, r_sum_out is r_sum, z_next is z, its
// checkpoint rows are untouched and its vals row is zero.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kRedThreads) nuts_leaf_batch_kernel(
    const T* __restrict__ eps, const T* __restrict__ pe,
    const unsigned char* __restrict__ active, const T* __restrict__ r_half,
    const T* __restrict__ z, const T* __restrict__ g,
    const T* __restrict__ m_inv, const T* __restrict__ r_sum, T* r_ckpts,
    T* r_sum_ckpts, int depth, int ckpt_i, int idx_min, int rows,
    long long n, T* __restrict__ r_out, T* __restrict__ r_sum_out,
    T* __restrict__ z_next, T* __restrict__ r_half_next,
    T* __restrict__ vals, double* part, int* ticket) {
  const long long c = blockIdx.y;
  const long long o = c * n;
  const int nvals = 2 + 2 * rows;
  if (!active[c]) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      const T rh = r_half[o + i];
      r_out[o + i] = rh;
      r_half_next[o + i] = rh;
      z_next[o + i] = z[o + i];
      if (r_sum_out != nullptr) r_sum_out[o + i] = r_sum[o + i];
    }
    if (blockIdx.x == 0)
      for (int s = threadIdx.x; s < nvals; s += blockDim.x)
        vals[c * nvals + s] = T(0);
    return;
  }
  const long long ck = c * (long long)depth * n;
  leaf_body<T>(eps[c], pe + c, r_half + o, z + o, g + o, m_inv + o,
               r_sum == nullptr ? nullptr : r_sum + o, r_ckpts + ck,
               r_sum_ckpts + ck, ckpt_i, idx_min, rows, n, r_out + o,
               r_sum_out == nullptr ? nullptr : r_sum_out + o, z_next + o,
               r_half_next + o, vals + c * nvals,
               part == nullptr ? nullptr
                               : part + c * gridDim.x * (1 + 2 * rows),
               ticket == nullptr ? nullptr : ticket + c);
}

template <typename T>
__global__ void __launch_bounds__(kRedThreads) nuts_turning_batch_kernel(
    const T* __restrict__ m_inv, const T* __restrict__ r_left,
    const T* __restrict__ r_right, const T* __restrict__ r_sum, long long n,
    T* __restrict__ out, double* part, int* ticket) {
  const long long c = blockIdx.y;
  const long long o = c * n;
  turning_body<T>(m_inv + o, r_left + o, r_right + o, r_sum + o, n,
                  out + 2 * c,
                  part == nullptr ? nullptr : part + c * gridDim.x * 2,
                  ticket == nullptr ? nullptr : ticket + c);
}

// The half-step over C chains, each with its own signed eps and m_inv row:
// a subtree's opening leapfrog in lockstep NUTS and every leapfrog's opening
// in lockstep HMC.  An inactive chain is copied through.  Rounded operation
// by operation, so it is bit-identical to the plain version row by row.
template <typename T>
__global__ void halfstep_chains_kernel(
    const T* __restrict__ eps, const unsigned char* __restrict__ active,
    const T* __restrict__ z, const T* __restrict__ r,
    const T* __restrict__ g, const T* __restrict__ m_inv,
    T* __restrict__ z_out, T* __restrict__ r_out, long long n) {
  const long long c = blockIdx.y;
  const long long o = c * n;
  const bool on = active[c] != 0;
  const T e = eps[c];
  const T half_eps = mul_rn(T(0.5), e);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (on) {
      const T rn = sub_rn(r[o + i], mul_rn(half_eps, g[o + i]));
      r_out[o + i] = rn;
      z_out[o + i] = add_rn(z[o + i], mul_rn(e, mul_rn(rn, m_inv[o + i])));
    } else {
      r_out[o + i] = r[o + i];
      z_out[o + i] = z[o + i];
    }
  }
}

template <typename T>
cudaError_t launch_leaf(const void* eps, const void* pe, const void* r_half,
                        const void* z, const void* g, const void* m_inv,
                        const void* r_sum, void* r_ckpts, void* r_sum_ckpts,
                        int ckpt_i, int idx_min, int rows, long long n,
                        void* r_out, void* r_sum_out, void* z_next,
                        void* r_half_next, void* vals, void* part,
                        void* ticket, void* stream) {
  const int ctas = n > 0 ? reduce_ctas(n) : 0;
  if (n <= 0 || rows < 0 || rows > kMaxRows || (ckpt_i >= 0 && rows > 0) ||
      (ctas > 1 && (part == nullptr || ticket == nullptr)) ||
      (r_sum != nullptr && r_sum_out == nullptr))
    return cudaErrorInvalidValue;
  nuts_leaf_kernel<T><<<ctas, kRedThreads, 0, (cudaStream_t)stream>>>(
      (const T*)eps, (const T*)pe, (const T*)r_half, (const T*)z,
      (const T*)g, (const T*)m_inv, (const T*)r_sum, (T*)r_ckpts,
      (T*)r_sum_ckpts, ckpt_i, idx_min, rows, n, (T*)r_out, (T*)r_sum_out,
      (T*)z_next, (T*)r_half_next, (T*)vals, (double*)part, (int*)ticket);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_turning(const void* m_inv, const void* r_left,
                           const void* r_right, const void* r_sum,
                           long long n, void* out, void* part, void* ticket,
                           void* stream) {
  const int ctas = n > 0 ? reduce_ctas(n) : 0;
  if (n <= 0 || (ctas > 1 && (part == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  nuts_turning_kernel<T><<<ctas, kRedThreads, 0, (cudaStream_t)stream>>>(
      (const T*)m_inv, (const T*)r_left, (const T*)r_right, (const T*)r_sum,
      n, (T*)out, (double*)part, (int*)ticket);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_leaf_batch(const void* eps, const void* pe,
                              const void* active, const void* r_half,
                              const void* z, const void* g, const void* m_inv,
                              const void* r_sum, void* r_ckpts,
                              void* r_sum_ckpts, int depth, int ckpt_i,
                              int idx_min, int rows, long long chains,
                              long long n, void* r_out, void* r_sum_out,
                              void* z_next, void* r_half_next, void* vals,
                              void* part, void* ticket, void* stream) {
  const int ctas = n > 0 ? reduce_ctas(n) : 0;
  if (n <= 0 || chains <= 0 || chains > kMaxBatchChains || rows < 0 ||
      rows > kMaxRows || (ckpt_i >= 0 && rows > 0) || depth < 1 ||
      ckpt_i >= depth || idx_min < 0 || idx_min + rows > depth ||
      (ctas > 1 && (part == nullptr || ticket == nullptr)) ||
      (r_sum != nullptr && r_sum_out == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)ctas, (unsigned)chains);
  nuts_leaf_batch_kernel<T><<<grid, kRedThreads, 0, (cudaStream_t)stream>>>(
      (const T*)eps, (const T*)pe, (const unsigned char*)active,
      (const T*)r_half, (const T*)z, (const T*)g, (const T*)m_inv,
      (const T*)r_sum, (T*)r_ckpts, (T*)r_sum_ckpts, depth, ckpt_i, idx_min,
      rows, n, (T*)r_out, (T*)r_sum_out, (T*)z_next, (T*)r_half_next,
      (T*)vals, (double*)part, (int*)ticket);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_turning_batch(const void* m_inv, const void* r_left,
                                 const void* r_right, const void* r_sum,
                                 long long chains, long long n, void* out,
                                 void* part, void* ticket, void* stream) {
  const int ctas = n > 0 ? reduce_ctas(n) : 0;
  if (n <= 0 || chains <= 0 || chains > kMaxBatchChains ||
      (ctas > 1 && (part == nullptr || ticket == nullptr)))
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)ctas, (unsigned)chains);
  nuts_turning_batch_kernel<T>
      <<<grid, kRedThreads, 0, (cudaStream_t)stream>>>(
          (const T*)m_inv, (const T*)r_left, (const T*)r_right,
          (const T*)r_sum, n, (T*)out, (double*)part, (int*)ticket);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_halfstep_chains(const void* eps, const void* active,
                                   const void* z, const void* r,
                                   const void* g, const void* m_inv,
                                   void* z_out, void* r_out, long long chains,
                                   long long n, void* stream) {
  if (n <= 0 || chains <= 0 || chains > kMaxBatchChains)
    return cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 1024) blocks = 1024;  // grid-stride beyond this
  dim3 grid((unsigned)blocks, (unsigned)chains);
  halfstep_chains_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)eps, (const unsigned char*)active, (const T*)z, (const T*)r,
      (const T*)g, (const T*)m_inv, (T*)z_out, (T*)r_out, n);
  return cudaGetLastError();
}

}  // namespace

// Chains a batched launch takes (blockIdx.y).
extern "C" int nuts_batch_max_chains() { return kMaxBatchChains; }

// nuts_leaf over C chains: every vector operand is (C, D) (rows of one
// chain contiguous), eps and pe (C,), active (C,) bytes, the checkpoints
// (C, depth, D); ckpt_i, idx_min and rows are shared (every active chain is
// at the same leaf of the same doubling).  vals is (C, 2 + 2 * rows).
// part holds C * nuts_reduce_ctas(n) * (1 + 2 * rows) doubles and ticket C
// zeroed ints (both may be null with one CTA a chain).
extern "C" int nuts_leaf_batch_f32(
    const void* eps, const void* pe, const void* active, const void* r_half,
    const void* z, const void* g, const void* m_inv, const void* r_sum,
    void* r_ckpts, void* r_sum_ckpts, int depth, int ckpt_i, int idx_min,
    int rows, long long chains, long long n, void* r_out, void* r_sum_out,
    void* z_next, void* r_half_next, void* vals, void* part, void* ticket,
    void* stream) {
  return (int)launch_leaf_batch<float>(
      eps, pe, active, r_half, z, g, m_inv, r_sum, r_ckpts, r_sum_ckpts,
      depth, ckpt_i, idx_min, rows, chains, n, r_out, r_sum_out, z_next,
      r_half_next, vals, part, ticket, stream);
}

extern "C" int nuts_leaf_batch_f64(
    const void* eps, const void* pe, const void* active, const void* r_half,
    const void* z, const void* g, const void* m_inv, const void* r_sum,
    void* r_ckpts, void* r_sum_ckpts, int depth, int ckpt_i, int idx_min,
    int rows, long long chains, long long n, void* r_out, void* r_sum_out,
    void* z_next, void* r_half_next, void* vals, void* part, void* ticket,
    void* stream) {
  return (int)launch_leaf_batch<double>(
      eps, pe, active, r_half, z, g, m_inv, r_sum, r_ckpts, r_sum_ckpts,
      depth, ckpt_i, idx_min, rows, chains, n, r_out, r_sum_out, z_next,
      r_half_next, vals, part, ticket, stream);
}

// The (C, 2) U-turn dots of C trees; part holds C * nuts_reduce_ctas(n) * 2
// doubles and ticket C zeroed ints (null with one CTA a chain).
extern "C" int nuts_turning_batch_f32(const void* m_inv, const void* r_left,
                                      const void* r_right, const void* r_sum,
                                      long long chains, long long n, void* out,
                                      void* part, void* ticket, void* stream) {
  return (int)launch_turning_batch<float>(m_inv, r_left, r_right, r_sum,
                                          chains, n, out, part, ticket,
                                          stream);
}

extern "C" int nuts_turning_batch_f64(const void* m_inv, const void* r_left,
                                      const void* r_right, const void* r_sum,
                                      long long chains, long long n, void* out,
                                      void* part, void* ticket, void* stream) {
  return (int)launch_turning_batch<double>(m_inv, r_left, r_right, r_sum,
                                           chains, n, out, part, ticket,
                                           stream);
}

// The half-step over C chains: eps (C,) signed, active (C,) bytes, every
// other operand (C, D).
extern "C" int halfstep_chains_f32(const void* eps, const void* active,
                                   const void* z, const void* r, const void* g,
                                   const void* m_inv, void* z_out, void* r_out,
                                   long long chains, long long n,
                                   void* stream) {
  return (int)launch_halfstep_chains<float>(eps, active, z, r, g, m_inv,
                                            z_out, r_out, chains, n, stream);
}

extern "C" int halfstep_chains_f64(const void* eps, const void* active,
                                   const void* z, const void* r, const void* g,
                                   const void* m_inv, void* z_out, void* r_out,
                                   long long chains, long long n,
                                   void* stream) {
  return (int)launch_halfstep_chains<double>(eps, active, z, r, g, m_inv,
                                             z_out, r_out, chains, n, stream);
}

// CTAs of a nuts_leaf / nuts_turning launch over n elements: part then
// holds nuts_reduce_ctas(n) * (1 + 2 * rows) (leaf) or * 2 (turning)
// doubles; with one CTA part and ticket may be null.
extern "C" int nuts_reduce_ctas(long long n) {
  return n > 0 ? reduce_ctas(n) : 0;
}

extern "C" int nuts_leaf_max_rows() { return kMaxRows; }

// ckpt_i >= 0 writes checkpoint row ckpt_i (an even leaf, rows == 0);
// rows > 0 forms the dots against rows idx_min .. idx_min + rows - 1; r_sum
// null is a subtree's first leaf (r_sum_through is r_out, r_sum_out unused).
extern "C" int nuts_leaf_f32(const void* eps, const void* pe,
                             const void* r_half, const void* z, const void* g,
                             const void* m_inv, const void* r_sum,
                             void* r_ckpts, void* r_sum_ckpts, int ckpt_i,
                             int idx_min, int rows, long long n, void* r_out,
                             void* r_sum_out, void* z_next, void* r_half_next,
                             void* vals, void* part, void* ticket,
                             void* stream) {
  return (int)launch_leaf<float>(eps, pe, r_half, z, g, m_inv, r_sum, r_ckpts,
                                 r_sum_ckpts, ckpt_i, idx_min, rows, n, r_out,
                                 r_sum_out, z_next, r_half_next, vals, part,
                                 ticket, stream);
}

extern "C" int nuts_leaf_f64(const void* eps, const void* pe,
                             const void* r_half, const void* z, const void* g,
                             const void* m_inv, const void* r_sum,
                             void* r_ckpts, void* r_sum_ckpts, int ckpt_i,
                             int idx_min, int rows, long long n, void* r_out,
                             void* r_sum_out, void* z_next, void* r_half_next,
                             void* vals, void* part, void* ticket,
                             void* stream) {
  return (int)launch_leaf<double>(eps, pe, r_half, z, g, m_inv, r_sum,
                                  r_ckpts, r_sum_ckpts, ckpt_i, idx_min, rows,
                                  n, r_out, r_sum_out, z_next, r_half_next,
                                  vals, part, ticket, stream);
}

extern "C" int nuts_turning_f32(const void* m_inv, const void* r_left,
                                const void* r_right, const void* r_sum,
                                long long n, void* out, void* part,
                                void* ticket, void* stream) {
  return (int)launch_turning<float>(m_inv, r_left, r_right, r_sum, n, out,
                                    part, ticket, stream);
}

extern "C" int nuts_turning_f64(const void* m_inv, const void* r_left,
                                const void* r_right, const void* r_sum,
                                long long n, void* out, void* part,
                                void* ticket, void* stream) {
  return (int)launch_turning<double>(m_inv, r_left, r_right, r_sum, n, out,
                                     part, ticket, stream);
}

extern "C" int leapfrog_halfstep_f32(const void* eps, const void* z,
                                     const void* r, const void* g,
                                     const void* m_inv, void* z_out,
                                     void* r_out, long long n, void* stream) {
  return (int)launch<float>(eps, z, r, g, m_inv, z_out, r_out, n, stream);
}

extern "C" int leapfrog_halfstep_f64(const void* eps, const void* z,
                                     const void* r, const void* g,
                                     const void* m_inv, void* z_out,
                                     void* r_out, long long n, void* stream) {
  return (int)launch<double>(eps, z, r, g, m_inv, z_out, r_out, n, stream);
}
