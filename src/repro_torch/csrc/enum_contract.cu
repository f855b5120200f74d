// Logsumexp contraction of discrete-latent chain elimination: the one-step
// forward and backward, and the chain forward and backward that run all
// T-1 steps of a chain in one launch each; and the chain's backward sample
// (forward-filter/backward-sample's second half, chain_sample_kernel below).
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
// max propagates NaN as torch.amax does.  The column's arithmetic is
// ColumnLse below, which every forward kernel here calls.
//
// Backward: there is no TPU kernel for it (the JAX package differentiates
// the jnp reference).  With p[b, i, j] = exp(alpha_i + M_ij - out_j), or 0
// where out_j = -inf (so no -inf - -inf NaN is ever formed),
//     dM[b, i, j] = g[b, j] * p[b, i, j],   dalpha[b, i] = sum_j dM[b, i, j]
// with the sum over j in fixed order, from 0.  The product and the sum are
// written with __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn), which the
// compiler never contracts into an FMA, so every backward kernel here
// (contract_grad below, and the same ordered sum) rounds alike.
//
// The chain.  markov (src/repro_torch/core/infer/enum.py) eliminates a
// chain of T states with T-1 contractions, alpha_{t+1} = contract(alpha_t,
// M_t), the JAX package's lax.scan over this kernel
// (src/repro/core/infer/enum.py:600).  One step at the main path's shape
// (one row, K = 8) touches under 400 bytes: its time is the launch, the
// autograd node and the host round around it, 119 of each per gradient.
// enum_chain_fwd runs the T-1 steps in one launch and writes every alpha to
// a (T, B, K) buffer; enum_chain_bwd runs the backward steps from those
// saved alphas in one launch, T-1 down to 1, carrying g on chip.  What
// bounds both at that shape is the chain of dependent steps (two passes of
// K adds, compares and expf, a logf, per step), not bytes, so the design
// keeps HBM off that chain:
// - K <= 32: one warp per batch row.  Forward: lane j owns column j and
//   holds alpha_j in a register; alpha_i reaches every lane by __shfl_sync,
//   so no barrier sits on the serial path.  Backward: lane i owns row i of
//   dM_t and sums it in order; g_j reaches it by __shfl_sync and out_j, the
//   alphas of the step before, stays in its registers, so a step is one
//   shuffle and one ordered sum deep.  M_t's rows are staged with an odd
//   stride, so the 32 lanes read 32 banks.  Lanes at or above K take part
//   in shuffles and copies and store nothing new.
//   A step's loops unroll over KMAX = 8, 16 or 32 >= K, the terms past K
//   padded (-inf in the forward's column, +0 in the backward's sum, which
//   leave the result bit for bit) and the stage copies predicated, so no
//   lane branches and the K expf of a step overlap (a branch per term
//   serialised them: 96 us for the forward at T = 120, K = 8 on an H100
//   against 34.5 us branch-free, chip_smoke.py's enum_chain timings).
// - K > 32: one CTA per row, min(K, 1024) threads (rounded to warps), each
//   owning columns j, j + blockDim, ...  alpha, g and out live in
//   double-buffered shared arrays: one barrier per tile.
// - M_t (and, backward, alpha_t) is staged into shared memory ahead of the
//   step that uses it, through a ring filled by cp.async (16-byte copies
//   where the source is aligned, 4-byte ones otherwise; the K <= 32
//   backward's padded rows element by element): kWarpStages = 8 steps per
//   warp for K <= 32, kCtaStages = 3 tiles per CTA for K > 32.
//   At K = 8 one step's matrix is 256 B, so 7 steps (~2 us of the chain)
//   are in flight while one is reduced: the chain never waits on HBM after
//   its first step.  A K > 32 tile is the whole matrix when 3 of them fit,
//   else a chunk of its rows; the forward's two passes then read the
//   chunks twice.
// Each chain kernel runs the one-step kernels' arithmetic (ColumnLse,
// contract_grad, the ordered sum), so the chain forward is bit-identical to
// T-1 one-step launches and to T-1 calls of the plain version, and the
// chain backward to T-1 one-step backward launches.
//
// What bounds the one-step kernels: at the main path's shape both touch
// under 400 bytes: their time is the launch.  At B = 16384, Ki = K = 64 the
// forward reads 4 B * B * Ki * (K + 1) once and is bound by bytes; a warp's
// 32 threads read 32 neighbouring columns of one row of M, so the loads
// coalesce, and the second pass over i re-reads M from L1/L2.  The Pallas
// kernel pads to (8, 128) tiles and walks a sequential grid over rows; here
// the grid is a flat grid-stride loop over (row, column) pairs, nothing is
// padded, and rows need no order.
#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
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

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // grid-stride beyond this
constexpr int kWarpStages = 8;  // ring depth of the K <= 32 chain kernels
constexpr int kCtaStages = 3;   // ring depth of the K > 32 chain kernels
constexpr int kMaxWarps = 4;    // rows per CTA of the K <= 32 kernels
constexpr int kMaxCols = 4;     // columns per thread: K <= 4096
constexpr int kSmemBudget = 200 * 1024;  // dynamic shared memory per CTA
constexpr int kTileMax = 64 * 1024;      // one K > 32 tile

long long blocks_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// n elements rounded up to 16 bytes
template <typename T>
__host__ __device__ __forceinline__ int padded(int n) {
  constexpr int per = 16 / (int)sizeof(T);
  return (n + per - 1) / per * per;
}

// One output column of the contraction, fed x_i = alpha_i + M_ij in order
// i = 0, 1, ...: first the max pass, then settle(), then the sum pass.
// Written as selects, not branches: the lanes of a warp own different
// columns, and a divergent branch a step costs more than the arithmetic.
// A term x = -inf leaves the column as it was (the max keeps its value,
// the sum adds exp(-inf) = +0 to s >= +0), so a chain kernel may pad a
// column with -inf terms.
template <typename T>
struct ColumnLse {
  T mx, m_safe, s;
  bool finite;
  __device__ __forceinline__ void max_first(T x) { mx = x; }
  __device__ __forceinline__ void max_next(T x) {
    mx = (x > mx || isnan(x)) ? x : mx;
  }
  __device__ __forceinline__ void settle() {
    finite = isfinite(mx);
    m_safe = finite ? mx : T(0);
  }
  __device__ __forceinline__ void sum_first(T x) { s = exp_(x - m_safe); }
  __device__ __forceinline__ void sum_next(T x) { s = s + exp_(x - m_safe); }
  __device__ __forceinline__ T result() const {
    const T r = log_(s) + m_safe;
    return finite ? r : T(-INFINITY);
  }
};

// logsumexp_i(a(i) + m(i)) over i < ki, for accessors a and m
template <typename T, typename A, typename M>
__device__ __forceinline__ T contract_column(const A& a, const M& m, int ki) {
  ColumnLse<T> c;
  c.max_first(a(0) + m(0));
  for (int i = 1; i < ki; ++i) c.max_next(a(i) + m(i));
  c.settle();
  c.sum_first(a(0) + m(0));
  for (int i = 1; i < ki; ++i) c.sum_next(a(i) + m(i));
  return c.result();
}

// dM_ij from alpha_i, M_ij, out_j and g_j (a select, as ColumnLse)
template <typename T>
__device__ __forceinline__ T contract_grad(T a, T m, T o, T g) {
  const T e = exp_((a + m) - o);
  const T p = (o == T(-INFINITY)) ? T(0) : e;
  return mul_rn(g, p);
}

// Whether n elements at src can move as 16-byte copies
template <typename T>
__device__ __forceinline__ bool vec16(const T* src, int n) {
  return ((n * (int)sizeof(T)) & 15) == 0 && tc::aligned16(src);
}

// Start copying n elements from global src to shared dst (16-byte aligned)
// with the threads lane, lane + nthr, ...; 16-byte copies if vec (vec16).
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, int n,
                                           int lane, int nthr, bool vec) {
  const int bytes = n * (int)sizeof(T);
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  if (vec) {
    for (int v = lane; v < bytes / 16; v += nthr)
      tc::cp_async16(d + 16 * v, s + 16 * v, true);
  } else {
    for (int w = lane; w < bytes / 4; w += nthr)
      tc::cp_async4(d + 4 * w, s + 4 * w, true);
  }
}

// 16 and 4 bytes global -> shared where pred, as one predicated
// instruction (no branch)
__device__ __forceinline__ void cp_async16_if(void* dst, const void* src,
                                              bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n" ::"r"(
          tc::smem_u32(dst)),
      "l"(src), "r"((int)pred));
}

__device__ __forceinline__ void cp_async4_if(void* dst, const void* src,
                                             bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(
          tc::smem_u32(dst)),
      "l"(src), "r"((int)pred));
}

// stage_copy by the 32 lanes of one warp for n <= NMAX elements, if on:
// both kinds of copy unrolled and predicated (16-byte where vec, else
// 4-byte), so no lane branches
template <typename T, int NMAX>
__device__ __forceinline__ void warp_copy(T* dst, const T* src, int n,
                                          int lane, bool vec, bool on) {
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  const int bytes = n * (int)sizeof(T);
  constexpr int per16 = (NMAX * (int)sizeof(T) / 16 + 31) / 32;
  constexpr int per4 = (NMAX * (int)sizeof(T) / 4 + 31) / 32;
#pragma unroll
  for (int c = 0; c < per16; ++c) {
    const int v = lane + 32 * c;
    cp_async16_if(d + 16 * v, s + 16 * v, on & vec & (v < bytes / 16));
  }
#pragma unroll
  for (int c = 0; c < per4; ++c) {
    const int w = lane + 32 * c;
    cp_async4_if(d + 4 * w, s + 4 * w, on & !vec & (w < bytes / 4));
  }
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
    out[t] = contract_column<T>([&](int i) { return a[i]; },
                                [&](int i) { return m[(long long)i * k]; },
                                ki);
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
      const T dmij = contract_grad(a, m[j], o[j], gb[j]);
      dm[j] = dmij;
      acc = add_rn(acc, dmij);
    }
    d_alpha[t] = acc;
  }
}

// ---- the chain, K <= 32: one warp per row --------------------------------

// Shared memory per warp: the ring of kWarpStages steps.  A forward step
// is M_t; a backward step is M_s with its rows padded to K | 1 (odd, so
// lane i reading row i finds its own bank), then alpha_s.
template <typename T>
__host__ __device__ __forceinline__ int warp_stage(int k, bool bwd) {
  return bwd ? padded<T>(k * (k | 1)) + padded<T>(k) : padded<T>(k * k);
}

template <typename T>
__host__ __device__ __forceinline__ int warp_smem(int k, bool bwd) {
  return kWarpStages * warp_stage<T>(k, bwd) * (int)sizeof(T);
}

// One element global -> shared where pred (4 or 8 bytes), predicated
__device__ __forceinline__ void cp_async_elem_if(float* dst, const float* src,
                                                 bool pred) {
  cp_async4_if(dst, src, pred);
}

__device__ __forceinline__ void cp_async_elem_if(double* dst,
                                                 const double* src,
                                                 bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 8;\n}\n" ::"r"(
          tc::smem_u32(dst)),
      "l"(src), "r"((int)pred));
}

// The K x K matrix at src (row-major) into shared dst with row stride ld,
// if on: lane j copies element j of each row, predicated
template <typename T, int KMAX>
__device__ __forceinline__ void warp_copy_rows(T* dst, int ld, const T* src,
                                               int k, int lane, bool on) {
  const bool col = on & (lane < k);
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    cp_async_elem_if(dst + i * ld + lane, src + i * k + lane, col & (i < k));
}

template <typename T, int KMAX>
__global__ void chain_fwd_warp_kernel(const T* __restrict__ alpha0,
                                      const T* __restrict__ mats,
                                      T* __restrict__ alphas, long long rows,
                                      int steps, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= rows) return;  // no barrier beyond the warp in this kernel
  const int kk = k * k, stage = warp_stage<T>(k, false);
  T* ring = reinterpret_cast<T*>(smem_raw) +
            (size_t)warp * (warp_smem<T>(k, false) / sizeof(T));
  const T* src = mats + b * kk;
  const long long step = rows * kk;
  // every step's matrix sits at a multiple of kk elements from mats
  const bool vec = vec16(mats, kk);
  auto issue = [&](int t) {  // an empty group past the last step
    warp_copy<T, KMAX * KMAX>(ring + (t % kWarpStages) * stage,
                              src + (t < steps ? t : 0) * step, kk, lane,
                              vec, t < steps);
    tc::cp_async_commit();
  };
  for (int t = 0; t < kWarpStages - 1; ++t) issue(t);
  const int j = lane < k ? lane : k - 1;
  T* out = alphas + b * k + lane;
  const long long out_step = rows * k;
  T alpha = alpha0[b * k + j];
  if (lane < k) out[0] = alpha;
  for (int t = 0; t < steps; ++t) {
    tc::cp_async_wait<kWarpStages - 2>();  // step t's matrix has landed
    __syncwarp();
    issue(t + kWarpStages - 1);  // into the slot step t - 1 read
    const T* m = ring + (t % kWarpStages) * stage + j;
    T x[KMAX];  // x_i = alpha_i + M_ij, -inf past K (ColumnLse's padding)
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      const int ic = i < k ? i : k - 1;
      const T xi = __shfl_sync(0xffffffffu, alpha, ic) + m[ic * k];
      x[i] = i < k ? xi : T(-INFINITY);
    }
    ColumnLse<T> c;
    c.max_first(x[0]);
#pragma unroll
    for (int i = 1; i < KMAX; ++i) c.max_next(x[i]);
    c.settle();
    c.sum_first(x[0]);
#pragma unroll
    for (int i = 1; i < KMAX; ++i) c.sum_next(x[i]);
    alpha = c.result();
    if (lane < k) out[(t + 1) * out_step] = alpha;
  }
}

template <typename T, int KMAX>
__global__ void chain_bwd_warp_kernel(const T* __restrict__ mats,
                                      const T* __restrict__ alphas,
                                      const T* __restrict__ g_out,
                                      T* __restrict__ d_alpha0,
                                      T* __restrict__ d_mats, long long rows,
                                      int steps, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * (blockDim.x / 32) + warp;
  if (b >= rows) return;
  const int kk = k * k, stage = warp_stage<T>(k, true), ld = k | 1;
  const int a_off = padded<T>(k * ld);  // alpha_s within a stage
  T* ring = reinterpret_cast<T*>(smem_raw) +
            (size_t)warp * (warp_smem<T>(k, true) / sizeof(T));
  const long long step = rows * kk, a_step = rows * k;
  const bool vec_a = vec16(alphas, k);
  // tile u is step s = steps - 1 - u: M_s, then alpha_s
  auto issue = [&](int u) {  // an empty group past the last step
    const int s = u < steps ? steps - 1 - u : 0;
    T* slot = ring + (u % kWarpStages) * stage;
    warp_copy_rows<T, KMAX>(slot, ld, mats + s * step + b * kk, k, lane,
                            u < steps);
    warp_copy<T, KMAX>(slot + a_off, alphas + s * a_step + b * k, k, lane,
                       vec_a, u < steps);
    tc::cp_async_commit();
  };
  for (int u = 0; u < kWarpStages - 1; ++u) issue(u);
  // lane i owns row i of dM (lanes past K repeat row K-1: the same values
  // to the same places, so no part of a step sits in a branch)
  const int i = lane < k ? lane : k - 1;
  T o[KMAX];  // out_j of the step for every j (j past K: out_{K-1})
#pragma unroll
  for (int jj = 0; jj < KMAX; ++jj)
    o[jj] = alphas[steps * a_step + b * k + (jj < k ? jj : k - 1)];
  T g = g_out[b * k + i];
  for (int u = 0; u < steps; ++u) {
    const int s = steps - 1 - u;
    tc::cp_async_wait<kWarpStages - 2>();
    __syncwarp();
    issue(u + kWarpStages - 1);
    const T* slot = ring + (u % kWarpStages) * stage;
    const T* m = slot + i * ld;  // row i of M_s
    const T* a = slot + a_off;
    T* dm = d_mats + s * step + b * kk + (long long)i * k;
    const T ai = a[i];
    // acc starts at +0 and is never -0, so the +0 terms past K leave it
    T acc = T(0);
#pragma unroll
    for (int jj = 0; jj < KMAX; ++jj) {
      const int jc = jj < k ? jj : k - 1;
      const T d = contract_grad(ai, m[jc], o[jj],
                                __shfl_sync(0xffffffffu, g, jc));
      dm[jc] = d;
      acc = add_rn(acc, jj < k ? d : T(0));
    }
#pragma unroll
    for (int jj = 0; jj < KMAX; ++jj) o[jj] = a[jj < k ? jj : k - 1];
    g = acc;  // g_i of step s - 1
  }
  if (lane < k) d_alpha0[b * k + lane] = g;
}

// ---- the chain, K > 32: one CTA per row ----------------------------------

// Rows of M per tile: all K when kCtaStages whole matrices fit, else the
// most that do.  The backward's tile adds the chunk's alphas and a
// transposed dM tile of K x (chunk | 1).
template <typename T>
int cta_smem(int k, int chunk, bool bwd) {
  const int tile = padded<T>(chunk * k) + (bwd ? padded<T>(chunk) : 0);
  const int extra = bwd ? padded<T>(k * (chunk | 1)) + 4 * padded<T>(k)
                        : 2 * padded<T>(k);
  return (kCtaStages * tile + extra) * (int)sizeof(T);
}

template <typename T>
int cta_chunk(int k, bool bwd) {
  int chunk = k;
  while (chunk > 1 && (cta_smem<T>(k, chunk, bwd) > kSmemBudget ||
                       chunk * k * (int)sizeof(T) > kTileMax))
    --chunk;
  return chunk;
}

template <typename T>
__global__ void chain_fwd_cta_kernel(const T* __restrict__ alpha0,
                                     const T* __restrict__ mats,
                                     T* __restrict__ alphas, long long rows,
                                     int steps, int k, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nchunks = (k + chunk - 1) / chunk;
  // tiles per step: the whole matrix once, or its row chunks once per pass
  const int per_step = nchunks == 1 ? 1 : 2 * nchunks;
  const int tile = padded<T>(chunk * k);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* a_sm = ring + kCtaStages * tile;  // alpha_t in a_sm[(t & 1) * pk ..]
  const int pk = padded<T>(k);
  const long long kk = (long long)k * k, step = rows * kk;
  const long long ntiles = (long long)steps * per_step;
  auto issue = [&](long long u) {
    if (u < ntiles) {
      const long long t = u / per_step;
      const int r0 = (int)(u % per_step) % nchunks * chunk;
      const int nr = min(chunk, k - r0);
      const T* src = mats + t * step + b * kk + (long long)r0 * k;
      stage_copy(ring + (u % kCtaStages) * tile, src, nr * k, tid, nthr,
                 vec16(src, nr * k));
    }
    tc::cp_async_commit();
  };
  for (int u = 0; u < kCtaStages - 1; ++u) issue(u);
  const long long out_step = rows * k;
  for (int j = tid; j < k; j += nthr) {
    const T v = alpha0[b * k + j];
    a_sm[j] = v;
    alphas[b * k + j] = v;
  }
  long long u = 0;
  const T* cur = ring;
  for (int t = 0; t < steps; ++t) {
    const T* a = a_sm + (t & 1) * pk;
    T* a_next = a_sm + ((t + 1) & 1) * pk;
    ColumnLse<T> col[kMaxCols];
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = 0; c < nchunks; ++c) {
        if (pass == 0 || nchunks > 1) {  // a fresh tile
          tc::cp_async_wait<kCtaStages - 2>();
          __syncthreads();
          issue(u + kCtaStages - 1);  // into the slot tile u - 1 used
          cur = ring + (u % kCtaStages) * tile;
          ++u;
        }
        const int r0 = c * chunk, nr = min(chunk, k - r0);
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) {
          const int j = tid + q * nthr;
          if (j >= k) break;
          const T* mj = cur + j;
          ColumnLse<T>& cq = col[q];
          int r = 0;
          if (r0 == 0) {  // i = 0 opens the pass
            if (pass == 0) cq.max_first(a[0] + mj[0]);
            else cq.sum_first(a[0] + mj[0]);
            r = 1;
          }
          if (pass == 0) {
#pragma unroll 4
            for (; r < nr; ++r) cq.max_next(a[r0 + r] + mj[r * k]);
            if (r0 + nr == k) cq.settle();
          } else {
#pragma unroll 4
            for (; r < nr; ++r) cq.sum_next(a[r0 + r] + mj[r * k]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) {
      const int j = tid + q * nthr;
      if (j >= k) break;
      const T v = col[q].result();
      a_next[j] = v;
      alphas[(t + 1) * out_step + b * k + j] = v;
    }
  }
}

template <typename T>
__global__ void chain_bwd_cta_kernel(const T* __restrict__ mats,
                                     const T* __restrict__ alphas,
                                     const T* __restrict__ g_out,
                                     T* __restrict__ d_alpha0,
                                     T* __restrict__ d_mats, long long rows,
                                     int steps, int k, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int nchunks = (k + chunk - 1) / chunk, ld = chunk | 1;
  const int mtile = padded<T>(chunk * k), tile = mtile + padded<T>(chunk);
  const int pk = padded<T>(k);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* dt = ring + kCtaStages * tile;      // dt[j * ld + r] = dM_(r0 + r) j
  T* g_sm = dt + padded<T>(k * ld);      // g: two buffers of pk
  T* o_sm = g_sm + 2 * pk;               // out: two buffers of pk
  const long long kk = (long long)k * k, step = rows * kk, a_step = rows * k;
  const long long ntiles = (long long)steps * nchunks;
  // tile u: step s = steps - 1 - u / nchunks, rows r0 = (u % nchunks) * chunk
  auto issue = [&](long long u) {
    if (u < ntiles) {
      const long long s = steps - 1 - u / nchunks;
      const int r0 = (int)(u % nchunks) * chunk, nr = min(chunk, k - r0);
      T* slot = ring + (u % kCtaStages) * tile;
      const T* m_src = mats + s * step + b * kk + (long long)r0 * k;
      const T* a_src = alphas + s * a_step + b * k + r0;
      stage_copy(slot, m_src, nr * k, tid, nthr, vec16(m_src, nr * k));
      stage_copy(slot + mtile, a_src, nr, tid, nthr, vec16(a_src, nr));
    }
    tc::cp_async_commit();
  };
  for (int u = 0; u < kCtaStages - 1; ++u) issue(u);
  for (int j = tid; j < k; j += nthr) {
    g_sm[j] = g_out[b * k + j];
    o_sm[j] = alphas[steps * a_step + b * k + j];
  }
  long long u = 0;
  for (int si = 0; si < steps; ++si) {
    const long long s = steps - 1 - si;
    const T* g = g_sm + (si & 1) * pk;
    const T* o = o_sm + (si & 1) * pk;
    T* g_next = g_sm + ((si + 1) & 1) * pk;
    T* o_next = o_sm + ((si + 1) & 1) * pk;
    for (int c = 0; c < nchunks; ++c) {
      tc::cp_async_wait<kCtaStages - 2>();
      __syncthreads();
      issue(u + kCtaStages - 1);
      const T* m = ring + (u % kCtaStages) * tile;
      const T* a = m + mtile;
      ++u;
      const int r0 = c * chunk, nr = min(chunk, k - r0);
      T* dm = d_mats + s * step + b * kk + (long long)r0 * k;
      for (int j = tid; j < k; j += nthr) {
        const T oj = o[j], gj = g[j];
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          const T d = contract_grad(a[r], m[r * k + j], oj, gj);
          dm[r * k + j] = d;
          dt[j * ld + r] = d;
        }
      }
      __syncthreads();
      for (int r = tid; r < nr; r += nthr) {
        T acc = T(0);
#pragma unroll 4
        for (int j = 0; j < k; ++j) acc = add_rn(acc, dt[j * ld + r]);
        g_next[r0 + r] = acc;
        o_next[r0 + r] = a[r];
      }
    }
  }
  __syncthreads();
  const T* g = g_sm + (steps & 1) * pk;
  for (int j = tid; j < k; j += nthr) d_alpha0[b * k + j] = g[j];
}

// ---- the chain's backward sample -------------------------------------------
//
// enum_chain_sample replaces no TPU kernel.  It is the backward half of
// markov's forward-filter/backward-sample (src/repro/core/infer/enum.py:
// 619-628, a lax.scan of T-1 dependent random.categorical draws, plain jnp,
// in reverse), added for the same reason as the chain kernels above: on the
// host the scan is ~3-4 eager launches a step, ~2,400 at T = 600.  With the
// forward filter's alphas (T, B, K), the steps' matrices mats (T-1, B, K,
// K) and Gumbel noise g (T, B, K), for each batch row b:
//     z[T-1] = argmax_j(g[T-1, j] + alphas[T-1, j])
//     z[t]   = argmax_i(g[t, i] + (alphas[t, i] + mats[t, i, z[t+1]]))
// for t = T-2 down to 0 (random.categorical is argmax(gumbel + logits), and
// these are the JAX package's additions in its order).  A tie goes to the
// lowest index and NaN counts as larger than any number, as in torch.argmax
// and jnp.argmax, so the draws are bit for bit those of the plain version
// (kernels/enum_contract.py:enum_chain_sample_ref): the adds are single
// IEEE operations (__fadd_rn/__dadd_rn, never contracted) and the argmax is
// exact.
//
// One warp per batch row runs the T dependent steps.  Lane l owns states
// l, l + 32, ... (any K: lanes stride over K past 32), issues its three
// loads of a step together once z[t+1] is known (alpha and noise
// coalesced, the column entry strided by K), keeps its best (value, index)
// and a butterfly of __shfl_xor_sync picks the warp's best in five rounds,
// leaving z[t] in every lane for the next step's column.  What bounds it is
// that chain of T dependent steps, each a load round trip (mats was read by
// the forward chain kernel just before and is in L2) and the shuffles, not
// bytes: a step moves 3K elements.  Staging the row's operands in shared
// memory ahead of the chain is left for later.
template <typename T>
__device__ __forceinline__ bool arg_better(T v, int j, T best, int best_j) {
  const bool v_nan = v != v, b_nan = best != best;
  if (v_nan || b_nan) return v_nan && (!b_nan || j < best_j);
  return v > best || (v == best && j < best_j);
}

template <typename T>
__global__ void chain_sample_kernel(const T* __restrict__ alphas,
                                    const T* __restrict__ mats,
                                    const T* __restrict__ gumbel,
                                    long long* __restrict__ idx,
                                    long long rows, int steps, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  int z = 0;
  for (int t = steps; t >= 0; --t) {
    const long long at = ((long long)t * rows + row) * k;
    const T* a = alphas + at;
    const T* g = gumbel + at;
    // column z of mats[t] (mats[t][i][z] at i * k + z); none at t = T-1
    const T* m = t < steps ? mats + at * k + z : nullptr;
    T best = T(-INFINITY);
    int best_j = INT_MAX;  // a lane without a state never wins a tie
    for (int i = lane; i < k; i += 32) {
      T logit = a[i];
      if (m != nullptr) logit = add_rn(logit, m[(long long)i * k]);
      const T v = add_rn(g[i], logit);
      if (arg_better(v, i, best, best_j)) {
        best = v;
        best_j = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
      if (arg_better(ov, oj, best, best_j)) {
        best = ov;
        best_j = oj;
      }
    }
    z = best_j;
    if (lane == 0) idx[(long long)t * rows + row] = best_j;
  }
}


// ---- launchers -----------------------------------------------------------

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

// Raise a kernel's dynamic shared-memory limit to kSmemBudget, once
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
  if (err == cudaSuccess) *done = true;
  return err;
}

// Rows per CTA of the K <= 32 kernels: as many warps as fit the budget
template <typename T>
int warps_for(int k, bool bwd, long long rows) {
  int warps = kSmemBudget / warp_smem<T>(k, bwd);
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  return rows < warps ? (int)rows : warps;
}

int cta_threads(int k) {
  const int t = (k + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

template <typename T, int KMAX>
cudaError_t launch_warp_fwd(const void* alpha0, const void* mats,
                            void* alphas, long long rows, int steps, int k,
                            cudaStream_t st) {
  static bool ready = false;
  cudaError_t err = allow_smem(chain_fwd_warp_kernel<T, KMAX>, &ready);
  if (err != cudaSuccess) return err;
  const int warps = warps_for<T>(k, false, rows);
  chain_fwd_warp_kernel<T, KMAX>
      <<<(unsigned)((rows + warps - 1) / warps), 32 * warps,
         warps * warp_smem<T>(k, false), st>>>(
          (const T*)alpha0, (const T*)mats, (T*)alphas, rows, steps, k);
  return cudaGetLastError();
}

template <typename T, int KMAX>
cudaError_t launch_warp_bwd(const void* mats, const void* alphas,
                            const void* g, void* d_alpha0, void* d_mats,
                            long long rows, int steps, int k,
                            cudaStream_t st) {
  static bool ready = false;
  cudaError_t err = allow_smem(chain_bwd_warp_kernel<T, KMAX>, &ready);
  if (err != cudaSuccess) return err;
  const int warps = warps_for<T>(k, true, rows);
  chain_bwd_warp_kernel<T, KMAX>
      <<<(unsigned)((rows + warps - 1) / warps), 32 * warps,
         warps * warp_smem<T>(k, true), st>>>(
          (const T*)mats, (const T*)alphas, (const T*)g, (T*)d_alpha0,
          (T*)d_mats, rows, steps, k);
  return cudaGetLastError();
}

// K <= 8 (the main path's chain), 16 and 32 unroll to 8, 16 and 32
template <typename T>
cudaError_t launch_chain_fwd(const void* alpha0, const void* mats,
                             void* alphas, long long rows, int steps, int k,
                             void* stream) {
  if (rows <= 0 || steps <= 0 || k <= 0) return cudaSuccess;
  if (k > kMaxCols * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8)
    return launch_warp_fwd<T, 8>(alpha0, mats, alphas, rows, steps, k, st);
  if (k <= 16)
    return launch_warp_fwd<T, 16>(alpha0, mats, alphas, rows, steps, k, st);
  if (k <= 32)
    return launch_warp_fwd<T, 32>(alpha0, mats, alphas, rows, steps, k, st);
  static bool ready = false;
  cudaError_t err = allow_smem(chain_fwd_cta_kernel<T>, &ready);
  if (err != cudaSuccess) return err;
  const int chunk = cta_chunk<T>(k, false);
  chain_fwd_cta_kernel<T><<<(unsigned)rows, cta_threads(k),
                            cta_smem<T>(k, chunk, false), st>>>(
      (const T*)alpha0, (const T*)mats, (T*)alphas, rows, steps, k, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chain_bwd(const void* mats, const void* alphas,
                             const void* g, void* d_alpha0, void* d_mats,
                             long long rows, int steps, int k, void* stream) {
  if (rows <= 0 || steps <= 0 || k <= 0) return cudaSuccess;
  if (k > kMaxCols * 1024) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8)
    return launch_warp_bwd<T, 8>(mats, alphas, g, d_alpha0, d_mats, rows,
                                 steps, k, st);
  if (k <= 16)
    return launch_warp_bwd<T, 16>(mats, alphas, g, d_alpha0, d_mats, rows,
                                  steps, k, st);
  if (k <= 32)
    return launch_warp_bwd<T, 32>(mats, alphas, g, d_alpha0, d_mats, rows,
                                  steps, k, st);
  static bool ready = false;
  cudaError_t err = allow_smem(chain_bwd_cta_kernel<T>, &ready);
  if (err != cudaSuccess) return err;
  const int chunk = cta_chunk<T>(k, true);
  chain_bwd_cta_kernel<T><<<(unsigned)rows, cta_threads(k),
                            cta_smem<T>(k, chunk, true), st>>>(
      (const T*)mats, (const T*)alphas, (const T*)g, (T*)d_alpha0,
      (T*)d_mats, rows, steps, k, chunk);
  return cudaGetLastError();
}

// One warp a row, up to kMaxWarps rows a CTA
template <typename T>
cudaError_t launch_chain_sample(const void* alphas, const void* mats,
                                const void* gumbel, void* idx,
                                long long rows, int steps, int k,
                                void* stream) {
  if (rows <= 0 || steps < 0 || k <= 0) return cudaSuccess;
  const int warps = rows < kMaxWarps ? (int)rows : kMaxWarps;
  chain_sample_kernel<T>
      <<<(unsigned)((rows + warps - 1) / warps), 32 * warps, 0,
         (cudaStream_t)stream>>>((const T*)alphas, (const T*)mats,
                                 (const T*)gumbel, (long long*)idx, rows,
                                 steps, k);
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

// alpha0 (rows, k), mats (steps, rows, k, k) -> alphas (steps + 1, rows, k)
extern "C" int enum_chain_fwd_f32(const void* alpha0, const void* mats,
                                  void* alphas, long long rows, int steps,
                                  int k, void* stream) {
  return (int)launch_chain_fwd<float>(alpha0, mats, alphas, rows, steps, k,
                                      stream);
}

extern "C" int enum_chain_fwd_f64(const void* alpha0, const void* mats,
                                  void* alphas, long long rows, int steps,
                                  int k, void* stream) {
  return (int)launch_chain_fwd<double>(alpha0, mats, alphas, rows, steps, k,
                                       stream);
}

// mats (steps, rows, k, k), alphas (steps + 1, rows, k), g (rows, k) ->
// d_alpha0 (rows, k), d_mats (steps, rows, k, k)
extern "C" int enum_chain_bwd_f32(const void* mats, const void* alphas,
                                  const void* g, void* d_alpha0, void* d_mats,
                                  long long rows, int steps, int k,
                                  void* stream) {
  return (int)launch_chain_bwd<float>(mats, alphas, g, d_alpha0, d_mats, rows,
                                      steps, k, stream);
}

extern "C" int enum_chain_bwd_f64(const void* mats, const void* alphas,
                                  const void* g, void* d_alpha0, void* d_mats,
                                  long long rows, int steps, int k,
                                  void* stream) {
  return (int)launch_chain_bwd<double>(mats, alphas, g, d_alpha0, d_mats,
                                       rows, steps, k, stream);
}

// alphas (steps + 1, rows, k), mats (steps, rows, k, k), gumbel (steps + 1,
// rows, k) -> idx (steps + 1, rows) int64
extern "C" int enum_chain_sample_f32(const void* alphas, const void* mats,
                                     const void* gumbel, void* idx,
                                     long long rows, int steps, int k,
                                     void* stream) {
  return (int)launch_chain_sample<float>(alphas, mats, gumbel, idx, rows,
                                         steps, k, stream);
}

extern "C" int enum_chain_sample_f64(const void* alphas, const void* mats,
                                     const void* gumbel, void* idx,
                                     long long rows, int steps, int k,
                                     void* stream) {
  return (int)launch_chain_sample<double>(alphas, mats, gumbel, idx, rows,
                                          steps, k, stream);
}
