// Flash attention backward (flash-2 recomputation from the saved lse),
// causal or not, grouped-query:
//     p[s, t]  = exp(scale * q[s] . k[t] - lse[s])        (0 where masked)
//     dp[s, t] = dO[s] . v[t]
//     ds[s, t] = p[s, t] * (dp[s, t] - delta[s]) * scale,  delta[s] = dO[s] . o[s]
//     dq[s]    = sum_t ds[s, t] k[t]
//     dk[t]    = sum over the G query heads of the kv head, sum_s ds[s, t] q[s]
//     dv[t]    = sum over the G query heads,               sum_s p[s, t] dO[s]
// with q (B, S, H, dq), k (B, S, KH, dq), v (B, S, KH, dv), o and dO (B, S, H,
// dv), lse and delta (B, H, S) in float32, G = H / KH.  dq, dk and dv come
// back in q's type (bfloat16 or float32).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/flash_attention.py:
// _flash_bwd (flash_attention.py:184): _dq_kernel (pallas_call at :207) and
// _dkv_kernel (:231).  As there, two passes and no atomics, so every run gives
// the same bits: one pass owns a q-tile and walks the k-tiles (dq), the other
// owns a k-tile and walks the q-tiles (dk, dv).  The TPU's dkv pass writes
// one (dk, dv) per query head in the input type and sums the G heads
// afterwards; here each CTA of the dkv pass writes its query head's float32
// partials and a third kernel sums the G partials of a kv head in order and
// rounds once (a difference by design: fewer roundings).  delta is computed
// by a small kernel before the dq pass (the TPU computes it with an einsum
// outside its kernels) and handed to the dkv pass.
//
// What bounds it: at gemma-2b's training shapes (B = 2, S = 1024, H = 8,
// KH = 1, 256/256, causal) the dq pass needs 3 and the dkv pass 4 products of
// (S^2 / 2) x 256 per head, ~12.9 and ~17.2 GFLOP, against ~21 MB of
// operands: bound by operations (13 and 17 us at the bf16 tensor-core rate).
// Four kernels do the work, chosen by pass and dtype:
//
// dkv pass, bfloat16: dkv_tc_kernel, on the tensor cores (replaces the
// _dkv_kernel behind the pallas_call at flash_attention.py:231).
//   - Grid: one CTA per (query head, batch, 64-key tile), 256 CTAs at
//     gemma's microbatch (one per kv head would give 32), walking 32-query
//     tiles; per-head float32 partials and the in-order group sum as below,
//     so no atomics and the same bits on every run.
//   - Products: mma.sync.m16n8k16 bf16 -> f32 (HMMA) with ldmatrix (see
//     flash_attention.cu for why not wgmma yet).  S^T = K Q^T and dP^T =
//     V dO^T take bf16 operands and are exact in float32; P = exp(S scale -
//     lse) and dS = P (dP - delta) scale are formed in float32 registers;
//     dV += P^T dO and dK += dS^T Q each take the float32 operand as P_hi =
//     bf16(P), P_lo = bf16(P - P_hi) (likewise dS), two products each, from
//     the registers (the accumulator fragment of S^T is the A fragment of
//     P^T dO).  Why: the TPU kernel computes these products in float32 and
//     the port holds bf16 dk, dv to one bf16 step of the float32-computed
//     value (kernels/ops.py BF16_RTOL); P and dS rounded once to bf16 miss
//     that by 160x (dk, summed over 8 heads) and 239x (dv), the split keeps
//     it (0.97 and 0.95 of the bound; B = 1, S = 512, 8 heads of 128 over
//     one kv head, causal; tests/test_torch_flash_tc.py).  6 products where
//     FlashAttention-2 has 4.
//   - Warps: 8, warp w owning keys 16 (w % 4) .. + 15 and half (w / 4) of
//     the 16-column groups of dk and of dv: at head dim 256 the dk and dv
//     accumulators of 16 keys would take 256 registers a thread; split, 128
//     (248 registers in all at 256/256, no spill).  Both halves form the key
//     rows' S^T and dP^T, 2 of 8 products done twice.
//   - Head dims 128/128 and 256/256 have exact instantiations with no
//     head-dim guard in the unrolled loops (see flash_attention.cu): 0.291
//     -> 0.204 ms at gemma-2b's microbatch (chip_smoke.py, NVIDIA H100 80GB
//     HBM3, 700 W).
//   - Copies: K and V loaded once; Q, dO, lse and delta double-buffered by
//     cp.async, so tile j + 1 arrives while j is computed.  bf16 tiles padded
//     by 16 bytes a row (conflict-free ldmatrix), 135 KB at 256/256, one CTA
//     per SM.  Head dims not a multiple of 16 are zero-padded in shared
//     memory.
//
// dq pass, bfloat16: dq_tc_kernel, on the tensor cores (replaces the
// _dq_kernel behind the pallas_call at flash_attention.py:207).
//   - Grid: one CTA per (query head, batch, 64-query tile), the query tiles
//     last and, when causal, the heaviest first (as the forward), walking
//     the key tiles up to the diagonal; no atomics.
//   - Products: S = Q K^T and dP = dO V^T take bf16 operands and are exact
//     in float32; dS = P (dP - delta) scale is formed in float32 registers
//     and dQ += dS K takes it as dS_hi + dS_lo from the registers (the
//     accumulator fragments of S are the A fragments of dS K), K through
//     ldmatrix.trans.  dS rounded once to bf16 misses the bf16 gate 110x
//     (B = 1, S = 512, 8 heads of 128 over one kv head, causal), the split
//     keeps it (0.98 of the bound; tests/test_torch_flash_tc.py).  4
//     products where FlashAttention-2 has 3.
//   - Warps: above head dim 128, 8 in two key groups: warp w owns query
//     rows 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31 of each 64-key
//     tile, so its dq accumulator (16 x 256 float32, 128 registers a
//     thread) sits beside 32-key-wide S and dP tiles rather than 64-wide
//     ones (242 registers, no spill, where one group of 4 warps takes 255
//     and spills); nothing is computed twice (splitting the dq columns
//     instead, as the dkv pass does, forms S and dP twice).  At the end the
//     second group's accumulators pass through shared memory and are added
//     to the first's, in that order, so every run gives the same bits.  Up
//     to head dim 128, one group of 4 warps over 64 keys, two CTAs per SM.
//     At gemma-2b's microbatch the kernel takes 0.089 ms (0.105 with one
//     group of 64 keys, 0.113 of 32), at Qwen3-8B's prefill shape the pass
//     0.112 ms (0.136 with two groups); src/repro_torch/bench/bwd_kernels.py
//     (NVIDIA H100 80GB HBM3, 700 W) builds and times the choices
//     (DQ_TILES_128 / DQ_TILES_256 below).
//   - Copies: Q and dO loaded once; K and V through a two-stage cp.async
//     ring, so key tile j + 1 arrives while j is computed; rows padded by 16
//     bytes, head dims not a multiple of 16 zero-padded, as in the forward.
//     203 KB at 256/256 (one CTA per SM), 104 KB at 128/128 (two).
//   - Head dims 128/128 and 256/256 have exact instantiations; others take
//     the guarded bucket's.
//
// dkv pass, float32, and the dq pass, float32: dkv_kernel and dq_kernel, on
// the CUDA cores in float32.  float32 q and k are not exact in bf16, so the
// tensor cores' bf16 products would not give the float32 function the
// 2-layer float32 models are held to (1e-4).  Layout (256 threads, 16 row
// groups x 16 column lanes, as in the forward kernel
// csrc/flash_attention.cu): thread (g, c) owns 4 rows of its tile and the
// columns c, c + 16 of the 32-wide tile it walks, and the output columns c,
// c + 16, ... (head dims up to 256) of its 4 rows.  Every operand is staged
// in shared memory as float32 with odd strides (dim + 1, 33), so a
// half-warp reading one column of a row-major tile, or one row of a
// transposed one, touches 16 banks.  At dq = dv = 256 a CTA holds 207 KB:
// its 64-row tile of two operands and the 32-wide tile of two others, each
// transposed, plus the 64 x 32 probabilities; one CTA per SM, bound by the
// FMA rate and shared-memory loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BM = 64;     // rows of the tile a CTA owns (queries or keys)
constexpr int BN = 32;     // width of the tiles it walks (keys or queries)
constexpr int ROWS = 4;    // owned rows per thread
constexpr int MAXC = 16;   // output columns per thread: dims <= 16 * MAXC
constexpr int NS = BN + 1; // stride of a transposed 32-wide tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copy rows [pos0, pos0 + nrows) of a (S, width)-row-strided operand into
// shared memory as float32 (zeros past S): element (r, c) goes to
// dst[r * rstride + c * cstride].
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long row_stride, int pos0,
                                      int nrows, int width, int S,
                                      int rstride, int cstride) {
  const int total = nrows * width;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int pos = pos0 + r;
    dst[r * rstride + c * cstride] =
        pos < S ? to_f(src[(long long)pos * row_stride + c]) : 0.f;
  }
}

// delta[b, h, s] = sum_c dO[b, s, h, c] * o[b, s, h, c]: one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
    delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int S, int H,
                 int dv) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) +
                        (threadIdx.x >> 5);  // (b * S + s) * H + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * dv;
  const T* grow = dout + row * dv;
  float acc = 0.f;
  for (int c = lane; c < dv; c += 32) acc = fmaf(to_f(grow[c]), to_f(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;
    const int s = (int)(bs % S);
    const long long b = bs / S;
    delta[(b * H + h) * S + s] = acc;
  }
}

// dq pass: one CTA per (64-query tile, head h, batch b), walking 32-key
// tiles; the keys wholly above the diagonal are skipped when causal.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int S, int H, int KH, int dqd, int dvd,
              float scale, int causal) {
  extern __shared__ float smem[];
  const int qs = dqd + 1, gs = dvd + 1;
  float* Qs = smem;              // [BM][dq + 1]
  float* Gs = Qs + BM * qs;      // dO [BM][dv + 1]
  float* Kt = Gs + BM * gs;      // [dq][NS]
  float* Vt = Kt + dqd * NS;     // [dv][NS]
  float* Ps = Vt + dvd * NS;     // ds [BM][NS]

  const int grp = threadIdx.x >> 4;
  const int lane = threadIdx.x & 15;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const long long q_row = (long long)H * dqd, o_row = (long long)H * dvd;
  const long long k_row = (long long)KH * dqd, v_row = (long long)KH * dvd;
  const T* qb = q + (long long)b * S * q_row + (long long)h * dqd;
  const T* gb = dout + (long long)b * S * o_row + (long long)h * dvd;
  const T* kb = k + (long long)b * S * k_row + (long long)kh * dqd;
  const T* vb = v + (long long)b * S * v_row + (long long)kh * dvd;

  stage(Qs, qb, q_row, q0, BM, dqd, S, qs, 1);
  stage(Gs, gb, o_row, q0, BM, dvd, S, gs, 1);

  float lse_r[ROWS], delta_r[ROWS], acc[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + grp * ROWS + i;
    const long long li = ((long long)b * H + h) * S + qpos;
    lse_r[i] = qpos < S ? lse[li] : 0.f;
    delta_r[i] = qpos < S ? delta[li] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.f;
  }
  const int ncols = (dqd + 15) / 16;

  int nk = (S + BN - 1) / BN;
  if (causal) {
    const int last = min(q0 + BM, S) - 1;
    nk = min(nk, last / BN + 1);
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile is consumed; Qs, Gs are in place
    stage(Kt, kb, k_row, k0, BN, dqd, S, 1, NS);
    stage(Vt, vb, v_row, k0, BN, dvd, S, 1, NS);
    __syncthreads();

    float s[ROWS][2], dp[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dqd; ++d) {
      float kv0 = Kt[d * NS + lane], kv1 = Kt[d * NS + lane + 16];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float qv = Qs[(grp * ROWS + i) * qs + d];
        s[i][0] = fmaf(qv, kv0, s[i][0]);
        s[i][1] = fmaf(qv, kv1, s[i][1]);
      }
    }
    for (int d = 0; d < dvd; ++d) {
      float vv0 = Vt[d * NS + lane], vv1 = Vt[d * NS + lane + 16];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float gv = Gs[(grp * ROWS + i) * gs + d];
        dp[i][0] = fmaf(gv, vv0, dp[i][0]);
        dp[i][1] = fmaf(gv, vv1, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = grp * ROWS + i;
      const int qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 16 * j;
        float p = 0.f;
        if (qpos < S && kpos < S && !(causal && kpos > qpos))
          p = expf(s[i][j] * scale - lse_r[i]);
        Ps[row * NS + lane + 16 * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncwarp();  // a row group's ds are read by its own lanes

    for (int c = 0; c < BN; ++c) {
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = Ps[(grp * ROWS + i) * NS + c];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < ncols) {
          const int col = lane + 16 * j;
          const float kv = col < dqd ? Kt[col * NS + c] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + grp * ROWS + i;
    if (qpos >= S) continue;
    T* drow = dq + (((long long)b * S + qpos) * H + h) * dqd;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = lane + 16 * j;
      if (j < ncols && col < dqd) drow[col] = from_f<T>(acc[i][j]);
    }
  }
}

// dkv pass: one CTA per (64-key tile, query head h, batch b), walking
// 32-query tiles (from the diagonal on when causal); writes the head's
// float32 partials dk_h (B, S, H, dq) and dv_h (B, S, H, dv).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk_h, float* __restrict__ dv_h, int S,
               int H, int KH, int dqd, int dvd, float scale, int causal) {
  extern __shared__ float smem[];
  const int ks = dqd + 1, vs = dvd + 1;
  float* Ks = smem;              // [BM][dq + 1]
  float* Vs = Ks + BM * ks;      // [BM][dv + 1]
  float* Qt = Vs + BM * vs;      // [dq][NS]
  float* Gt = Qt + dqd * NS;     // dO [dv][NS]
  float* Ps = Gt + dvd * NS;     // p, then ds [BM][NS]
  __shared__ float lse_s[BN], delta_s[BN];

  const int grp = threadIdx.x >> 4;
  const int lane = threadIdx.x & 15;
  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const long long q_row = (long long)H * dqd, o_row = (long long)H * dvd;
  const long long k_row = (long long)KH * dqd, v_row = (long long)KH * dvd;
  const T* qb = q + (long long)b * S * q_row + (long long)h * dqd;
  const T* gb = dout + (long long)b * S * o_row + (long long)h * dvd;
  const T* kb = k + (long long)b * S * k_row + (long long)kh * dqd;
  const T* vb = v + (long long)b * S * v_row + (long long)kh * dvd;
  const float* lseb = lse + ((long long)b * H + h) * S;
  const float* deltab = delta + ((long long)b * H + h) * S;

  stage(Ks, kb, k_row, k0, BM, dqd, S, ks, 1);
  stage(Vs, vb, v_row, k0, BM, dvd, S, vs, 1);

  float dk[ROWS][MAXC], dv[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MAXC; ++j) dk[i][j] = dv[i][j] = 0.f;
  const int kcols = (dqd + 15) / 16, vcols = (dvd + 15) / 16;

  const int nq = (S + BN - 1) / BN;
  const int first = causal ? k0 / BN : 0;
  for (int qt = first; qt < nq; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();  // the previous tile is consumed; Ks, Vs are in place
    stage(Qt, qb, q_row, q0, BN, dqd, S, 1, NS);
    stage(Gt, gb, o_row, q0, BN, dvd, S, 1, NS);
    if (threadIdx.x < BN) {
      const int qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < S ? lseb[qpos] : 0.f;
      delta_s[threadIdx.x] = qpos < S ? deltab[qpos] : 0.f;
    }
    __syncthreads();

    float s[ROWS][2], dp[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dqd; ++d) {
      const float q0v = Qt[d * NS + lane], q1v = Qt[d * NS + lane + 16];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float kv = Ks[(grp * ROWS + i) * ks + d];
        s[i][0] = fmaf(kv, q0v, s[i][0]);
        s[i][1] = fmaf(kv, q1v, s[i][1]);
      }
    }
    for (int d = 0; d < dvd; ++d) {
      const float g0v = Gt[d * NS + lane], g1v = Gt[d * NS + lane + 16];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float vv = Vs[(grp * ROWS + i) * vs + d];
        dp[i][0] = fmaf(vv, g0v, dp[i][0]);
        dp[i][1] = fmaf(vv, g1v, dp[i][1]);
      }
    }
    float p[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = grp * ROWS + i;
      const int kpos = k0 + row;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 16 * j;
        const int qpos = q0 + col;
        p[i][j] = 0.f;
        if (qpos < S && kpos < S && !(causal && kpos > qpos))
          p[i][j] = expf(s[i][j] * scale - lse_s[col]);
        Ps[row * NS + col] = p[i][j];
      }
    }
    __syncwarp();  // a row group's p are read by its own lanes

    for (int c = 0; c < BN; ++c) {  // dv += p dO
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(grp * ROWS + i) * NS + c];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < vcols) {
          const int col = lane + 16 * j;
          const float gv = col < dvd ? Gt[col * NS + c] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) dv[i][j] = fmaf(pv[i], gv, dv[i][j]);
        }
      }
    }
    __syncwarp();  // p is consumed; ds takes its place
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = grp * ROWS + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 16 * j;
        Ps[row * NS + col] = p[i][j] * (dp[i][j] - delta_s[col]) * scale;
      }
    }
    __syncwarp();

    for (int c = 0; c < BN; ++c) {  // dk += ds q
      float dsv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) dsv[i] = Ps[(grp * ROWS + i) * NS + c];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < kcols) {
          const int col = lane + 16 * j;
          const float qv = col < dqd ? Qt[col * NS + c] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) dk[i][j] = fmaf(dsv[i], qv, dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int kpos = k0 + grp * ROWS + i;
    if (kpos >= S) continue;
    const long long base = ((long long)b * S + kpos) * H + h;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = lane + 16 * j;
      if (j < kcols && col < dqd) dk_h[base * dqd + col] = dk[i][j];
      if (j < vcols && col < dvd) dv_h[base * dvd + col] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the bfloat16 dkv pass on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;  // 8 warps: 4 key-row groups x 2 halves
constexpr int TC_BN = 32;        // queries per walked tile

// One CTA per (query head h, batch b, 64-key tile), walking 32-query tiles
// (from the diagonal on when causal; the grid puts the key tiles last, so
// the longest CTAs, the first key tiles, start first); writes the head's
// float32 partials dk_h (B, S, H, dq) and dv_h (B, S, H, dv) as dkv_kernel
// does.  Warp w owns keys 16 (w % 4) .. + 15 and one half (w / 4) of the
// 16-column groups of dk and of dv; the two halves of a key-row group both
// form its S^T and dP^T.  DMAX bounds the padded head dims; FULL: both are
// DMAX, so every head-dim guard folds (see flash_fwd_tc_kernel).
template <int DMAX, bool FULL>
__global__ void __launch_bounds__(TC_THREADS, 1)
    dkv_tc_kernel(const tc::bf16* __restrict__ q,
                  const tc::bf16* __restrict__ k,
                  const tc::bf16* __restrict__ v,
                  const tc::bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk_h,
                  float* __restrict__ dv_h, int S, int H, int KH, int dqd,
                  int dvd, float scale, int causal, int vec) {
  using tc::bf16;
  constexpr int NG = DMAX / 32;  // 16-column groups per half (at most)
  constexpr int SN = TC_BN / 8;  // 8-query score tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (FULL) dqd = dvd = DMAX;
  const int dqp = (dqd + 15) & ~15, dvp = (dvd + 15) & ~15;
  const int qs = dqp + 8, vs = dvp + 8;  // row strides (16 bytes of pad)
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][qs]
  bf16* Vs = Ks + BM * qs;                        // [BM][vs]
  bf16* Qs = Vs + BM * vs;                        // [2][TC_BN][qs]
  bf16* Gs = Qs + 2 * TC_BN * qs;                 // dO [2][TC_BN][vs]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * TC_BN * vs);  // lse [2][BN]
  float* Ds = Ls + 2 * TC_BN;                                 // delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kr = (warp & 3) * 16;  // the warp's key rows in the tile
  const int half = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BM;
  const int kh = h / (H / KH);
  const long long q_row = (long long)H * dqd, o_row = (long long)H * dvd;
  const long long k_row = (long long)KH * dqd, v_row = (long long)KH * dvd;
  const bf16* qb = q + (long long)b * S * q_row + (long long)h * dqd;
  const bf16* gb = dout + (long long)b * S * o_row + (long long)h * dvd;
  const bf16* kb = k + (long long)b * S * k_row + (long long)kh * dqd;
  const bf16* vb = v + (long long)b * S * v_row + (long long)kh * dvd;
  const float* lseb = lse + ((long long)b * H + h) * S;
  const float* deltab = delta + ((long long)b * H + h) * S;

  // this half's 16-column groups: [kg0, kg1) of dk, [vg0, vg1) of dv
  const int kgs = dqp / 16, vgs = dvp / 16;
  const int kg0 = half ? (kgs + 1) / 2 : 0, kg1 = half ? kgs : (kgs + 1) / 2;
  const int vg0 = half ? (vgs + 1) / 2 : 0, vg1 = half ? vgs : (vgs + 1) / 2;
  const int nkg = kg1 - kg0, nvg = vg1 - vg0;  // constants when FULL

  const int nq = (S + TC_BN - 1) / TC_BN;
  const int first = causal ? k0 / TC_BN : 0;

  auto load_q_tile = [&](int qt, int stage) {
    const int q0 = qt * TC_BN;
    tc::load_tile(Qs + stage * TC_BN * qs, qs, qb, q_row, q0, TC_BN, dqd, dqp,
                  S, vec, tid, TC_THREADS);
    tc::load_tile(Gs + stage * TC_BN * vs, vs, gb, o_row, q0, TC_BN, dvd, dvp,
                  S, vec, tid, TC_THREADS);
    if (tid < 2 * TC_BN) {
      const int i = tid & (TC_BN - 1);
      const int qpos = q0 + i;
      const bool full = qpos < S;
      const float* src = tid < TC_BN ? lseb : deltab;
      float* dst = (tid < TC_BN ? Ls : Ds) + stage * TC_BN + i;
      tc::cp_async4(dst, full ? src + qpos : src, full);
    }
  };

  tc::load_tile(Ks, qs, kb, k_row, k0, BM, dqd, dqp, S, vec, tid, TC_THREADS);
  tc::load_tile(Vs, vs, vb, v_row, k0, BM, dvd, dvp, S, vec, tid, TC_THREADS);
  if (first < nq) load_q_tile(first, 0);
  tc::cp_async_commit();

  float dk[NG][2][4], dv[NG][2][4];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][j][e] = dv[i][j][e] = 0.f;
  const int kpos[2] = {k0 + kr + g, k0 + kr + g + 8};

  for (int qt = first; qt < nq; ++qt) {
    const int stage = (qt - first) & 1;
    const int q0 = qt * TC_BN;
    if (qt + 1 < nq) load_q_tile(qt + 1, stage ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // all but the newest group: this tile (and K, V)
    __syncthreads();
    const bf16* Qt = Qs + stage * TC_BN * qs;
    const bf16* Gt = Gs + stage * TC_BN * vs;
    const float* Lt = Ls + stage * TC_BN;
    const float* Dt = Ds + stage * TC_BN;

    // S^T = K Q^T and dP^T = V dO^T (keys x queries), exact in float32
    float st[SN][4], dpt[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16)
      if (kk < dqp) {
        uint32_t a[4];
        tc::ldsm_x4(a, tc::a_addr(Ks, qs, kr, kk, lane));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, tc::b_addr(Qt, qs, np * 16, kk, lane));
          tc::mma(st[2 * np], a, bb[0], bb[1]);
          tc::mma(st[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16)
      if (kk < dvp) {
        uint32_t a[4];
        tc::ldsm_x4(a, tc::a_addr(Vs, vs, kr, kk, lane));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, tc::b_addr(Gt, vs, np * 16, kk, lane));
          tc::mma(dpt[2 * np], a, bb[0], bb[1]);
          tc::mma(dpt[2 * np + 1], a, bb[2], bb[3]);
        }
      }

    // p = exp(s scale - lse) (0 where masked), ds = p (dp - delta) scale, in
    // float32: st becomes p^T, dpt becomes ds^T
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int qpos = q0 + col;
        const int kp = kpos[e >> 1];
        float p = 0.f;
        if (qpos < S && kp < S && !(causal && kp > qpos))
          p = expf(st[n][e] * scale - Lt[col]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Dt[col]) * scale;
      }

    // dV += P^T dO and dK += dS^T Q, each from its hi and lo halves
#pragma unroll
    for (int kc = 0; kc < SN / 2; ++kc) {
      uint32_t hi[4], lo[4];
      tc::split_frag(st[2 * kc], st[2 * kc + 1], hi, lo);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (i < nvg) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, tc::a_addr(Gt, vs, kc * 16, (vg0 + i) * 16, lane));
          tc::mma(dv[i][0], hi, bb[0], bb[1]);
          tc::mma(dv[i][1], hi, bb[2], bb[3]);
          tc::mma(dv[i][0], lo, bb[0], bb[1]);
          tc::mma(dv[i][1], lo, bb[2], bb[3]);
        }
      tc::split_frag(dpt[2 * kc], dpt[2 * kc + 1], hi, lo);
#pragma unroll
      for (int i = 0; i < NG; ++i)
        if (i < nkg) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, tc::a_addr(Qt, qs, kc * 16, (kg0 + i) * 16, lane));
          tc::mma(dk[i][0], hi, bb[0], bb[1]);
          tc::mma(dk[i][1], hi, bb[2], bb[3]);
          tc::mma(dk[i][0], lo, bb[0], bb[1]);
          tc::mma(dk[i][1], lo, bb[2], bb[3]);
        }
    }
    __syncthreads();  // this tile is consumed before its stage is refilled
  }
  tc::cp_async_wait<0>();  // no copy outlives the CTA (S below the diagonal)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= S) continue;
    const long long base = ((long long)b * S + kpos[r]) * H + h;
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kcol = (kg0 + i) * 16 + j * 8 + 2 * t + e;
          const int vcol = (vg0 + i) * 16 + j * 8 + 2 * t + e;
          if (i < nkg && kcol < dqd)
            dk_h[base * dqd + kcol] = dk[i][j][2 * r + e];
          if (i < nvg && vcol < dvd)
            dv_h[base * dvd + vcol] = dv[i][j][2 * r + e];
        }
  }
}

// ---------------------------------------------------------------------------
// the bfloat16 dq pass on the tensor cores
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 64;  // query rows of a CTA: 4 warps of 16 per key group

// Keys per tile and key groups of the dq pass at head dims up to 128 (4
// warps, each 16 query rows x 64 keys, two CTAs per SM) and up to 256 (8
// warps, each 16 query rows x 32 keys of every 64-key tile);
// src/repro_torch/bench/bwd_kernels.py builds copies with other values
#define DQ_TILES_128 64, 1
#define DQ_TILES_256 64, 2

// One CTA per (query head h, batch b, 64-query tile), the query tiles last
// and, when causal, the heaviest first, walking KT-key tiles up to the
// diagonal.  Warp w owns query rows 16 (w % 4) .. + 15 and, in each key
// tile, the keys (w / 4) KT / KSPLIT .. + KT / KSPLIT - 1; with KSPLIT = 2
// the second key group's dq accumulators are added to the first's through
// shared memory at the end.  DMAX bounds the padded head dims; FULL: both
// are DMAX, so every head-dim guard folds (see flash_fwd_tc_kernel).
template <int DMAX, int KT, int KSPLIT, bool FULL>
__global__ void __launch_bounds__(128 * KSPLIT, 1)
    dq_tc_kernel(const tc::bf16* __restrict__ q,
                 const tc::bf16* __restrict__ k,
                 const tc::bf16* __restrict__ v,
                 const tc::bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, tc::bf16* __restrict__ dq,
                 int S, int H, int KH, int dqd, int dvd, float scale,
                 int causal, int vec) {
  using tc::bf16;
  static_assert(KSPLIT == 1 || KSPLIT == 2, "one or two key groups");
  constexpr int NTH = 128 * KSPLIT;
  constexpr int NT = DMAX / 8;       // 8-column dq tiles (at most)
  constexpr int KW = KT / KSPLIT;    // a warp's keys in each tile
  constexpr int SN = KW / 8;         // its 8-key score tiles
  static_assert(KW % 16 == 0, "a warp's keys are whole 16-key steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (FULL) dqd = dvd = DMAX;
  const int dqp = (dqd + 15) & ~15, dvp = (dvd + 15) & ~15;
  const int qs = dqp + 8, vs = dvp + 8;  // row strides (16 bytes of pad)
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [DQ_BM][qs]
  bf16* Gs = Qs + DQ_BM * qs;                     // dO [DQ_BM][vs]
  bf16* Ks = Gs + DQ_BM * vs;                     // [2][KT][qs]
  bf16* Vs = Ks + 2 * KT * qs;                    // [2][KT][vs]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp & 3) * 16;  // the warp's query rows in the tile
  const int kw0 = (warp >> 2) * KW;  // its keys in each key tile
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * DQ_BM;
  const int kh = h / (H / KH);
  const long long q_row = (long long)H * dqd, o_row = (long long)H * dvd;
  const long long k_row = (long long)KH * dqd, v_row = (long long)KH * dvd;
  const bf16* qb = q + (long long)b * S * q_row + (long long)h * dqd;
  const bf16* gb = dout + (long long)b * S * o_row + (long long)h * dvd;
  const bf16* kb = k + (long long)b * S * k_row + (long long)kh * dqd;
  const bf16* vb = v + (long long)b * S * v_row + (long long)kh * dvd;

  int nk = (S + KT - 1) / KT;
  if (causal) nk = min(nk, (min(q0 + DQ_BM, S) - 1) / KT + 1);

  tc::load_tile(Qs, qs, qb, q_row, q0, DQ_BM, dqd, dqp, S, vec, tid, NTH);
  tc::load_tile(Gs, vs, gb, o_row, q0, DQ_BM, dvd, dvp, S, vec, tid, NTH);
  tc::load_tile(Ks, qs, kb, k_row, 0, KT, dqd, dqp, S, vec, tid, NTH);
  tc::load_tile(Vs, vs, vb, v_row, 0, KT, dvd, dvp, S, vec, tid, NTH);
  tc::cp_async_commit();

  // the thread's rows g and g + 8 of the warp: position, lse, delta
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + row0 + r * 8 + g;
    const long long li = ((long long)b * H + h) * S + qpos[r];
    lse_r[r] = qpos[r] < S ? lse[li] : 0.f;
    delta_r[r] = qpos[r] < S ? delta[li] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int ntq = dqp / 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * KT;
    if (kt + 1 < nk) {  // the next stage was consumed in iteration kt - 1
      const int nxt = (kt + 1) & 1;
      tc::load_tile(Ks + nxt * KT * qs, qs, kb, k_row, k0 + KT, KT, dqd, dqp,
                    S, vec, tid, NTH);
      tc::load_tile(Vs + nxt * KT * vs, vs, vb, v_row, k0 + KT, KT, dvd, dvp,
                    S, vec, tid, NTH);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // all but the newest group: tile kt (and Q, dO)
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * KT * qs;
    const bf16* Vt = Vs + (kt & 1) * KT * vs;

    // S = Q K^T and dP = dO V^T (the warp's rows x its keys), exact in
    // float32
    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16)
      if (kk < dqp) {
        uint32_t a[4];
        tc::ldsm_x4(a, tc::a_addr(Qs, qs, row0, kk, lane));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, tc::b_addr(Kt, qs, kw0 + np * 16, kk, lane));
          tc::mma(s[2 * np], a, bb[0], bb[1]);
          tc::mma(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16)
      if (kk < dvp) {
        uint32_t a[4];
        tc::ldsm_x4(a, tc::a_addr(Gs, vs, row0, kk, lane));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, tc::b_addr(Vt, vs, kw0 + np * 16, kk, lane));
          tc::mma(dp[2 * np], a, bb[0], bb[1]);
          tc::mma(dp[2 * np + 1], a, bb[2], bb[3]);
        }
      }

    // p = exp(s scale - lse) (0 where masked), ds = p (dp - delta) scale in
    // float32, in place of s
    const bool edge = k0 + KT > S || (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + kw0 + n * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (!edge || !(kpos >= S || (causal && kpos > qpos[r])))
          p = expf(s[n][e] * scale - lse_r[r]);
        s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;
      }

    // dQ += dS_hi K + dS_lo K, 16 keys a step
#pragma unroll
    for (int kc = 0; kc < SN / 2; ++kc) {
      uint32_t hi[4], lo[4];
      tc::split_frag(s[2 * kc], s[2 * kc + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        if (2 * np < ntq) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, tc::a_addr(Kt, qs, kw0 + kc * 16, np * 16, lane));
          tc::mma(acc[2 * np], hi, bb[0], bb[1]);
          tc::mma(acc[2 * np + 1], hi, bb[2], bb[3]);
          tc::mma(acc[2 * np], lo, bb[0], bb[1]);
          tc::mma(acc[2 * np + 1], lo, bb[2], bb[3]);
        }
    }
    __syncthreads();  // tile kt is consumed before its stage is refilled
  }
  tc::cp_async_wait<0>();

  if (KSPLIT == 2) {
    // the second key group's accumulators, then the first's plus them, in
    // that order; the ring is free (every copy landed, every warp passed
    // the loop's last barrier).  [tile, element][thread of the group]:
    // consecutive lanes, consecutive words
    float* red = reinterpret_cast<float*>(Ks);
    const int gt = tid & 127;
    if (warp >= 4) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < ntq)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 128 + gt] = acc[n][e];
    }
    __syncthreads();
    if (warp >= 4) return;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < ntq)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += red[(n * 4 + e) * 128 + gt];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= S) continue;
    bf16* drow = dq + (((long long)b * S + qpos[r]) * H + h) * dqd;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < ntq) {
        const int col = n * 8 + 2 * t;
        if (vec) {  // dqd % 8 == 0, so col + 1 < dqd with col
          if (col < dqd)
            *reinterpret_cast<__nv_bfloat162*>(drow + col) =
                __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < dqd)
              drow[col + e] = __float2bfloat16_rn(acc[n][2 * r + e]);
        }
      }
  }
}

// out[b, s, kh, c] = sum_{g < G} part[b, s, kh * G + g, c], in head order
template <typename T>
__global__ void group_sum_kernel(const float* __restrict__ part,
                                 T* __restrict__ out, long long n, int G,
                                 int width) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;  // idx = ((b * S + s) * KH + kh) * width + c
  const long long c = idx % width;
  const long long row = idx / width;  // (b * S + s) * KH + kh
  const float* src = part + (row * G) * width + c;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += src[(long long)g * width];
  out[idx] = from_f<T>(acc);
}

size_t dq_smem(int dq, int dv) {
  return sizeof(float) * ((size_t)BM * (dq + 1) + (size_t)BM * (dv + 1) +
                          (size_t)(dq + dv) * NS + (size_t)BM * NS);
}

bool bad_shape(int B, int H, int KH, int dq, int dv) {
  return KH <= 0 || H % KH != 0 || dq <= 0 || dv <= 0 || dq > 16 * MAXC ||
         dv > 16 * MAXC || B > 65535 || H > 65535;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes, size_t* configured) {
  // Raise the kernel's dynamic shared-memory limit once per size, so a
  // launch captured into a CUDA graph makes no attribute call.
  if (bytes > *configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    *configured = bytes;
  }
  return cudaSuccess;
}

bool bad_dq_grid(int S) { return (S + DQ_BM - 1) / DQ_BM > 65535; }

// delta = rowsum(dO o), written for this pass and the dkv pass
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta, int B,
                         int S, int H, int dvd, cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const int warps = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows, S, H, dvd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int S, int H, int KH,
                      int dqd, int dvd, float scale, int causal,
                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(B, H, KH, dqd, dvd)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_delta<T>(o, dout, delta, B, S, H, dvd, st);
  if (err != cudaSuccess) return err;
  const size_t bytes = dq_smem(dqd, dvd);
  static size_t configured = 0;
  err = allow_smem(dq_kernel<T>, bytes, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((S + BM - 1) / BM), (unsigned)H, (unsigned)B);
  dq_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, H, KH, dqd, dvd,
      scale, causal);
  return cudaGetLastError();
}

// Q and dO, the K/V ring, or the second key group's accumulators in its
// place, whichever is larger
size_t dq_tc_smem(int dq, int dv, int kt, int ksplit) {
  const size_t dqp = (dq + 15) & ~15, dvp = (dv + 15) & ~15;
  const size_t qs = dqp + 8, vs = dvp + 8;
  const size_t ring = sizeof(tc::bf16) * 2 * kt * (qs + vs);
  const size_t red = ksplit > 1 ? sizeof(float) * 4 * 128 * (dqp / 8) : 0;
  return sizeof(tc::bf16) * DQ_BM * (qs + vs) + (ring > red ? ring : red);
}

template <int DMAX, int KT, int KSPLIT, bool FULL>
size_t dq_tc_configured = 0;  // see allow_smem: raised, never lowered

template <int DMAX, int KT, int KSPLIT, bool FULL>
cudaError_t dq_tc_info_inst(int dqd, int dvd, int* smem, int* ctas_per_sm) {
  const size_t bytes = dq_tc_smem(dqd, dvd, KT, KSPLIT);
  *smem = (int)bytes;
  cudaError_t err = allow_smem(dq_tc_kernel<DMAX, KT, KSPLIT, FULL>, bytes,
                               &dq_tc_configured<DMAX, KT, KSPLIT, FULL>);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, dq_tc_kernel<DMAX, KT, KSPLIT, FULL>, 128 * KSPLIT, bytes);
}

template <int DMAX, int KT, int KSPLIT, bool FULL>
cudaError_t launch_dq_tc_inst(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, int B, int S,
                              int H, int KH, int dqd, int dvd, float scale,
                              int causal, int vec, cudaStream_t st) {
  const size_t bytes = dq_tc_smem(dqd, dvd, KT, KSPLIT);
  cudaError_t err = allow_smem(dq_tc_kernel<DMAX, KT, KSPLIT, FULL>, bytes,
                               &dq_tc_configured<DMAX, KT, KSPLIT, FULL>);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)H, (unsigned)B, (unsigned)((S + DQ_BM - 1) / DQ_BM));
  dq_tc_kernel<DMAX, KT, KSPLIT, FULL><<<grid, 128 * KSPLIT, bytes, st>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
      (const tc::bf16*)dout, (const float*)lse, (const float*)delta,
      (tc::bf16*)dq, S, H, KH, dqd, dvd, scale, causal, vec);
  return cudaGetLastError();
}

// The bf16 dq pass: the delta kernel, then the tensor-core kernel
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, int B, int S, int H, int KH,
                         int dqd, int dvd, float scale, int causal,
                         void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(B, H, KH, dqd, dvd) || bad_dq_grid(S))
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_delta<__nv_bfloat16>(o, dout, delta, B, S, H, dvd,
                                                st);
  if (err != cudaSuccess) return err;
  const int vec = dqd % 8 == 0 && dvd % 8 == 0 && tc::aligned16(q) &&
                  tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout) && tc::aligned16(dq);
  // exact instantiations (FULL) for 128/128 and 256/256, else the bucket's
  if (dqd == 128 && dvd == 128)
    return launch_dq_tc_inst<128, DQ_TILES_128, true>(
        q, k, v, dout, lse, delta, dq, B, S, H, KH, dqd, dvd, scale, causal,
        vec, st);
  if (dqd <= 128 && dvd <= 128)
    return launch_dq_tc_inst<128, DQ_TILES_128, false>(
        q, k, v, dout, lse, delta, dq, B, S, H, KH, dqd, dvd, scale, causal,
        vec, st);
  if (dqd == 256 && dvd == 256)
    return launch_dq_tc_inst<256, DQ_TILES_256, true>(
        q, k, v, dout, lse, delta, dq, B, S, H, KH, dqd, dvd, scale, causal,
        vec, st);
  return launch_dq_tc_inst<256, DQ_TILES_256, false>(
      q, k, v, dout, lse, delta, dq, B, S, H, KH, dqd, dvd, scale, causal,
      vec, st);
}

// dk, dv in T from the per-head float32 partials, the G heads in order
template <typename T>
cudaError_t group_sums(const void* dk_h, const void* dv_h, void* dk, void* dv,
                       int B, int S, int H, int KH, int dqd, int dvd,
                       cudaStream_t st) {
  const int G = H / KH;
  const long long nk = (long long)B * S * KH * dqd;
  const long long nv = (long long)B * S * KH * dvd;
  group_sum_kernel<T><<<(unsigned)((nk + 255) / 256), 256, 0, st>>>(
      (const float*)dk_h, (T*)dk, nk, G, dqd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_sum_kernel<T><<<(unsigned)((nv + 255) / 256), 256, 0, st>>>(
      (const float*)dv_h, (T*)dv, nv, G, dvd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk_h, void* dv_h, void* dk, void* dv, int B,
                       int S, int H, int KH, int dqd, int dvd, float scale,
                       int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(B, H, KH, dqd, dvd)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = dq_smem(dqd, dvd);  // the same four tiles and ds
  static size_t configured = 0;
  cudaError_t err = allow_smem(dkv_kernel<T>, bytes, &configured);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((S + BM - 1) / BM), (unsigned)H, (unsigned)B);
  dkv_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (float*)dk_h, (float*)dv_h, S,
      H, KH, dqd, dvd, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return group_sums<T>(dk_h, dv_h, dk, dv, B, S, H, KH, dqd, dvd, st);
}

size_t dkv_tc_smem(int dq, int dv) {
  const size_t qs = ((dq + 15) & ~15) + 8, vs = ((dv + 15) & ~15) + 8;
  return sizeof(tc::bf16) * (BM + 2 * TC_BN) * (qs + vs) +
         sizeof(float) * 4 * TC_BN;
}

template <int DMAX, bool FULL>
size_t dkv_tc_configured = 0;  // see allow_smem: raised, never lowered

template <int DMAX, bool FULL>
cudaError_t dkv_tc_info_inst(int dqd, int dvd, int* smem, int* ctas_per_sm) {
  const size_t bytes = dkv_tc_smem(dqd, dvd);
  *smem = (int)bytes;
  cudaError_t err = allow_smem(dkv_tc_kernel<DMAX, FULL>, bytes,
                               &dkv_tc_configured<DMAX, FULL>);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, dkv_tc_kernel<DMAX, FULL>, TC_THREADS, bytes);
}

template <int DMAX, bool FULL>
cudaError_t launch_dkv_tc_inst(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk_h, void* dv_h,
                               int B, int S, int H, int KH, int dqd, int dvd,
                               float scale, int causal, int vec,
                               cudaStream_t st) {
  const size_t bytes = dkv_tc_smem(dqd, dvd);
  cudaError_t err = allow_smem(dkv_tc_kernel<DMAX, FULL>, bytes,
                               &dkv_tc_configured<DMAX, FULL>);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)H, (unsigned)B, (unsigned)((S + BM - 1) / BM));
  dkv_tc_kernel<DMAX, FULL><<<grid, TC_THREADS, bytes, st>>>(
      (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
      (const tc::bf16*)dout, (const float*)lse, (const float*)delta,
      (float*)dk_h, (float*)dv_h, S, H, KH, dqd, dvd, scale, causal, vec);
  return cudaGetLastError();
}

// The bf16 dkv pass: the tensor-core kernel, then the in-order group sums
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk_h, void* dv_h, void* dk,
                          void* dv, int B, int S, int H, int KH, int dqd,
                          int dvd, float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(B, H, KH, dqd, dvd)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = dqd % 8 == 0 && dvd % 8 == 0 && tc::aligned16(q) &&
                  tc::aligned16(k) && tc::aligned16(v) &&
                  tc::aligned16(dout);
  // exact instantiations (FULL) for 128/128 and 256/256, else the bucket's
  cudaError_t err;
  if (dqd == 128 && dvd == 128)
    err = launch_dkv_tc_inst<128, true>(q, k, v, dout, lse, delta, dk_h, dv_h,
                                        B, S, H, KH, dqd, dvd, scale, causal,
                                        vec, st);
  else if (dqd <= 128 && dvd <= 128)
    err = launch_dkv_tc_inst<128, false>(q, k, v, dout, lse, delta, dk_h,
                                         dv_h, B, S, H, KH, dqd, dvd, scale,
                                         causal, vec, st);
  else if (dqd == 256 && dvd == 256)
    err = launch_dkv_tc_inst<256, true>(q, k, v, dout, lse, delta, dk_h, dv_h,
                                        B, S, H, KH, dqd, dvd, scale, causal,
                                        vec, st);
  else
    err = launch_dkv_tc_inst<256, false>(q, k, v, dout, lse, delta, dk_h,
                                         dv_h, B, S, H, KH, dqd, dvd, scale,
                                         causal, vec, st);
  if (err != cudaSuccess) return err;
  return group_sums<__nv_bfloat16>(dk_h, dv_h, dk, dv, B, S, H, KH, dqd, dvd,
                                   st);
}

}  // namespace

// delta (B, H, S) float32 is written here and read by the dkv pass
extern "C" int flash_attention_dq_f32(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int S,
                                      int H, int KH, int dqd, int dvd,
                                      float scale, int causal, void* stream) {
  return (int)launch_dq<float>(q, k, v, o, dout, lse, delta, dq, B, S, H, KH,
                               dqd, dvd, scale, causal, stream);
}

extern "C" int flash_attention_dq_bf16(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* delta, void* dq, int B, int S,
                                       int H, int KH, int dqd, int dvd,
                                       float scale, int causal,
                                       void* stream) {
  return (int)launch_dq_tc(q, k, v, o, dout, lse, delta, dq, B, S, H, KH,
                           dqd, dvd, scale, causal, stream);
}

// dk_h (B, S, H, dq) and dv_h (B, S, H, dv) float32 are scratch
extern "C" int flash_attention_dkv_f32(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk_h, void* dv_h, void* dk,
                                       void* dv, int B, int S, int H, int KH,
                                       int dqd, int dvd, float scale,
                                       int causal, void* stream) {
  return (int)launch_dkv<float>(q, k, v, dout, lse, delta, dk_h, dv_h, dk, dv,
                                B, S, H, KH, dqd, dvd, scale, causal, stream);
}

extern "C" int flash_attention_dkv_bf16(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk_h, void* dv_h, void* dk,
                                        void* dv, int B, int S, int H, int KH,
                                        int dqd, int dvd, float scale,
                                        int causal, void* stream) {
  return (int)launch_dkv_tc(q, k, v, dout, lse, delta, dk_h, dv_h, dk, dv, B,
                            S, H, KH, dqd, dvd, scale, causal, stream);
}

// The bf16 dkv kernel's dynamic shared memory (bytes) and resident CTAs per
// SM at these head dims
extern "C" int flash_attention_dkv_bf16_info(int dqd, int dvd, int* smem,
                                             int* ctas_per_sm) {
  if (dqd <= 0 || dvd <= 0 || dqd > 16 * MAXC || dvd > 16 * MAXC)
    return (int)cudaErrorInvalidValue;
  if (dqd == 128 && dvd == 128)
    return (int)dkv_tc_info_inst<128, true>(dqd, dvd, smem, ctas_per_sm);
  if (dqd <= 128 && dvd <= 128)
    return (int)dkv_tc_info_inst<128, false>(dqd, dvd, smem, ctas_per_sm);
  if (dqd == 256 && dvd == 256)
    return (int)dkv_tc_info_inst<256, true>(dqd, dvd, smem, ctas_per_sm);
  return (int)dkv_tc_info_inst<256, false>(dqd, dvd, smem, ctas_per_sm);
}

// The bf16 dq kernel's dynamic shared memory (bytes) and resident CTAs per
// SM at these head dims
extern "C" int flash_attention_dq_bf16_info(int dqd, int dvd, int* smem,
                                            int* ctas_per_sm) {
  if (dqd <= 0 || dvd <= 0 || dqd > 16 * MAXC || dvd > 16 * MAXC)
    return (int)cudaErrorInvalidValue;
  if (dqd == 128 && dvd == 128)
    return (int)dq_tc_info_inst<128, DQ_TILES_128, true>(dqd, dvd, smem,
                                                         ctas_per_sm);
  if (dqd <= 128 && dvd <= 128)
    return (int)dq_tc_info_inst<128, DQ_TILES_128, false>(dqd, dvd, smem,
                                                          ctas_per_sm);
  if (dqd == 256 && dvd == 256)
    return (int)dq_tc_info_inst<256, DQ_TILES_256, true>(dqd, dvd, smem,
                                                         ctas_per_sm);
  return (int)dq_tc_info_inst<256, DQ_TILES_256, false>(dqd, dvd, smem,
                                                        ctas_per_sm);
}
