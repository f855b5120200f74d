// Flash attention forward (online softmax), causal or not, grouped-query:
//     o[b, s, h, :]  = softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :]) v[b, t, h / G, :]
//     lse[b, h, s]   = log sum_t exp(scale * q . k)
// with q (B, S, H, dq), k (B, S, KH, dq), v (B, S, KH, dv), G = H / KH, and
// causal masking t <= s.  o comes back in q's type (bfloat16 or float32),
// lse in float32 (what a backward pass needs).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _fwd_kernel (its pallas_call at flash_attention.py:96, reached through
// _flash_fwd_impl, :79).  As there: running max m, sum l and accumulator acc
// in float32, masked scores set to NEG_INF = -1e30, l clamped to 1e-30, lse =
// m + log l.  Unlike the TPU grid, which walks the k-tiles in order on one
// core with the running state in VMEM scratch, each CTA here owns one (b, h,
// q-tile) and walks the k-tiles in a loop, so the running state stays
// in registers; the k-tiles wholly above the diagonal are skipped when
// causal.  A ragged S (not a multiple of the tile) is masked here rather than
// asserted away.  Two kernels, chosen by dtype:
//
// bfloat16: flash_fwd_tc_kernel, on the tensor cores.  What bounds it: at
// Qwen3-8B's prefill (B = 4, S = 512, H = 32, KH = 8, 128/128, causal) the
// function moves ~42 MB and needs ~8.6 GFLOP of products: 12.6 us by bytes
// at 3.35 TB/s, 8.7 us for the products at the bf16 tensor-core rate.
//   - Products: mma.sync.m16n8k16 bf16 -> f32 (HMMA) with ldmatrix, 4
//     warps.  (wgmma.mma_async would reach a higher rate; it needs
//     shared-memory matrix descriptors and swizzle modes whose faults show
//     only as wrong numbers at run time, so this first tensor-core version
//     takes the fixed, documented fragment layouts of mma.sync.)  S = Q K^T
//     is one product of bf16 operands, exact in float32.
//     O += P V is two: the float32 P is split in registers into P_hi =
//     bf16(P) and P_lo = bf16(P - P_hi), so P_hi V + P_lo V carries P to
//     ~2^-17 of itself.  Why: the TPU kernel computes P V in float32
//     (flash_attention.py:63-64), and the port holds a bf16 output to one
//     bf16 step of the float32-computed value (kernels/ops.py BF16_RTOL);
//     FlashAttention-2's P rounded once to bf16 breaks that gate (114x the
//     bound at B = 1, S = 512, 8 heads of 128, causal; once to fp16, 16x),
//     the split keeps it (0.98 of the bound; tests/test_torch_flash_tc.py).
//     The price is 3 products where FlashAttention-2 has 2.
//   - P never leaves the registers: the accumulator fragment of S is the A
//     fragment of P V (two 8-key tiles make one 16-key step).
//   - Shared memory holds bf16: the Q tile (loaded once) and a ring of two
//     K/V stages filled by cp.async (16 bytes a thread, zero-filled past S
//     and past the head dim), so k-tile j + 1 arrives while j is computed.
//     Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in
//     8 different bank groups.  Head dims that are not a multiple of 16 are
//     zero-padded to one in shared memory; a dim that is not a multiple of 8
//     or a misaligned pointer takes plain loads instead of cp.async.
//   - Tiles: 64-key k-tiles.  Head dims up to 128: 128 query rows, each
//     warp two 16-row m-tiles that share every K and V fragment (half the
//     shared-memory reads of one m-tile a warp), two CTAs per SM; above: 64
//     rows, one m-tile a warp (the 16 x 256 float32 accumulator takes 128
//     registers a thread), one CTA per SM.
//   - Head dims 128/128 and 256/256 (Qwen3-8B's, gemma-2b's) have exact
//     instantiations: with no head-dim guard left in the unrolled loops they
//     are one basic block each, which the compiler schedules as a whole
//     (ldmatrix ahead of the products); this took the kernel from 0.123 to
//     0.092 ms at Qwen3-8B's prefill shape and from 0.217 to 0.093 ms at
//     gemma-2b's (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).  They use
//     255 registers and spill 60 and 32 bytes; the guarded ones, none.
//   - Grid (H, B, q-tiles), the q-tiles last and, when causal, the heaviest
//     first, so the longest CTAs start in the first wave.
//
// float32: flash_fwd_kernel, on the CUDA cores, unchanged.  float32 q and k
// are not exact in bf16, so the tensor cores' bf16 products would not give
// the float32 function the 2-layer float32 models are held to (1e-4).
// Layout of a CTA (256 threads, 16 row groups x 16 column lanes): thread
// (g, c) owns query rows 4g..4g+3 of the tile, the score columns c, c+16,
// c+32, c+48 of each k-tile, and the output columns c, c+16, ... of its rows
// (dv <= 256).  Shared memory holds, in float32: the q-tile [64][dq+1], the
// k-tile transposed [dq][65], the v-tile [64][dv] and the probabilities
// [64][65] (padded strides keep the banks apart), 116 KB at dq = dv = 128;
// bound by the FMA issue rate and shared-memory loads, one CTA per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per k-tile
constexpr int THREADS = 256;
constexpr int ROWS = 4;      // query rows per thread
constexpr int COLS = 4;      // score columns per thread and k-tile
constexpr int MAXC = 16;     // output columns per thread: dv <= 16 * MAXC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// Copy rows [pos0, pos0 + nrows) of a (S, width)-row-strided operand into
// shared memory as float32 (zeros past S): element (r, c) goes to
// dst[r * rstride + c * cstride].
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long row_stride, int pos0,
                                      int nrows, int width, int S,
                                      int rstride, int cstride) {
  int r = threadIdx.x / width;
  int c = threadIdx.x - r * width;
  const int total = nrows * width;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int pos = pos0 + r;
    dst[r * rstride + c * cstride] =
        pos < S ? to_f(src[(long long)pos * row_stride + c]) : 0.f;
    c += THREADS;
    while (c >= width) {
      c -= width;
      ++r;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KH, int dq,
                     int dv, float scale, int causal) {
  extern __shared__ float smem[];
  const int q_stride = dq + 1;
  const int kt_stride = BK + 1;
  const int p_stride = BK + 1;
  float* Qs = smem;                   // [BQ][dq + 1]
  float* Kt = Qs + BQ * q_stride;     // [dq][BK + 1]
  float* Vs = Kt + dq * kt_stride;    // [BK][dv]
  float* Ps = Vs + BK * dv;           // [BQ][BK + 1]

  const int grp = threadIdx.x >> 4;   // row group: rows grp*ROWS + i
  const int lane = threadIdx.x & 15;  // column lane
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);

  const long long q_row = (long long)H * dq;
  const long long k_row = (long long)KH * dq;
  const long long v_row = (long long)KH * dv;
  const T* qb = q + (long long)b * S * q_row + (long long)h * dq;
  const T* kb = k + (long long)b * S * k_row + (long long)kh * dq;
  const T* vb = v + (long long)b * S * v_row + (long long)kh * dv;

  stage(Qs, qb, q_row, q0, BQ, dq, S, q_stride, 1);

  float m[ROWS], l[ROWS], acc[ROWS][MAXC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) acc[i][j] = 0.f;
  }
  const int ncols = (dv + 15) / 16;

  int nk = (S + BK - 1) / BK;
  if (causal) {
    const int last = min(q0 + BQ, S) - 1;  // the tile's last real row
    nk = min(nk, last / BK + 1);
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed; Qs is in place
    stage(Kt, kb, k_row, k0, BK, dq, S, 1, kt_stride);
    stage(Vs, vb, v_row, k0, BK, dv, S, dv, 1);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dq; ++d) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = Qs[(grp * ROWS + i) * q_stride + d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = Kt[d * kt_stride + lane + 16 * j];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = grp * ROWS + i;
      const int qpos = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int kpos = k0 + lane + 16 * j;
        float val = s[i][j] * scale;
        if (kpos >= S || (causal && kpos > qpos)) val = NEG_INF;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * p_stride + lane + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < MAXC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncwarp();  // a row group's probabilities are read by its own lanes

    for (int c = 0; c < BK; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Ps[(grp * ROWS + i) * p_stride + c];
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < ncols) {
          const int col = lane + 16 * j;
          const float vv = col < dv ? Vs[c * dv + col] : 0.f;
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qpos = q0 + grp * ROWS + i;
    if (qpos >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * S + qpos) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int col = lane + 16 * j;
      if (j < ncols && col < dv) orow[col] = from_f<T>(acc[i][j] / li);
    }
    if (lane == 0) lse[((long long)b * H + h) * S + qpos] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps

__device__ __forceinline__ bool masked(int kpos, int qpos, int S,
                                       int causal) {
  return kpos >= S || (causal && kpos > qpos);
}

// One CTA per (64 MT-query tile, head h, batch b); warp w owns query rows
// 16 MT w .. 16 MT (w + 1) - 1 as MT 16-row m-tiles, which share every K and
// V fragment it loads.  DMAX bounds the padded head dims (the output columns
// live in registers), KTILE is the k-tile; FULL: both head dims are DMAX,
// so every head-dim guard below folds and the unrolled loops are one block
// that the compiler schedules as a whole.  The grid is (H, B, q-tiles),
// the q-tiles last and, when causal, the heaviest (last) first, so the
// longest CTAs start in the first wave.
template <int DMAX, int KTILE, int MT, bool FULL>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_fwd_tc_kernel(const tc::bf16* __restrict__ q,
                        const tc::bf16* __restrict__ k,
                        const tc::bf16* __restrict__ v,
                        tc::bf16* __restrict__ o, float* __restrict__ lse,
                        int S, int H, int KH, int dq, int dv, float scale,
                        int causal, int vec) {
  using tc::bf16;
  constexpr int NT = DMAX / 8;   // 8-column output tiles (at most)
  constexpr int SN = KTILE / 8;  // 8-key score tiles
  constexpr int TQ = 64 * MT;    // query rows of the CTA
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (FULL) dq = dv = DMAX;
  const int dqp = (dq + 15) & ~15, dvp = (dv + 15) & ~15;
  const int qs = dqp + 8, vs = dvp + 8;  // row strides (16 bytes of pad)
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TQ][qs]
  bf16* Ks = Qs + TQ * qs;                        // [2][KTILE][qs]
  bf16* Vs = Ks + 2 * KTILE * qs;                 // [2][KTILE][vs]

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (tid >> 5) * 16 * MT;  // the warp's first row in the tile
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z) * TQ;
  const int kh = h / (H / KH);
  const long long q_row = (long long)H * dq;
  const long long k_row = (long long)KH * dq;
  const long long v_row = (long long)KH * dv;
  const bf16* qb = q + (long long)b * S * q_row + (long long)h * dq;
  const bf16* kb = k + (long long)b * S * k_row + (long long)kh * dq;
  const bf16* vb = v + (long long)b * S * v_row + (long long)kh * dv;

  int nk = (S + KTILE - 1) / KTILE;
  if (causal) {
    const int last = min(q0 + TQ, S) - 1;  // the tile's last real row
    nk = min(nk, last / KTILE + 1);
  }

  tc::load_tile(Qs, qs, qb, q_row, q0, TQ, dq, dqp, S, vec, tid, TC_THREADS);
  tc::load_tile(Ks, qs, kb, k_row, 0, KTILE, dq, dqp, S, vec, tid,
                TC_THREADS);
  tc::load_tile(Vs, vs, vb, v_row, 0, KTILE, dv, dvp, S, vec, tid,
                TC_THREADS);
  tc::cp_async_commit();

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  // per m-tile, rows g and g + 8: running max, this thread's share of l
  float m[MT][2], l[MT][2];
  int qpos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = NEG_INF;
      l[mt][r] = 0.f;
      qpos[mt][r] = q0 + row0 + mt * 16 + r * 8 + g;
    }
  const int ntv = dvp / 8;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * KTILE;
    if (kt + 1 < nk) {  // the next stage was consumed in iteration kt - 1
      const int nxt = (kt + 1) & 1;
      tc::load_tile(Ks + nxt * KTILE * qs, qs, kb, k_row, k0 + KTILE, KTILE,
                    dq, dqp, S, vec, tid, TC_THREADS);
      tc::load_tile(Vs + nxt * KTILE * vs, vs, vb, v_row, k0 + KTILE, KTILE,
                    dv, dvp, S, vec, tid, TC_THREADS);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // all but the newest group: tile kt (and Q)
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * KTILE * qs;
    const bf16* Vt = Vs + (kt & 1) * KTILE * vs;

    float s[MT][SN][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX; kk += 16)
      if (kk < dqp) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          tc::ldsm_x4(a[mt], tc::a_addr(Qs, qs, row0 + mt * 16, kk, lane));
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, tc::b_addr(Kt, qs, np * 16, kk, lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma(s[mt][2 * np], a[mt], bb[0], bb[1]);
            tc::mma(s[mt][2 * np + 1], a[mt], bb[2], bb[3]);
          }
        }
      }

    const bool edge = k0 + KTILE > S || (causal && k0 + KTILE - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float val = s[mt][n][e] * scale;
          if (edge &&
              masked(k0 + n * 8 + 2 * t + (e & 1), qpos[mt][r], S, causal))
            val = NEG_INF;
          s[mt][n][e] = val;
          mx[r] = fmaxf(mx[r], val);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        alpha[r] = expf(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[mt][n][e] - m[mt][e >> 1]);
          s[mt][n][e] = p;
          l[mt][e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < ntv) {
          acc[mt][n][0] *= alpha[0];
          acc[mt][n][1] *= alpha[0];
          acc[mt][n][2] *= alpha[1];
          acc[mt][n][3] *= alpha[1];
        }
    }

    // O += P_hi V + P_lo V, 16 keys a step
#pragma unroll
    for (int kc = 0; kc < SN / 2; ++kc) {
      uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::split_frag(s[mt][2 * kc], s[mt][2 * kc + 1], ph[mt], pl[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        if (2 * np < ntv) {
          uint32_t bb[4];
          tc::ldsm_x4_t(bb, tc::a_addr(Vt, vs, kc * 16, np * 16, lane));
          // the hi, then the lo product of each accumulator, with the
          // other accumulators' products between the two
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma(acc[mt][2 * np], ph[mt], bb[0], bb[1]);
            tc::mma(acc[mt][2 * np + 1], ph[mt], bb[2], bb[3]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tc::mma(acc[mt][2 * np], pl[mt], bb[0], bb[1]);
            tc::mma(acc[mt][2 * np + 1], pl[mt], bb[2], bb[3]);
          }
        }
    }
    __syncthreads();  // tile kt is consumed before its stage is refilled
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[mt][r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      li = fmaxf(li, 1e-30f);
      if (qpos[mt][r] >= S) continue;
      bf16* orow = o + (((long long)b * S + qpos[mt][r]) * H + h) * dv;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < ntv) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n * 8 + 2 * t + e;
            if (col < dv)
              orow[col] = __float2bfloat16_rn(acc[mt][n][2 * r + e] / li);
          }
        }
      if (t == 0)
        lse[((long long)b * H + h) * S + qpos[mt][r]] = m[mt][r] + logf(li);
    }
}

size_t tc_smem_bytes(int dq, int dv, int tq, int ktile) {
  const size_t qs = ((dq + 15) & ~15) + 8, vs = ((dv + 15) & ~15) + 8;
  return sizeof(tc::bf16) * (tq * qs + 2 * ktile * (qs + vs));
}

// The dynamic shared-memory limit each instantiation was raised to: raised
// once per larger size (see launch()), never lowered
template <int DMAX, int KTILE, int MT, bool FULL>
size_t tc_configured = 0;

template <int DMAX, int KTILE, int MT, bool FULL>
cudaError_t allow_tc_smem(size_t bytes) {
  if (bytes > tc_configured<DMAX, KTILE, MT, FULL>) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<DMAX, KTILE, MT, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    tc_configured<DMAX, KTILE, MT, FULL> = bytes;
  }
  return cudaSuccess;
}

template <int DMAX, int KTILE, int MT, bool FULL>
cudaError_t tc_info_inst(int dq, int dv, int* smem, int* ctas_per_sm) {
  const size_t bytes = tc_smem_bytes(dq, dv, 64 * MT, KTILE);
  *smem = (int)bytes;
  cudaError_t err = allow_tc_smem<DMAX, KTILE, MT, FULL>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_fwd_tc_kernel<DMAX, KTILE, MT, FULL>, TC_THREADS,
      bytes);
}

template <int DMAX, int KTILE, int MT, bool FULL>
cudaError_t launch_tc_inst(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int S, int H, int KH,
                           int dq, int dv, float scale, int causal, int vec,
                           cudaStream_t stream) {
  const size_t bytes = tc_smem_bytes(dq, dv, 64 * MT, KTILE);
  cudaError_t err = allow_tc_smem<DMAX, KTILE, MT, FULL>(bytes);
  if (err != cudaSuccess) return err;
  const int tq = 64 * MT;
  dim3 grid((unsigned)H, (unsigned)B, (unsigned)((S + tq - 1) / tq));
  flash_fwd_tc_kernel<DMAX, KTILE, MT, FULL>
      <<<grid, TC_THREADS, bytes, stream>>>(
          (const tc::bf16*)q, (const tc::bf16*)k, (const tc::bf16*)v,
          (tc::bf16*)o, (float*)lse, S, H, KH, dq, dv, scale, causal, vec);
  return cudaGetLastError();
}

// The instantiations (here and in flash_attention_fwd_bf16_info): exact
// ones (FULL) for 128/128 and 256/256, else the bucket's with guards.  Head
// dims up to 128: 128 query rows, 64-key tiles, 104 KB at 128/128, two CTAs
// per SM; above: 64 rows, 64-key tiles, 169 KB at 256/256, one CTA per SM
// (on an H100 these beat 64 rows at 128/128 and 32-key tiles at either).
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int S, int H, int KH, int dq, int dv,
                      float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || dq <= 0 || dv <= 0 || dq > 256 ||
      dv > 256 || B > 65535 || (S + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  const int vec = dq % 8 == 0 && dv % 8 == 0 && tc::aligned16(q) &&
                  tc::aligned16(k) && tc::aligned16(v);
  cudaStream_t st = (cudaStream_t)stream;
  if (dq == 128 && dv == 128)
    return launch_tc_inst<128, 64, 2, true>(q, k, v, o, lse, B, S, H, KH, dq,
                                            dv, scale, causal, vec, st);
  if (dq <= 128 && dv <= 128)
    return launch_tc_inst<128, 64, 2, false>(q, k, v, o, lse, B, S, H, KH,
                                             dq, dv, scale, causal, vec, st);
  if (dq == 256 && dv == 256)
    return launch_tc_inst<256, 64, 1, true>(q, k, v, o, lse, B, S, H, KH, dq,
                                            dv, scale, causal, vec, st);
  return launch_tc_inst<256, 64, 1, false>(q, k, v, o, lse, B, S, H, KH, dq,
                                           dv, scale, causal, vec, st);
}

size_t smem_bytes(int dq, int dv) {
  return sizeof(float) *
         ((size_t)BQ * (dq + 1) + (size_t)dq * (BK + 1) + (size_t)BK * dv +
          (size_t)BQ * (BK + 1));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int KH, int dq, int dv,
                   float scale, int causal, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (KH <= 0 || H % KH != 0 || dq <= 0 || dv <= 0 || dv > 16 * MAXC ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(dq, dv);
  // Raise the kernel's dynamic shared-memory limit once per size, so a
  // launch captured into a CUDA graph makes no attribute call.
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, S, H, KH, dq,
      dv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int S, int H, int KH, int dq,
                                       int dv, float scale, int causal,
                                       void* stream) {
  return (int)launch<float>(q, k, v, o, lse, B, S, H, KH, dq, dv, scale,
                            causal, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int S, int H, int KH, int dq,
                                        int dv, float scale, int causal,
                                        void* stream) {
  return (int)launch_tc(q, k, v, o, lse, B, S, H, KH, dq, dv, scale, causal,
                        stream);
}

// The bf16 kernel's dynamic shared memory (bytes) and resident CTAs per SM
// at these head dims
extern "C" int flash_attention_fwd_bf16_info(int dq, int dv, int* smem,
                                             int* ctas_per_sm) {
  if (dq <= 0 || dv <= 0 || dq > 256 || dv > 256)
    return (int)cudaErrorInvalidValue;
  if (dq == 128 && dv == 128)
    return (int)tc_info_inst<128, 64, 2, true>(dq, dv, smem, ctas_per_sm);
  if (dq <= 128 && dv <= 128)
    return (int)tc_info_inst<128, 64, 2, false>(dq, dv, smem, ctas_per_sm);
  if (dq == 256 && dv == 256)
    return (int)tc_info_inst<256, 64, 1, true>(dq, dv, smem, ctas_per_sm);
  return (int)tc_info_inst<256, 64, 1, false>(dq, dv, smem, ctas_per_sm);
}
