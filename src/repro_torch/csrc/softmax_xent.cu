// Blockwise softmax cross-entropy over a large vocab, forward:
//     logits[t, v] = sum_k x[t, k] W[k, v]                 (float32)
//     lse[t]       = log sum_v exp(logits[t, v])
//     ce[t]        = lse[t] - logits[t, labels[t]]
//     z_loss[t]    = z_loss_weight * lse[t]^2
// with x (T, d) in bfloat16 or float32 and W of the same type, read in either
// layout: (d, V) row-major (an untied unembedding, Qwen3's `unembed`) or the
// (V, d) row-major embedding whose transpose a tied model unembeds with
// (gemma's `embed.T`, read in place: the 1 GB weight is never copied).  The
// (T, V) logits are never written: only ce, z_loss and lse (T,) in float32.
// And, in bfloat16, the backward's logits gradient (dlogits_tc_kernel):
//     dl[t, v] = exp(logits[t, v] - lse[t]) coef[t] - [v == labels[t]] g_ce[t]
// written as a bf16 pair [hi; lo] (2T, V) for the products dx = dl W^T and
// dw = x^T dl, which kernels/softmax_xent.py hands to cuBLAS.
//
// Replaces the Pallas TPU kernel src/repro/kernels/softmax_xent.py:_kernel
// (reached through _xent_fwd_kernel, softmax_xent.py:57; pallas_call at :64).
// As there, vocab blocks of the unembedding stream through fast memory and
// each token row keeps a running max, sum of exponentials and label logit.
// Unlike the TPU grid, which walks the vocab blocks in order on one core,
// the vocab is cut into splits that run in parallel: a CTA owns a 128-row
// tile of x and one split, walks its vocab tiles and writes its rows' (max,
// sumexp, label logit); a second kernel merges the splits of a row in split
// order (no atomics: the same bits on every run) into lse, ce and z_loss.
// The grid is (row tile, split), the row tile fastest, so the CTAs that
// stream the same W tiles run together and W comes from HBM about once.  The
// TPU kernel asserts T % 128 == 0 and V % 512 == 0; here a ragged T and V
// are masked (Qwen3's V = 151,936 is not a multiple of 512).  The JAX
// package has no backward kernel (its _bwd, :93, is jax.grad of the jnp
// reference); the dlogits kernel is this port's, as enum_contract's is.
//
// What bounds it: at gemma-2b's training shape (T = 2048 rows per
// microbatch, d = 2048, V = 256,000) the products are 2.15 TFLOP against
// ~1.06 GB of operands: bound by operations (2.2 ms at the bf16 tensor-core
// rate).  Two kernels, chosen by dtype:
//
// float32: xent_partial_kernel, on the CUDA cores (67 TFLOP/s at most; the
// float32 checks and the 2-layer float32 models run it).  256 threads as
// 16 x 16; each vocab tile is a 128 x 128 x d product staged through shared
// memory 16 deep (the next depth slice loaded into registers while the
// current one is multiplied); thread (ty, tx) keeps an 8 x 8 block of logits
// in registers, rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and columns likewise
// with tx, read as float4 from shared memory.  The running max of a row is
// shared by its 16 threads (a shuffle per tile); each keeps its own running
// sum, merged once at the end.
//
// bfloat16: xent_fwd_tc_kernel and dlogits_tc_kernel, one mainloop
// (xent_tc_body) with two epilogues, on the tensor cores.
//   - Products: mma.sync.m16n8k16 bf16 -> f32 (HMMA) with ldmatrix
//     (csrc/tc_mma.cuh).  The product of two bf16 values is exact in
//     float32, so this is the TPU kernel's function (x.astype(f32) @
//     w.astype(f32)) up to the order of the sums; no operand is split.  But
//     the tensor cores round the float32 accumulator toward zero as they
//     add into it, so the error of a logit (up to ~15 at d = 4096) grew
//     with d: ce missed its 1e-4 bound by 1 % at (256, 4096, 151,936)
//     (tests/test_torch_cuda.py).  So each mma sums its 16 products from
//     zero and an ordinary float32 add takes that into the accumulator:
//     ce's error at (512, 4096, 151,936) fell from 8.0e-5 to 1.1e-5, for
//     ~1.6 ms of 9 (repro_torch.bench.fwd_kernels, NVIDIA H100 80GB HBM3,
//     700 W).
//   - 8 warps as 2 (rows) x 4 (columns) over a 128-row x BV-column vocab
//     tile, each warp 64 rows x BV / 4 columns of float32 accumulators that
//     never leave the registers.  x's row tile does not fit in shared memory
//     at d = 2048, so KS-deep slices of x and of W stream together through a
//     ring of NST shared-memory stages filled by cp.async (16 bytes a
//     thread; one barrier a slice).  The ring runs on across vocab tiles: the
//     next tile's first slices arrive while a tile's epilogue runs.  x (8 MB)
//     stays in L2.  ldmatrix reads x and a tied (V, d) W (d contiguous, as K
//     in Q K^T); ldmatrix.trans reads a (d, V) W.  Rows are padded by 16
//     bytes, so the 8 rows an ldmatrix reads fall in 8 bank groups.  A row
//     stride that is not a multiple of 8 elements, or an operand that is not
//     16-byte aligned, takes plain loads (the (37, 24, 301) check).
//   - Forward epilogue, per vocab tile: each thread folds its own columns of
//     each of its 8 rows into its own running (max, sum) (one rescale a row
//     a tile, no shuffle and no barrier), and the one owner of a row's label
//     column stores the label logit.  At the end of the split the 4 lanes
//     of a row merge by shuffles and the 4 warp columns through shared
//     memory in a fixed order.  Columns past V are masked.
//   - Dlogits epilogue: dl from the accumulators, lse, coef and g_ce in
//     registers, split into bf16 hi + lo (tc::split) and stored as pairs.
//     dl is a genuine float32 operand of the next products: rounded once to
//     bf16 it misses the bf16 gate of dx and dw, as hi + lo it holds
//     (tests/test_torch_xent_tc.py).
//   - Tiles: XENT_TILES below (BV, KS, NST): 128 columns, 64 deep,
//     2 stages, two CTAs per SM, 128 registers and no spill; the bench
//     (repro_torch.bench.fwd_kernels --kinds xent) rewrites that line to
//     compare others (at gemma-2b's microbatch 128 x 256 tiles, one CTA per
//     SM, were 13-20 % slower; 32-deep 4-stage rings 11 % slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

// (vocab columns per tile, depth per stage, stages) of the bf16 kernels
#define XENT_TILES 128, 64, 2

namespace {

constexpr int THREADS = 256;
constexpr int BT = 128;  // token rows per CTA
constexpr int BV = 128;  // vocab columns per tile
constexpr int KD = 16;   // depth per shared-memory stage
constexpr int PAD = 4;   // keeps float4 rows 16-byte aligned
constexpr int LOADS = BT * KD / THREADS;  // elements each thread stages
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }

// row (or column) of the 8 a thread owns: 4 at base*4, 4 at 64 + base*4
__device__ __forceinline__ int owned(int base, int i) {
  return (i < 4 ? 0 : 64) + base * 4 + (i & 3);
}

// the depth slice [k0, k0 + KD) of the x tile and the W tile, as float32
// (zeros past T, V and d), into each thread's LOADS registers
template <typename T, bool VD>
__device__ __forceinline__ void load_stage(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           float (&a_reg)[LOADS],
                                           float (&b_reg)[LOADS], int k0,
                                           int t0, int v0, int T_rows, int d,
                                           int V) {
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    const int e = threadIdx.x + THREADS * l;
    {  // x tile: (row, kk), kk fastest
      const int row = e / KD, kk = e % KD;
      const int t = t0 + row, k = k0 + kk;
      a_reg[l] = (t < T_rows && k < d) ? to_f(x[(long long)t * d + k]) : 0.f;
    }
    if (VD) {  // W[v * d + k]: kk fastest
      const int vv = e / KD, kk = e % KD;
      const int v = v0 + vv, k = k0 + kk;
      b_reg[l] = (v < V && k < d) ? to_f(w[(long long)v * d + k]) : 0.f;
    } else {   // W[k * V + v]: vv fastest
      const int kk = e / BV, vv = e % BV;
      const int v = v0 + vv, k = k0 + kk;
      b_reg[l] = (v < V && k < d) ? to_f(w[(long long)k * V + v]) : 0.f;
    }
  }
}

// VD = true: W is the (V, d) matrix whose transpose is unembedded with
template <typename T, bool VD>
__global__ void __launch_bounds__(THREADS, 2)
    xent_partial_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ labels,
                        float* __restrict__ m_part, float* __restrict__ s_part,
                        float* __restrict__ l_part, int T_rows, int d, int V,
                        int tiles_per_split) {
  __shared__ __align__(16) float As[KD][BT + PAD];
  __shared__ __align__(16) float Bs[KD][BV + PAD];
  __shared__ float sum_s[8][THREADS];  // each thread's running sums
  __shared__ float ll_s[BT];           // label logits
  __shared__ int lbl_s[BT];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int nvt = (V + BV - 1) / BV;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(nvt, vt_begin + tiles_per_split);

  if (tid < BT) {
    const int t = t0 + tid;
    const int lbl = t < T_rows ? labels[t] : -1;
    lbl_s[tid] = lbl;
    // a label outside [0, V) owns no column: its row's ce is NaN, not lse
    ll_s[tid] = t < T_rows && (lbl < 0 || lbl >= V) ? __int_as_float(0x7fffffff)
                                                    : 0.f;
  }
  float m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_INF;
    sum_s[i][tid] = 0.f;
  }
  const int nkt = (d + KD - 1) / KD;

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    float a_reg[LOADS], b_reg[LOADS];
    load_stage<T, VD>(x, w, a_reg, b_reg, 0, t0, v0, T_rows, d, V);
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();  // the previous stage is consumed
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int e = tid + THREADS * l;
        As[e % KD][e / KD] = a_reg[l];
        if (VD)
          Bs[e % KD][e / KD] = b_reg[l];
        else
          Bs[e / BV][e % BV] = b_reg[l];
      }
      __syncthreads();
      if (kt + 1 < nkt)
        load_stage<T, VD>(x, w, a_reg, b_reg, (kt + 1) * KD, t0, v0, T_rows,
                          d, V);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    // online update of each owned row with this tile's 128 logits
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = owned(ty, i);
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + owned(tx, j) < V) tmax = fmaxf(tmax, acc[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      float s = sum_s[i][tid] * expf(m[i] - m_new);
      const int hit = lbl_s[row] - v0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = owned(tx, j);
        if (v0 + col < V) s += expf(acc[i][j] - m_new);
        if (col == hit) ll_s[row] += acc[i][j];  // the one owner of the label
      }
      sum_s[i][tid] = s;
      m[i] = m_new;
    }
  }

  // merge the 16 running sums of each row (all share its max)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = sum_s[i][tid];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    sum_s[i][tid] = s;
  }
  __syncthreads();  // ll_s is complete
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = owned(ty, i);
      const int t = t0 + row;
      if (t < T_rows) {
        const long long o = (long long)split * T_rows + t;
        m_part[o] = m[i];
        s_part[o] = sum_s[i][tid];
        l_part[o] = ll_s[row];
      }
    }
  }
}

// merge the splits of each row in split order
__global__ void xent_combine_kernel(const float* __restrict__ m_part,
                                    const float* __restrict__ s_part,
                                    const float* __restrict__ l_part,
                                    float* __restrict__ ce,
                                    float* __restrict__ zl,
                                    float* __restrict__ lse, int T_rows,
                                    int nsplit, float z_loss_weight) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T_rows) return;
  float m = NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, m_part[(long long)s * T_rows + t]);
  float sum = 0.f, ll = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long o = (long long)s * T_rows + t;
    sum += s_part[o] * expf(m_part[o] - m);
    ll += l_part[o];
  }
  const float l = m + logf(sum);
  lse[t] = l;
  ce[t] = l - ll;
  zl[t] = z_loss_weight * l * l;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: xent_fwd_tc_kernel and dlogits_tc_kernel
// ---------------------------------------------------------------------------

constexpr int TC_TILES[3] = {XENT_TILES};
constexpr int TC_BV = TC_TILES[0];   // vocab columns per tile
constexpr int TC_KS = TC_TILES[1];   // depth per shared-memory stage
constexpr int TC_NST = TC_TILES[2];  // stages in the ring
constexpr int TC_THREADS = 256;      // 8 warps: 2 (rows) x 4 (columns)
constexpr int TC_BT = 128;           // token rows per CTA
static_assert(TC_BV % 64 == 0 && TC_KS % 16 == 0 && TC_NST >= 2,
              "XENT_TILES: BV a multiple of 64, KS of 16, 2 stages or more");

// What both epilogues read.  x (T, d) row-major; w is the (d, V) matrix,
// stored (V, d) row-major when vd (read as its transpose) or (d, V)
// row-major; labels (T,) int32.  Forward: m_part, s_part, l_part (nsplit, T).
// Dlogits: lse, coef, gce (T,) float32 and dl (2T, V) bf16, hi rows first.
struct XentArgs {
  const tc::bf16* x;
  const tc::bf16* w;
  const int* labels;
  float* m_part;
  float* s_part;
  float* l_part;
  const float* lse;
  const float* coef;
  const float* gce;
  tc::bf16* dl;
  int T, d, V, tiles_per_split, vec;
};

// Rows [r0, r0 + NR) x columns [c0, c0 + NC) of a row-major bf16 matrix
// with row stride ld, real where row < rmax and column < cmax and zero
// elsewhere, into a shared tile of stride ss.  vec: 16-byte cp.async copies
// (cmax and ld multiples of 8, src 16-byte aligned); else plain loads.
template <int NR, int NC>
__device__ __forceinline__ void load_block(tc::bf16* dst, int ss,
                                           const tc::bf16* src, long long ld,
                                           int r0, int c0, int rmax, int cmax,
                                           bool vec, int tid) {
  constexpr int CPR = NC / 8;  // 8-element chunks per row
  static_assert(NR * CPR % TC_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < NR * CPR / TC_THREADS; ++j) {
    const int i = tid + j * TC_THREADS;
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = r0 + r, col = c0 + c;
    tc::bf16* out = dst + r * ss + c;
    const tc::bf16* in = src + (long long)row * ld + col;
    if (vec) {
      const bool full = row < rmax && col < cmax;
      tc::cp_async16(out, full ? in : src, full);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = (row < rmax && col + e < cmax) ? in[e]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// one stage: the x slice, then W's
template <bool VD>
__host__ __device__ constexpr int tc_stage_elems() {
  return TC_BT * (TC_KS + 8) +
         (VD ? TC_BV * (TC_KS + 8) : TC_KS * (TC_BV + 8));
}

template <bool VD>
constexpr size_t tc_smem_bytes() {  // the ring, the row merge, labels
  return sizeof(tc::bf16) * TC_NST * tc_stage_elems<VD>() +
         sizeof(float) * (2 * 4 * TC_BT + 2 * TC_BT);
}

// One CTA: rows [t0, t0 + 128) of x against the vocab tiles of its split.
// The (vocab tile, depth slice) pairs are one sequence that the ring walks,
// slice i in stage i % NST; after the last slice of a tile the epilogue
// reads the accumulators (DL: dlogits, else the forward's online update).
template <int BV, int KS, int NST, bool VD, bool DL>
__device__ __forceinline__ void xent_tc_body(const XentArgs a) {
  using tc::bf16;
  constexpr int MT = 4;           // 16-row m-tiles of a warp (64 rows)
  constexpr int NT = BV / 4 / 8;  // 8-column n-tiles of a warp
  constexpr int R = 2 * MT;       // rows a thread holds: mt * 2 + half
  constexpr int XS = KS + 8;      // x slice row stride (16 bytes of pad)
  constexpr int WS = VD ? KS + 8 : BV + 8;  // (v, k) or (k, v) rows
  constexpr int XE = TC_BT * XS;
  constexpr int STAGE = tc_stage_elems<VD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* red_m = reinterpret_cast<float*>(ring + NST * STAGE);  // [4][128]
  float* red_s = red_m + 4 * TC_BT;                              // [4][128]
  float* ll_s = red_s + 4 * TC_BT;                               // [128]
  int* lbl_s = reinterpret_cast<int*>(ll_s + TC_BT);             // [128]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wc = warp & 3;              // the warp's column quarter
  const int row0 = (warp >> 2) * 64;    // the warp's first row in the tile
  const int col0 = wc * (BV / 4);       // its first column in a vocab tile
  const int g = lane >> 2, t4 = lane & 3;
  const int t0 = blockIdx.x * TC_BT;
  const int nvt = (a.V + BV - 1) / BV;
  const int vt_begin = blockIdx.y * a.tiles_per_split;
  const int ntile = max(0, min(nvt, vt_begin + a.tiles_per_split) - vt_begin);
  const int nk = (a.d + KS - 1) / KS;
  const int total = ntile * nk;
  const bool vec = a.vec != 0;

  // the running (max, sum) of this thread's rows row0 + mt * 16 + half * 8
  // + g, r = mt * 2 + half, over its own columns (forward)
  float m[R], s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    s[r] = 0.f;
  }
  // a label outside [0, V) owns no column (-1): its ce (forward) or its dl
  // row (dlogits) is NaN; the first barrier of the loop publishes these
  const float nan = __int_as_float(0x7fffffff);
  if (tid < TC_BT) {
    const int t = t0 + tid;
    const int l = t < a.T ? a.labels[t] : -1;
    const bool bad = t < a.T && (l < 0 || l >= a.V);
    lbl_s[tid] = bad ? -1 : l;
    ll_s[tid] = bad ? nan : 0.f;
  }

  auto load = [&](int i) {
    const int v0 = (vt_begin + i / nk) * BV, k0 = (i % nk) * KS;
    bf16* xs = ring + (i % NST) * STAGE;
    load_block<TC_BT, KS>(xs, XS, a.x, a.d, t0, k0, a.T, a.d, vec, tid);
    if (VD)
      load_block<BV, KS>(xs + XE, WS, a.w, a.d, v0, k0, a.V, a.d, vec, tid);
    else
      load_block<KS, BV>(xs + XE, WS, a.w, a.V, k0, v0, a.d, a.V, vec, tid);
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < total) load(i);
    tc::cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    tc::cp_async_wait<NST - 2>();  // slice i has landed (this thread's part)
    __syncthreads();  // ... every thread's, and slice i - 1 is consumed
    if (i + NST - 1 < total) load(i + NST - 1);  // into slice i - 1's stage
    tc::cp_async_commit();
    const bf16* xs = ring + (i % NST) * STAGE;
    const bf16* ws = xs + XE;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::ldsm_x4(af[mt], tc::a_addr(xs, XS, row0 + mt * 16, kk, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        if (VD)
          tc::ldsm_x4(bb, tc::b_addr(ws, WS, col0 + np * 16, kk, lane));
        else
          tc::ldsm_x4_t(bb, tc::a_addr(ws, WS, kk, col0 + np * 16, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {  // each mma from zero, then added
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          tc::mma(p0, af[mt], bb[0], bb[1]);
          tc::mma(p1, af[mt], bb[2], bb[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][2 * np][e] += p0[e];
            acc[mt][2 * np + 1][e] += p1[e];
          }
        }
      }
    }
    if ((i + 1) % nk != 0) continue;

    // the vocab tile is complete: column of (n, e) is cbase + n * 8 + e
    const int v0 = (vt_begin + i / nk) * BV;
    const int cbase = v0 + col0 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + h * 8 + g;
        const int lbl = lbl_s[row];
        if (!DL) {
          const int r = mt * 2 + h;
          float tmax = NEG_INF;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (cbase + n * 8 + e < a.V)
                tmax = fmaxf(tmax, acc[mt][n][2 * h + e]);
          const float m_new = fmaxf(m[r], tmax);
          float sum = s[r] * expf(m[r] - m_new);
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = cbase + n * 8 + e;
              const float val = acc[mt][n][2 * h + e];
              if (col < a.V) sum += expf(val - m_new);
              if (col == lbl) ll_s[row] = val;  // the label's one owner
            }
          s[r] = sum;
          m[r] = m_new;
        } else {
          const int t = t0 + row;
          if (t >= a.T) continue;
          const float lse = a.lse[t], gce = a.gce[t];
          const float coef = lbl < 0 ? nan : a.coef[t];
          bf16* hi_row = a.dl + (long long)t * a.V;
          bf16* lo_row = a.dl + ((long long)a.T + t) * a.V;
          const bool pairs = (a.V & 1) == 0;  // 4-byte aligned pairs
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int col = cbase + n * 8;
            if (col >= a.V) continue;
            float p[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p[e] = expf(acc[mt][n][2 * h + e] - lse) * coef -
                     (col + e == lbl ? gce : 0.f);
            uint32_t hi, lo;
            tc::split(p[0], p[1], hi, lo);
            if (pairs) {  // col is even, so col + 1 < V too
              *reinterpret_cast<uint32_t*>(hi_row + col) = hi;
              *reinterpret_cast<uint32_t*>(lo_row + col) = lo;
            } else {
              const bf16* h2 = reinterpret_cast<const bf16*>(&hi);
              const bf16* l2 = reinterpret_cast<const bf16*>(&lo);
              hi_row[col] = h2[0];
              lo_row[col] = l2[0];
              if (col + 1 < a.V) {
                hi_row[col + 1] = h2[1];
                lo_row[col + 1] = l2[1];
              }
            }
          }
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  if (DL) return;

  // merge each row's (max, sum) over its 4 lanes, then over the 4 warp
  // columns in order
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[r], off);
      const float mn = fmaxf(m[r], mo);
      s[r] = s[r] * expf(m[r] - mn) + so * expf(mo - mn);
      m[r] = mn;
    }
    if (t4 == 0) {
      const int row = row0 + (r >> 1) * 16 + (r & 1) * 8 + g;
      red_m[wc * TC_BT + row] = m[r];
      red_s[wc * TC_BT + row] = s[r];
    }
  }
  __syncthreads();  // red_m, red_s and ll_s are complete
  if (tid < TC_BT && t0 + tid < a.T) {
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 4; ++c) mx = fmaxf(mx, red_m[c * TC_BT + tid]);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sum += red_s[c * TC_BT + tid] * expf(red_m[c * TC_BT + tid] - mx);
    const long long o = (long long)blockIdx.y * a.T + t0 + tid;
    a.m_part[o] = mx;
    a.s_part[o] = sum;
    a.l_part[o] = ll_s[tid];
  }
}

template <int BV, int KS, int NST, bool VD>
__global__ void __launch_bounds__(TC_THREADS, BV <= 128 ? 2 : 1)
    xent_fwd_tc_kernel(const XentArgs a) {
  xent_tc_body<BV, KS, NST, VD, false>(a);
}

template <int BV, int KS, int NST, bool VD>
__global__ void __launch_bounds__(TC_THREADS, BV <= 128 ? 2 : 1)
    dlogits_tc_kernel(const XentArgs a) {
  xent_tc_body<BV, KS, NST, VD, true>(a);
}

template <bool VD, bool DL>
const void* tc_kernel() {
  if (DL) return (const void*)dlogits_tc_kernel<TC_BV, TC_KS, TC_NST, VD>;
  return (const void*)xent_fwd_tc_kernel<TC_BV, TC_KS, TC_NST, VD>;
}

// Raise each instantiation's dynamic shared-memory limit once (its size is
// fixed), so a launch captured into a CUDA graph makes no attribute call
template <bool VD, bool DL>
bool tc_ready = false;

template <bool VD, bool DL>
cudaError_t tc_prepare() {
  if (!tc_ready<VD, DL>) {
    cudaError_t err = cudaFuncSetAttribute(
        tc_kernel<VD, DL>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem_bytes<VD>());
    if (err != cudaSuccess) return err;
    tc_ready<VD, DL> = true;
  }
  return cudaSuccess;
}

template <bool VD, bool DL>
cudaError_t tc_info_inst(int* smem, int* ctas_per_sm) {
  *smem = (int)tc_smem_bytes<VD>();
  cudaError_t err = tc_prepare<VD, DL>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, tc_kernel<VD, DL>(), TC_THREADS, tc_smem_bytes<VD>());
}

cudaError_t tc_info(int dl, int vd, int* smem, int* ctas_per_sm) {
  if (dl)
    return vd ? tc_info_inst<true, true>(smem, ctas_per_sm)
              : tc_info_inst<false, true>(smem, ctas_per_sm);
  return vd ? tc_info_inst<true, false>(smem, ctas_per_sm)
            : tc_info_inst<false, false>(smem, ctas_per_sm);
}

template <bool VD, bool DL>
cudaError_t launch_tc_inst(const XentArgs& a, int nsplit,
                           cudaStream_t stream) {
  cudaError_t err = tc_prepare<VD, DL>();
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.T + TC_BT - 1) / TC_BT), (unsigned)nsplit);
  if (DL)
    dlogits_tc_kernel<TC_BV, TC_KS, TC_NST, VD>
        <<<grid, TC_THREADS, tc_smem_bytes<VD>(), stream>>>(a);
  else
    xent_fwd_tc_kernel<TC_BV, TC_KS, TC_NST, VD>
        <<<grid, TC_THREADS, tc_smem_bytes<VD>(), stream>>>(a);
  return cudaGetLastError();
}

// vec: every row stride a multiple of 8 elements and both operands 16-byte
// aligned, so every 8-element chunk is whole or wholly outside
XentArgs tc_args(const void* x, const void* w, const void* labels, int T,
                 int d, int V, int vd, int tiles_per_split) {
  XentArgs a = {};
  a.x = (const tc::bf16*)x;
  a.w = (const tc::bf16*)w;
  a.labels = (const int*)labels;
  a.T = T;
  a.d = d;
  a.V = V;
  a.tiles_per_split = tiles_per_split;
  a.vec = d % 8 == 0 && (vd || V % 8 == 0) && tc::aligned16(x) &&
          tc::aligned16(w);
  return a;
}

cudaError_t tc_check(int d, int V, int nsplit, int tiles_per_split) {
  if (d <= 0 || V <= 0 || nsplit <= 0 || tiles_per_split <= 0 ||
      nsplit > 65535 || (long long)nsplit * tiles_per_split * TC_BV < V)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t launch_fwd_tc(const void* x, const void* w, const void* labels,
                          void* part, void* ce, void* zl, void* lse,
                          int T_rows, int d, int V, int vd, int nsplit,
                          int tiles_per_split, float z_loss_weight,
                          void* stream) {
  if (T_rows <= 0) return cudaSuccess;
  cudaError_t err = tc_check(d, V, nsplit, tiles_per_split);
  if (err != cudaSuccess) return err;
  cudaStream_t st = (cudaStream_t)stream;
  XentArgs a = tc_args(x, w, labels, T_rows, d, V, vd, tiles_per_split);
  a.m_part = (float*)part;
  a.s_part = a.m_part + (long long)nsplit * T_rows;
  a.l_part = a.s_part + (long long)nsplit * T_rows;
  err = vd ? launch_tc_inst<true, false>(a, nsplit, st)
           : launch_tc_inst<false, false>(a, nsplit, st);
  if (err != cudaSuccess) return err;
  xent_combine_kernel<<<(unsigned)((T_rows + 255) / 256), 256, 0, st>>>(
      a.m_part, a.s_part, a.l_part, (float*)ce, (float*)zl, (float*)lse,
      T_rows, nsplit, z_loss_weight);
  return cudaGetLastError();
}

cudaError_t launch_dl_tc(const void* x, const void* w, const void* labels,
                         const void* lse, const void* coef, const void* gce,
                         void* dl, int T_rows, int d, int V, int vd,
                         int nsplit, int tiles_per_split, void* stream) {
  if (T_rows <= 0) return cudaSuccess;
  cudaError_t err = tc_check(d, V, nsplit, tiles_per_split);
  if (err != cudaSuccess) return err;
  XentArgs a = tc_args(x, w, labels, T_rows, d, V, vd, tiles_per_split);
  a.lse = (const float*)lse;
  a.coef = (const float*)coef;
  a.gce = (const float*)gce;
  a.dl = (tc::bf16*)dl;
  return vd ? launch_tc_inst<true, true>(a, nsplit, (cudaStream_t)stream)
            : launch_tc_inst<false, true>(a, nsplit, (cudaStream_t)stream);
}

// The splits of the bf16 kernels: two waves of the CTAs the card holds at
// once, so each split has the same number of vocab tiles (the last fewer)
cudaError_t tc_plan(int dl, int T, int V, int vd, int* nsplit,
                    int* tiles_per_split) {
  if (T <= 0 || V <= 0) return cudaErrorInvalidValue;
  int smem = 0, ctas = 0, dev = 0, sms = 0;
  cudaError_t err = tc_info(dl, vd, &smem, &ctas);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long row_tiles = (T + TC_BT - 1) / TC_BT;
  const long long vtiles = (V + TC_BV - 1) / TC_BV;
  long long want = 2LL * (ctas > 0 ? ctas : 1) * sms / row_tiles;
  want = want < 1 ? 1 : (want > vtiles ? vtiles : want);
  const long long per = (vtiles + want - 1) / want;
  *tiles_per_split = (int)per;
  *nsplit = (int)((vtiles + per - 1) / per);
  return *nsplit > 65535 ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* labels,
                   void* part, void* ce, void* zl, void* lse, int T_rows,
                   int d, int V, int vd, int nsplit, int tiles_per_split,
                   float z_loss_weight, void* stream) {
  if (T_rows <= 0) return cudaSuccess;
  if (d <= 0 || V <= 0 || nsplit <= 0 || tiles_per_split <= 0 ||
      nsplit > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* m_part = (float*)part;
  float* s_part = m_part + (long long)nsplit * T_rows;
  float* l_part = s_part + (long long)nsplit * T_rows;
  dim3 grid((unsigned)((T_rows + BT - 1) / BT), (unsigned)nsplit);
  if (vd)
    xent_partial_kernel<T, true><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (const int*)labels, m_part, s_part, l_part,
        T_rows, d, V, tiles_per_split);
  else
    xent_partial_kernel<T, false><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const T*)w, (const int*)labels, m_part, s_part, l_part,
        T_rows, d, V, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_combine_kernel<<<(unsigned)((T_rows + 255) / 256), 256, 0, st>>>(
      m_part, s_part, l_part, (float*)ce, (float*)zl, (float*)lse, T_rows,
      nsplit, z_loss_weight);
  return cudaGetLastError();
}

}  // namespace

// part: 3 * nsplit * T floats of scratch; every split owns tiles_per_split
// 128-wide vocab tiles (the last one fewer), nsplit * tiles_per_split >=
// ceil(V / 128); vd = 1 for a (V, d) W
extern "C" int softmax_xent_fwd_f32(const void* x, const void* w,
                                    const void* labels, void* part, void* ce,
                                    void* zl, void* lse, int T, int d, int V,
                                    int vd, int nsplit, int tiles_per_split,
                                    float z_loss_weight, void* stream) {
  return (int)launch<float>(x, w, labels, part, ce, zl, lse, T, d, V, vd,
                            nsplit, tiles_per_split, z_loss_weight, stream);
}

extern "C" int softmax_xent_fwd_bf16(const void* x, const void* w,
                                     const void* labels, void* part, void* ce,
                                     void* zl, void* lse, int T, int d, int V,
                                     int vd, int nsplit, int tiles_per_split,
                                     float z_loss_weight, void* stream) {
  return (int)launch_fwd_tc(x, w, labels, part, ce, zl, lse, T, d, V, vd,
                            nsplit, tiles_per_split, z_loss_weight, stream);
}

// The bf16 backward's dl = exp(logits - lse) coef - onehot g_ce as bf16 hi
// (rows [0, T)) and lo (rows [T, 2T)) of dl (2T, V); lse, coef and g_ce
// (T,) float32; the splits as for the forward (softmax_xent_bf16_plan)
extern "C" int softmax_xent_dlogits_bf16(const void* x, const void* w,
                                         const void* labels, const void* lse,
                                         const void* coef, const void* gce,
                                         void* dl, int T, int d, int V,
                                         int vd, int nsplit,
                                         int tiles_per_split, void* stream) {
  return (int)launch_dl_tc(x, w, labels, lse, coef, gce, dl, T, d, V, vd,
                           nsplit, tiles_per_split, stream);
}

// nsplit and tiles_per_split of a bf16 call (dl = 1: the dlogits kernel)
extern "C" int softmax_xent_bf16_plan(int dl, int T, int V, int vd,
                                      int* nsplit, int* tiles_per_split) {
  return (int)tc_plan(dl, T, V, vd, nsplit, tiles_per_split);
}

// A bf16 kernel's dynamic shared memory (bytes) and resident CTAs per SM
// (dl = 1: the dlogits kernel; vd = 1: a (V, d) W)
extern "C" int softmax_xent_bf16_info(int dl, int vd, int* smem,
                                      int* ctas_per_sm) {
  return (int)tc_info(dl, vd, smem, ctas_per_sm);
}
