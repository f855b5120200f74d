// Mamba-2 SSD (state-space duality) chunked scan, forward.  For one batch
// row and one head, over chunks of c positions taken in order, with
// cum = cumsum(dt * A) inside the chunk:
//     y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . state^T) + D x_i
//     s'   = exp(cum_end) s + sum_j dt_j exp(cum_end - cum_j) x_j^T B_j
// x (b, l, h, p), B and C (b, l, g, n) in float32 or bfloat16 (head hh reads
// group hh / (h / g)), dt (b, l, h), A (h,), D (h,) and the entering state
// h0 (b, h, p, n) in float32; y (b, l, h, p) in x's type, the final state
// (b, h, p, n) in float32.  All sums are float32 (the bf16 kernel's
// products take bf16 operands, float32 ones split into two bf16 parts).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:_kernel
// (reached through _ssd_fwd, ssd_scan.py:64).  There the grid's chunk axis
// runs in order on one core and the (p, n) state waits in VMEM between grid
// steps, after the wrapper has materialized B and C repeated over the heads
// and every operand transposed to (b*h, chunks, c, .) in HBM.  Here:
//   - B and C are read in place by group index, and x, B, C through their
//     batch and row strides (slices of the in-projection are not copied);
//   - blocks run in parallel in no order, so one CTA owns one (batch, head,
//     block of its p channels) and walks the chunks in a loop, its block's
//     float32 state rows kept across the chunks (in shared memory in the
//     float32 kernel, whose 32-channel blocks double the CTAs at p = 64;
//     in the accumulator registers in the bf16 one);
//   - the (c, c) score matrix (256 KB in float32 at c = 256) does not fit
//     in shared memory, nor do whole-chunk float32 B and C (128 KB each at
//     n = 128): the chunk is tiled 64 query rows by 64 key rows, and only
//     tiles on or below the diagonal are formed;
//   - the decay exp(cum_i - cum_j) is computed only under the causal mask:
//     above the diagonal the difference is positive and can overflow, where
//     the reference's where(causal, exp(seg), 0) forms inf;
//   - h0 is read as the entering state (the Pallas wrapper hands a carried
//     state to its jnp reference instead).
// cum is summed in order by one thread with separate float32 roundings of
// dt * A and of each sum, as the reference's cumsum does.
//
// What bounds it: per (batch, head, chunk) ~c^2 n / 2 multiply-adds for the
// causal scores, c^2 p / 2 for their product with x, and c p n each for the
// entering state and the state update; the bytes (x, B, C, dt read once, y
// and the state written once) are ~40x fewer than the operations need at
// the float32 rate.  Two kernels, chosen by dtype:
//
// float32: ssd_scan_kernel, on the CUDA cores in float32 from shared memory:
// 4 x 4 score micro-tiles per thread, 8 outputs per thread for y, 32
// channels a CTA.
//
// bfloat16: ssd_tc_kernel, on the tensor cores (mma.sync.m16n8k16 bf16 ->
// f32 with ldmatrix and cp.async, csrc/tc_mma.cuh), 8 warps a CTA.  At
// mamba2-370m's prefill (b 4, l 2048, 32 heads of p = 64, one group, n 128,
// chunk 256) the function needs ~13 GFLOP of products (C B^T once per
// group) and moves ~77 MB: bound by bytes, ~23 us.  This kernel does ~39
// GFLOP of HMMA work (C B^T once per head, three operands split in two).
//   - Scores S = C B^T: bf16 operands, exact in float32.  Only the 64 x
//     64 tiles on or below the diagonal are formed, and inside a diagonal
//     tile a warp skips the 16-key steps wholly above its 16 rows.
//   - The masked, decayed scores S o exp(cum_i - cum_j) o dt_j are formed
//     in the accumulator registers (the decay only under the causal mask)
//     and enter Y += P X as a bf16 hi + lo pair straight from the C
//     fragments, as the flash forward feeds P (tc_mma.cuh).  x is bf16 and
//     exact.  Why the pair: the port holds a bf16 y to one bf16 step of
//     the float32-computed value (kernels/ops.py BF16_RTOL), and P rounded
//     once to bf16 misses that 3-36x (tests/test_torch_ssd_tc.py).
//   - The entering state's part diag(exp(cum)) C state^T: the float32
//     state is staged in shared memory once per chunk as a bf16 hi + lo
//     pair (once rounded: 2-39x the gate).
//   - The update state = exp(cum_end) state + (x o w)^T B, w_j = dt_j
//     exp(cum_end - cum_j): x o w enters as hi + lo, made in registers from
//     ldmatrix.trans fragments of x (once rounded: the state misses 1e-4 of
//     its largest entry 1.4-2.4x).  The (PB, n) float32 state stays in the
//     accumulator registers across the chunks.
//   - One CTA per (batch row, head, PB channels), PB = 64: a head's whole
//     p at the main shape (128 CTAs, one per SM at 140 KB of shared
//     memory), so C B^T is formed once per head.  8 warps in two key
//     groups: a query tile's 16 rows belong to two warps, each taking half
//     of every key tile (and every other 16-deep step of the entering
//     state's product); the second hands its y partial to the first through
//     shared memory at the query tile's end.  The state's columns are
//     split over the 8 warps.
//   - The chunk is walked as (query tile, key tile) steps in order; each
//     step's B and x key tiles (and a new query tile's C) come through a
//     two-stage cp.async ring filled one step ahead, across chunk
//     boundaries too.  The last query tile of a chunk visits every key
//     tile, so the state update rides on its steps.  Off the diagonal the
//     decay is a row factor times a key factor (both at most 1), so a
//     thread forms 2 expf a step there, not 32.
//   - Instantiations: n = 128 exact (no state-width guard in the unrolled
//     loops); n < 128 guarded, n up to 256 guarded with 32 channels and 4
//     warps; n padded to 16 in shared memory.  p, chunk and the groups are
//     runtime values everywhere.
//     A dim not a multiple of 8, or a misaligned pointer or stride, takes
//     plain loads instead of cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PB = 32;         // state rows (head channels) per CTA
constexpr int TI = 64;         // query rows per tile
constexpr int TJ = 64;         // key rows per tile
constexpr int MAX_CHUNK = 256;
constexpr int MAX_STATE = 256;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;   // may be null
  const float* h0;  // may be null
  void* y;
  float* state;
  int b, l, h, p, g, n, chunk;
  long long x_sb, x_sl, b_sb, b_sl, c_sb, c_sl;
};

// shared memory, in floats: the state (PB x ns), a query tile of C and a
// key tile of B (64 x ns each, ns = n + 1 so that a warp reading one column
// of 32 rows hits 32 banks), a key tile of x (64 x PB), the masked scores
// (64 x 65) and the chunk's dt and cum
size_t smem_bytes(int n) {
  const size_t ns = (size_t)n + 1;
  return sizeof(float) * ((PB + TI + TJ) * ns + (size_t)TJ * PB +
                          (size_t)TI * (TJ + 1) + 2 * MAX_CHUNK);
}

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n, ns = n + 1;
  float* st = smem;               // PB x ns
  float* ci = st + PB * ns;       // TI x ns
  float* bj = ci + TI * ns;       // TJ x ns
  float* xj = bj + TJ * ns;       // TJ x PB
  float* sm = xj + TJ * PB;       // TI x (TJ + 1)
  float* cum = sm + TI * (TJ + 1);  // MAX_CHUNK
  float* dts = cum + MAX_CHUNK;     // MAX_CHUNK

  const int tid = threadIdx.x;
  const int bb = blockIdx.x / a.h, hh = blockIdx.x % a.h;
  const int gg = hh / (a.h / a.g);
  const int p0 = blockIdx.y * PB;
  const int pw = min(PB, a.p - p0);  // channels of this CTA
  const int c = a.chunk;
  const int nc = a.l / c;
  const float* X = (const float*)a.x + bb * a.x_sb + (long long)hh * a.p + p0;
  const float* Bg = (const float*)a.B + bb * a.b_sb + (long long)gg * n;
  const float* Cg = (const float*)a.C + bb * a.c_sb + (long long)gg * n;
  const long long y_sl = (long long)a.h * a.p;
  float* Y =
      (float*)a.y + (long long)bb * a.l * y_sl + (long long)hh * a.p + p0;
  const float* DT = a.dt + (long long)bb * a.l * a.h + hh;
  const float Ah = a.A[hh];
  const float Dh = a.D ? a.D[hh] : 0.f;
  const long long st_off = ((long long)bb * a.h + hh) * a.p + p0;

  for (int e = tid; e < PB * n; e += THREADS) {
    const int r = e / n, k = e % n;
    st[r * ns + k] =
        (a.h0 && r < pw) ? a.h0[(st_off + r) * n + k] : 0.f;
  }

  // y: channel pc of rows rw + 8 r; scores: rows ty + 16 r, cols tx + 16 q
  const int pc = tid & 31, rw = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int ntiles = (c + TI - 1) / TI;

  for (int ic = 0; ic < nc; ++ic) {
    const long long t0 = (long long)ic * c;
    __syncthreads();  // the previous chunk is done with dts, cum and st
    for (int i = tid; i < c; i += THREADS) dts[i] = DT[(t0 + i) * a.h];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < c; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], Ah));
        cum[i] = s;
      }
    }
    __syncthreads();
    const float cend = cum[c - 1];

    // ---- y, one 64-row query tile at a time --------------------------------
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TI;
      __syncthreads();  // the previous tile is done with ci
      for (int e = tid; e < TI * n; e += THREADS) {
        const int r = e / n, k = e % n;
        ci[r * ns + k] =
            (i0 + r < c) ? Cg[(t0 + i0 + r) * a.c_sl + k] : 0.f;
      }
      __syncthreads();
      // the entering state's part, exp(cum_i) (C_i . state^T)
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = rw + 8 * r;
        float s = 0.f;
        for (int k = 0; k < n; ++k) s = fmaf(ci[i * ns + k], st[pc * ns + k], s);
        acc[r] = (i0 + i < c) ? s * expf(cum[i0 + i]) : 0.f;
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TJ;
        __syncthreads();  // the previous key tile is done with bj, xj, sm
        for (int e = tid; e < TJ * n; e += THREADS) {
          const int r = e / n, k = e % n;
          bj[r * ns + k] =
              (j0 + r < c) ? Bg[(t0 + j0 + r) * a.b_sl + k] : 0.f;
        }
        for (int e = tid; e < TJ * PB; e += THREADS) {
          const int r = e / PB, q = e % PB;
          xj[e] = (j0 + r < c && q < pw)
                      ? X[(t0 + j0 + r) * a.x_sl + q] : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[r][q] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ci[(ty + 16 * r) * ns + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = bj[(tx + 16 * q) * ns + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * q;
            float v = 0.f;
            if (j <= i && i < c)  // the decay only under the causal mask
              v = s[r][q] * expf(cum[i] - cum[j]) * dts[j];
            sm[(ty + 16 * r) * (TJ + 1) + tx + 16 * q] = v;
          }
        }
        __syncthreads();
        const int jn = min(TJ, c - j0);
        for (int j = 0; j < jn; ++j) {
          const float xv = xj[j * PB + pc];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[r] = fmaf(sm[(rw + 8 * r) * (TJ + 1) + j], xv, acc[r]);
        }
      }
      if (pc < pw) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + rw + 8 * r;
          if (i < c) {
            float v = acc[r];
            if (a.D) v = fmaf(Dh, X[(t0 + i) * a.x_sl + pc], v);
            Y[(t0 + i) * y_sl + pc] = v;
          }
        }
      }
    }

    // ---- the state update --------------------------------------------------
    __syncthreads();  // every query tile is done reading st
    const float dend = expf(cend);
    for (int e = tid; e < PB * n; e += THREADS) {
      const int r = e / n, k = e % n;
      st[r * ns + k] *= dend;
    }
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TJ;
      __syncthreads();  // the previous key tile is done with bj, xj
      for (int e = tid; e < TJ * n; e += THREADS) {
        const int r = e / n, k = e % n;
        bj[r * ns + k] =
            (j0 + r < c) ? Bg[(t0 + j0 + r) * a.b_sl + k] : 0.f;
      }
      for (int e = tid; e < TJ * PB; e += THREADS) {
        const int r = e / PB, q = e % PB, j = j0 + r;
        xj[e] = (j < c && q < pw)
                    ? X[(t0 + j) * a.x_sl + q] *
                          (dts[j] * expf(cend - cum[j]))
                    : 0.f;
      }
      __syncthreads();
      const int jn = min(TJ, c - j0);
      for (int e = tid; e < PB * n; e += THREADS) {
        const int r = e / n, k = e % n;
        float s = st[r * ns + k];
        for (int j = 0; j < jn; ++j) s = fmaf(xj[j * PB + r], bj[j * ns + k], s);
        st[r * ns + k] = s;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < PB * n; e += THREADS) {
    const int r = e / n, k = e % n;
    if (r < pw) a.state[(st_off + r) * n + k] = st[r * ns + k];
  }
}

// What both kernels take: whole chunks of at most MAX_CHUNK, a state of at
// most MAX_STATE columns, heads that divide over the groups
bool args_ok(const Args& a) {
  return a.g > 0 && a.h % a.g == 0 && a.n > 0 && a.n <= MAX_STATE &&
         a.chunk > 0 && a.chunk <= MAX_CHUNK && a.l % a.chunk == 0 &&
         (long long)a.b * a.h <= 0x7fffffffLL;
}

cudaError_t launch_f32(const Args& a, void* stream) {
  if (a.b <= 0 || a.h <= 0 || a.p <= 0) return cudaSuccess;
  if (!args_ok(a) || (a.p + PB - 1) / PB > 65535)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(a.n);
  // Raise the kernel's dynamic shared-memory limit once per size, so a
  // launch captured into a CUDA graph makes no attribute call.
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.p + PB - 1) / PB));
  ssd_scan_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// The channels per CTA, the keys per tile and the key groups (PB, KT, KG)
// of the n <= 128 instantiations; chosen on the card (PERF.md §6): at
// mamba2-370m's prefill on an H100 80GB HBM3 at 700 W, 64, 64, 2 took
// 0.324 ms, 32, 64, 2 0.343, 32, 64, 1 0.368, 64, 64, 1 0.371, 32, 32, 2
// 0.407, 32, 32, 1 0.417 (repro_torch.bench.fwd_kernels).
#ifndef SSD_TILES
#define SSD_TILES 64, 64, 2
#endif

constexpr int TC_WARPS = 4;  // warps a key group: 16 query rows each

__host__ __device__ constexpr int tc_ns(int dp) { return dp + 8; }

// Shared memory of one CTA, in bytes: C query tiles [2][TI][ns], B key tiles
// [2][KT][ns], x key tiles [2][KT][PB + 8] and the state's hi and lo parts
// [PB][ns] in bf16 (rows padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in 8 bank groups), then the chunk's dt, cum, w and the keys'
// decay factors in float32, and with two key groups the second group's y
// partial [TI][PB] in float32.
size_t tc_smem_bytes(int dp, int pb, int kt, int kg) {
  const size_t ns = tc_ns(dp);
  return sizeof(tc::bf16) * (2 * TI * ns + 2 * (size_t)kt * ns +
                             2 * (size_t)kt * (pb + 8) + 2 * (size_t)pb * ns) +
         sizeof(float) * (4 * MAX_CHUNK + (kg > 1 ? (size_t)TI * pb : 0));
}

// The last key tile of query tile it: key tiles run up to the query tile's
// last row (and the chunk's end), so the chunk's last query tile visits
// every key tile.
template <int KT>
__device__ __forceinline__ int last_key_tile(int it, int c) {
  return min((c - 1) / KT, (it * TI + TI - 1) / KT);
}

// One CTA per (batch row bb, head hh, PB channels from p0); the chunks in
// order.  NMAX bounds the padded state width dp (the state's columns live
// in registers); FULL: n == NMAX, so every state-width guard below folds.
// KG (1 or 2) key groups of 4 warps: warp rg of group kg owns query rows
// 16 rg .. 16 rg + 15 of a tile, the keys [kg KT / KG, (kg + 1) KT / KG) of
// every key tile and every KG-th 16-deep step of the entering state's
// product; the groups' y partials are added at the end of the query tile.
// The state's columns are split over all 4 KG warps.
template <int NMAX, int PB, int KT, int KG, bool FULL>
__global__ void __launch_bounds__(TC_WARPS * 32 * KG,
                                  KG == 2 && PB == 64 ? 1 : 2)
    ssd_tc_kernel(Args a, int vec) {
  using tc::bf16;
  static_assert(KG == 1 || KG == 2, "one or two key groups");
  constexpr int NT = TC_WARPS * 32 * KG;  // threads
  constexpr int KW = KT / KG;             // keys of a warp in a key tile
  constexpr int SN = KW / 8;              // its 8-key score tiles
  constexpr int PN = PB / 8;              // 8-channel output tiles
  constexpr int MS = PB / 16;             // 16-channel state m-tiles
  constexpr int WC = NMAX / (TC_WARPS * KG);  // state columns a warp owns
  constexpr int NS = WC / 8;              // their 8-column tiles
  static_assert(NS % 2 == 0 && SN % 2 == 0, "16-wide fragment pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n;
  const int dp = FULL ? NMAX : (n + 15) & ~15;
  const int ns = tc_ns(dp), xs = PB + 8;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [2][TI][ns]
  bf16* Bs = Cs + 2 * TI * ns;                   // [2][KT][ns]
  bf16* Xs = Bs + 2 * KT * ns;                   // [2][KT][xs]
  bf16* Sh = Xs + 2 * KT * xs;                   // [PB][ns]
  bf16* Sl = Sh + PB * ns;                       // [PB][ns]
  float* dts = reinterpret_cast<float*>(Sl + PB * ns);  // [MAX_CHUNK]
  float* cum = dts + MAX_CHUNK;
  float* wv = cum + MAX_CHUNK;
  float* kf = wv + MAX_CHUNK;
  float* yx = kf + MAX_CHUNK;  // [TI][PB], with two key groups

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % TC_WARPS, kg = warp / TC_WARPS;
  const int bb = blockIdx.x / a.h, hh = blockIdx.x % a.h;
  const int gg = hh / (a.h / a.g);
  const int p0 = blockIdx.y * PB;
  const int pw = min(PB, a.p - p0);  // channels of this CTA
  const int c = a.chunk;
  const int nc = a.l / c;
  const int nti = (c + TI - 1) / TI;
  const bf16* X = (const bf16*)a.x + bb * a.x_sb + (long long)hh * a.p + p0;
  const bf16* Bg = (const bf16*)a.B + bb * a.b_sb + (long long)gg * n;
  const bf16* Cg = (const bf16*)a.C + bb * a.c_sb + (long long)gg * n;
  const long long y_sl = (long long)a.h * a.p;
  bf16* Y = (bf16*)a.y + (long long)bb * a.l * y_sl + (long long)hh * a.p + p0;
  const float* DT = a.dt + (long long)bb * a.l * a.h + hh;
  const float Ah = a.A[hh];
  const float Dh = a.D ? a.D[hh] : 0.f;
  const long long st_off = ((long long)bb * a.h + hh) * a.p + p0;
  const int wr = rg * 16;      // the warp's first query row in a tile
  const int kw0 = kg * KW;     // its first key in a key tile
  const int wc = warp * WC;    // its first state column
  const bool pairs = (a.p & 1) == 0;  // y rows 4-byte aligned: bf16x2 stores

  // the step's B and x key tiles (stage sb) and, opening a query tile, its
  // C tile (stage sc)
  auto load_step = [&](int ic, int it, int jt, int sb, int sc) {
    const long long t0 = (long long)ic * c;
    tc::load_tile(Bs + sb * KT * ns, ns, Bg + t0 * a.b_sl, a.b_sl, jt * KT,
                  KT, n, dp, c, vec, tid, NT);
    tc::load_tile(Xs + sb * KT * xs, xs, X + t0 * a.x_sl, a.x_sl, jt * KT, KT,
                  pw, PB, c, vec, tid, NT);
    if (jt == 0)
      tc::load_tile(Cs + sc * TI * ns, ns, Cg + t0 * a.c_sl, a.c_sl, it * TI,
                    TI, n, dp, c, vec, tid, NT);
  };

  // the state: float32 accumulators [m-tile][column tile][4], rows
  // 16 mt + g (+ 8), columns wc + 8 nt + 2 t (+ 1)
  float sacc[MS][NS][4];
#pragma unroll
  for (int mt = 0; mt < MS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1);
        const int col = wc + nt * 8 + 2 * t + (e & 1);
        sacc[mt][nt][e] = (a.h0 && r < pw && col < n)
                              ? a.h0[(st_off + r) * n + col] : 0.f;
      }
  // stage the state entering the chunk as bf16 hi + lo parts
  auto stage_state = [&]() {
#pragma unroll
    for (int mt = 0; mt < MS; ++mt)
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const int col = wc + nt * 8 + 2 * t;
        if (FULL || col < dp)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = mt * 16 + g + 8 * h2;
            uint32_t hi, lo;
            tc::split(sacc[mt][nt][2 * h2], sacc[mt][nt][2 * h2 + 1], hi, lo);
            *reinterpret_cast<uint32_t*>(Sh + r * ns + col) = hi;
            *reinterpret_cast<uint32_t*>(Sl + r * ns + col) = lo;
          }
      }
  };
  stage_state();
  // y rows i0 + wr + g (+ 8) of the chunk at t0 from the finished
  // accumulators (bf16x2 stores where the row allows)
  auto store_y = [&](const float (&acc)[PB / 8][4], int i0, long long t0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + wr + g + 8 * r;
      if (i >= c) continue;
      bf16* yrow = Y + (t0 + i) * y_sl;
#pragma unroll
      for (int nt = 0; nt < PB / 8; ++nt) {
        const int ch = nt * 8 + 2 * t;
        const float v0 = acc[nt][2 * r], v1 = acc[nt][2 * r + 1];
        if (pairs && ch + 1 < pw) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + ch) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (ch < pw) yrow[ch] = __float2bfloat16_rn(v0);
          if (ch + 1 < pw) yrow[ch + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  };

  load_step(0, 0, 0, 0, 0);
  tc::cp_async_commit();
  int gs = 0, gq = 0;  // steps and query tiles so far (their stages' parity)
  // the chunk's dt, read a chunk ahead: positions tid, tid + NT, ...
  constexpr int DTN = (MAX_CHUNK + NT - 1) / NT;
  auto read_dt = [&](int ic, float (&v)[DTN]) {
#pragma unroll
    for (int k = 0; k < DTN; ++k) {
      const int i = tid + k * NT;
      v[k] = i < c ? DT[((long long)ic * c + i) * a.h] : 0.f;
    }
  };
  float dt_next[DTN];
  read_dt(0, dt_next);

  for (int ic = 0; ic < nc; ++ic) {
    const long long t0 = (long long)ic * c;
    __syncthreads();  // the previous chunk is done with dts, cum, wv, Sh, Sl
#pragma unroll
    for (int k = 0; k < DTN; ++k)
      if (tid + k * NT < nti * TI) dts[tid + k * NT] = dt_next[k];
    if (ic + 1 < nc) read_dt(ic + 1, dt_next);
    __syncthreads();
    if (tid == 0) {
      // dt read as float4s ahead of their sums (dts and cum do not alias),
      // so the chain is the adds alone
      const float4* __restrict__ d4 = reinterpret_cast<const float4*>(dts);
      float4* __restrict__ c4 = reinterpret_cast<float4*>(cum);
      float s = 0.f;
#pragma unroll 4
      for (int q = 0; q < nti * TI / 4; ++q) {
        const float4 v = d4[q];
        float4 o;
        // rows past a ragged chunk's end keep cum_end: finite, and no
        // larger than any cum (their dt is 0, and dt A <= 0)
        o.x = s = 4 * q < c ? __fadd_rn(s, __fmul_rn(v.x, Ah)) : s;
        o.y = s = 4 * q + 1 < c ? __fadd_rn(s, __fmul_rn(v.y, Ah)) : s;
        o.z = s = 4 * q + 2 < c ? __fadd_rn(s, __fmul_rn(v.z, Ah)) : s;
        o.w = s = 4 * q + 3 < c ? __fadd_rn(s, __fmul_rn(v.w, Ah)) : s;
        c4[q] = o;
      }
    }
    __syncthreads();
    const float cend = cum[c - 1];
    for (int j = tid; j < nti * TI; j += NT) {
      wv[j] = dts[j] * expf(cend - cum[j]);  // 0 past the chunk's end
      // the key's factor of the decay from its key tile's last key r(j):
      // exp(cum_r - cum_j) dt_j <= dt_j
      const int r = min(j - j % KT + KT - 1, nti * TI - 1);
      kf[j] = expf(cum[r] - cum[j]) * dts[j];
    }
    // (wv and kf are read after the first step's barrier)
    const bool has_state = ic > 0 || a.h0 != nullptr;

    for (int it = 0; it < nti; ++it, ++gq) {
      const int i0 = it * TI;
      const int jl = last_key_tile<KT>(it, c);
      const bool last_q = it == nti - 1;
      const bf16* Ct = Cs + (gq & 1) * TI * ns;
      float cum_r[2];
      float acc[PN][4];
#pragma unroll
      for (int nt = 0; nt < PN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

      for (int jt = 0; jt <= jl; ++jt, ++gs) {
        // prefetch the next step into the other stages
        {
          int nic = ic, nit = it, njt = jt + 1;
          if (njt > jl) {
            njt = 0;
            if (++nit == nti) {
              nit = 0;
              ++nic;
            }
          }
          if (nic < nc)
            load_step(nic, nit, njt, (gs + 1) & 1, (gq + 1) & 1);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();  // all but the newest group: this step's
        __syncthreads();
        const bf16* Bt = Bs + (gs & 1) * KT * ns;
        const bf16* Xt = Xs + (gs & 1) * KT * xs;
        const int j0 = jt * KT;

        if (jt == 0) {
          cum_r[0] = cum[i0 + wr + g];
          cum_r[1] = cum[i0 + wr + g + 8];
          if (has_state) {
            // acc = exp(cum_i) (C_i . state^T), the state as hi + lo; the
            // group's share of the 16-deep steps
#pragma unroll
            for (int ks = 0; ks < NMAX / 16 / KG; ++ks) {
              const int k0 = (ks * KG + kg) * 16;
              if (FULL || k0 < dp) {
                uint32_t af[4];
                tc::ldsm_x4(af, tc::a_addr(Ct, ns, wr, k0, lane));
#pragma unroll
                for (int np = 0; np < PB / 16; ++np) {
                  uint32_t bh[4], bl[4];
                  tc::ldsm_x4(bh, tc::b_addr(Sh, ns, np * 16, k0, lane));
                  tc::ldsm_x4(bl, tc::b_addr(Sl, ns, np * 16, k0, lane));
                  tc::mma(acc[2 * np], af, bh[0], bh[1]);
                  tc::mma(acc[2 * np + 1], af, bh[2], bh[3]);
                  tc::mma(acc[2 * np], af, bl[0], bl[1]);
                  tc::mma(acc[2 * np + 1], af, bl[2], bl[3]);
                }
              }
            }
            const float e0 = expf(cum_r[0]), e1 = expf(cum_r[1]);
#pragma unroll
            for (int nt = 0; nt < PN; ++nt) {
              acc[nt][0] *= e0;
              acc[nt][1] *= e0;
              acc[nt][2] *= e1;
              acc[nt][3] *= e1;
            }
          }
          if (last_q) {  // the state decays over the whole chunk
            const float dend = expf(cend);
#pragma unroll
            for (int mt = 0; mt < MS; ++mt)
#pragma unroll
              for (int nt = 0; nt < NS; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) sacc[mt][nt][e] *= dend;
          }
        }

        // ---- scores, masked and decayed, then Y += P X ---------------------
        // the warp's keys [j0 + kw0, + KW) against its rows; a 16-key step
        // wholly after the warp's last row is skipped
        const int last_row = i0 + wr + 15;
        const int jw = j0 + kw0;  // the warp's first key
        const bool diag = j0 + KT - 1 > i0 + wr;  // some key above some row
        float s[SN][4];
#pragma unroll
        for (int nt = 0; nt < SN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NMAX; kk += 16)
          if (FULL || kk < dp) {
            uint32_t af[4];
            tc::ldsm_x4(af, tc::a_addr(Ct, ns, wr, kk, lane));
#pragma unroll
            for (int np = 0; np < SN / 2; ++np)
              if (jw + np * 16 <= last_row) {
                uint32_t bf[4];
                tc::ldsm_x4(bf, tc::b_addr(Bt, ns, kw0 + np * 16, kk, lane));
                tc::mma(s[2 * np], af, bf[0], bf[1]);
                tc::mma(s[2 * np + 1], af, bf[2], bf[3]);
              }
          }
        if (diag) {  // the decay only under the causal mask
#pragma unroll
          for (int nt = 0; nt < SN; ++nt) {
            if (jw + nt * 8 <= last_row) {  // a branch of the whole warp
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int i = i0 + wr + g + 8 * r;
                const int j = jw + nt * 8 + 2 * t + (e & 1);
                s[nt][e] = j <= i
                    ? s[nt][e] * expf(cum_r[r] - cum[j]) * dts[j] : 0.f;
              }
            } else {  // every key after the warp's last row
#pragma unroll
              for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
            }
          }
        } else {
          // every key of the tile is at or before every row: the decay as a
          // row factor exp(cum_i - cum_r) times the key's factor from the
          // tile's last key r (both at most 1: no overflow, one rounding
          // more)
          const int rk = min(j0 + KT - 1, nti * TI - 1);
          const float f0 = expf(cum_r[0] - cum[rk]);
          const float f1 = expf(cum_r[1] - cum[rk]);
#pragma unroll
          for (int nt = 0; nt < SN; ++nt) {
            const float2 k2 = *reinterpret_cast<const float2*>(
                kf + jw + nt * 8 + 2 * t);
            s[nt][0] *= f0 * k2.x;
            s[nt][1] *= f0 * k2.y;
            s[nt][2] *= f1 * k2.x;
            s[nt][3] *= f1 * k2.y;
          }
        }
#pragma unroll
        for (int kc = 0; kc < SN / 2; ++kc)
          if (jw + kc * 16 <= last_row) {
            uint32_t ph[4], pl[4];
            tc::split_frag(s[2 * kc], s[2 * kc + 1], ph, pl);
#pragma unroll
            for (int np = 0; np < PB / 16; ++np) {
              uint32_t bf[4];
              tc::ldsm_x4_t(bf, tc::a_addr(Xt, xs, kw0 + kc * 16, np * 16,
                                           lane));
              tc::mma(acc[2 * np], ph, bf[0], bf[1]);
              tc::mma(acc[2 * np + 1], ph, bf[2], bf[3]);
              tc::mma(acc[2 * np], pl, bf[0], bf[1]);
              tc::mma(acc[2 * np + 1], pl, bf[2], bf[3]);
            }
          }

        // ---- the state update on the chunk's last query tile ---------------
        if (last_q) {
#pragma unroll
          for (int kc = 0; kc < KT / 16; ++kc) {
            // (x o w)^T as the A operand: the ldmatrix.trans fragments of
            // x's key tile (b0, b1 of channels 0-7, then 8-15) are a0, a2,
            // a1, a3 of x^T; each column (key) times its w
            const float* w = wv + j0 + kc * 16 + 2 * t;
            const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
            uint32_t xh[MS][4], xl[MS][4];
#pragma unroll
            for (int mt = 0; mt < MS; ++mt) {
              uint32_t r[4];
              tc::ldsm_x4_t(r, tc::a_addr(Xt, xs, kc * 16, mt * 16, lane));
              const uint32_t frag[4] = {r[0], r[2], r[1], r[3]};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&frag[q]));
                const bool hi_k = q >= 2;  // keys 8 + 2t, 9 + 2t
                tc::split(f.x * (hi_k ? w8 : w0), f.y * (hi_k ? w9 : w1),
                          xh[mt][q], xl[mt][q]);
              }
            }
#pragma unroll
            for (int np = 0; np < NS / 2; ++np)
              if (FULL || wc + np * 16 < dp) {
                uint32_t bf[4];
                tc::ldsm_x4_t(bf, tc::a_addr(Bt, ns, kc * 16, wc + np * 16,
                                             lane));
#pragma unroll
                for (int mt = 0; mt < MS; ++mt) {
                  tc::mma(sacc[mt][2 * np], xh[mt], bf[0], bf[1]);
                  tc::mma(sacc[mt][2 * np + 1], xh[mt], bf[2], bf[3]);
                }
#pragma unroll
                for (int mt = 0; mt < MS; ++mt) {
                  tc::mma(sacc[mt][2 * np], xl[mt], bf[0], bf[1]);
                  tc::mma(sacc[mt][2 * np + 1], xl[mt], bf[2], bf[3]);
                }
              }
          }
        }

        if (jt == jl) {
          // D x_i (with KT == TI the last key tile is the query tile's own
          // rows, in shared memory, zero past pw), then with two key groups
          // the second hands its partial to the first
          if (kg == 0 && a.D) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = i0 + wr + g + 8 * r;
              const bf16* xrow = KT == TI ? Xt + (i - i0) * xs
                                          : X + (t0 + min(i, c - 1)) * a.x_sl;
#pragma unroll
              for (int nt = 0; nt < PN; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int ch = nt * 8 + 2 * t + e;
                  if (ch < pw)
                    acc[nt][2 * r + e] = fmaf(
                        Dh, __bfloat162float(xrow[ch]), acc[nt][2 * r + e]);
                }
            }
          }
          if (KG > 1 && kg == 1) {
#pragma unroll
            for (int nt = 0; nt < PN; ++nt)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                *reinterpret_cast<float2*>(
                    yx + (wr + g + 8 * r) * PB + nt * 8 + 2 * t) =
                    make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
          }
          if (KG == 1) store_y(acc, i0, t0);
        }
        __syncthreads();  // this step's stages are consumed before refilling
        // (yx is written again only at the next query tile's end, after
        // the first group has passed the next step's barrier)
        if (KG > 1 && jt == jl && kg == 0) {
#pragma unroll
          for (int nt = 0; nt < PN; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 o = *reinterpret_cast<const float2*>(
                  yx + (wr + g + 8 * r) * PB + nt * 8 + 2 * t);
              acc[nt][2 * r] += o.x;
              acc[nt][2 * r + 1] += o.y;
            }
          store_y(acc, i0, t0);
        }
      }
    }
    if (ic + 1 < nc) stage_state();  // read after the next chunk's barrier
  }

#pragma unroll
  for (int mt = 0; mt < MS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1);
        const int col = wc + nt * 8 + 2 * t + (e & 1);
        if (r < pw && col < n)
          a.state[(st_off + r) * n + col] = sacc[mt][nt][e];
      }
}

// The dynamic shared-memory limit each instantiation was raised to: raised
// once per larger size, never lowered, so a launch captured into a CUDA
// graph makes no attribute call
template <int NMAX, int PB, int KT, int KG, bool FULL>
size_t tc_configured = 0;

template <int NMAX, int PB, int KT, int KG, bool FULL>
cudaError_t allow_tc_smem(size_t bytes) {
  if (bytes > tc_configured<NMAX, PB, KT, KG, FULL>) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_tc_kernel<NMAX, PB, KT, KG, FULL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    tc_configured<NMAX, PB, KT, KG, FULL> = bytes;
  }
  return cudaSuccess;
}

template <int NMAX, int PB, int KT, int KG, bool FULL>
size_t tc_bytes(int n) {
  return tc_smem_bytes(FULL ? NMAX : (n + 15) & ~15, PB, KT, KG);
}

template <int NMAX, int PB, int KT, int KG, bool FULL>
cudaError_t tc_info_inst(int n, int* smem, int* ctas_per_sm) {
  const size_t bytes = tc_bytes<NMAX, PB, KT, KG, FULL>(n);
  *smem = (int)bytes;
  cudaError_t err = allow_tc_smem<NMAX, PB, KT, KG, FULL>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, ssd_tc_kernel<NMAX, PB, KT, KG, FULL>,
      TC_WARPS * 32 * KG, bytes);
}

template <int NMAX, int PB, int KT, int KG, bool FULL>
cudaError_t launch_tc_inst(const Args& a, cudaStream_t stream) {
  const size_t bytes = tc_bytes<NMAX, PB, KT, KG, FULL>(a.n);
  cudaError_t err = allow_tc_smem<NMAX, PB, KT, KG, FULL>(bytes);
  if (err != cudaSuccess) return err;
  if ((a.p + PB - 1) / PB > 65535) return cudaErrorInvalidValue;
  // 16-byte cp.async copies: every row and every head's or group's slice
  // starts on 16 bytes
  const int vec = a.p % 8 == 0 && a.n % 8 == 0 && tc::aligned16(a.x) &&
                  tc::aligned16(a.B) && tc::aligned16(a.C) &&
                  a.x_sb % 8 == 0 && a.x_sl % 8 == 0 && a.b_sb % 8 == 0 &&
                  a.b_sl % 8 == 0 && a.c_sb % 8 == 0 && a.c_sl % 8 == 0;
  dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.p + PB - 1) / PB));
  ssd_tc_kernel<NMAX, PB, KT, KG, FULL>
      <<<grid, TC_WARPS * 32 * KG, bytes, stream>>>(a, vec);
  return cudaGetLastError();
}

// The instantiations (here and in ssd_scan_bf16_info): n = 128 exact, n
// below 128 guarded, both with SSD_TILES; n up to 256 guarded with 32
// channels, 64 keys and one key group (SSD_TILES would need 241,664 bytes
// of shared memory there).
cudaError_t launch_tc(const Args& a, void* stream) {
  if (a.b <= 0 || a.h <= 0 || a.p <= 0 || a.l <= 0) return cudaSuccess;
  if (!args_ok(a)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n == 128) return launch_tc_inst<128, SSD_TILES, true>(a, st);
  if (a.n < 128) return launch_tc_inst<128, SSD_TILES, false>(a, st);
  return launch_tc_inst<256, 32, 64, 1, false>(a, st);
}

Args make_args(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, const void* h0, void* y,
               void* state, int b, int l, int h, int p, int g, int n,
               int chunk, long long x_sb, long long x_sl, long long b_sb,
               long long b_sl, long long c_sb, long long c_sl) {
  Args a;
  a.x = x;
  a.dt = (const float*)dt;
  a.A = (const float*)A;
  a.B = B;
  a.C = C;
  a.D = (const float*)D;
  a.h0 = (const float*)h0;
  a.y = y;
  a.state = (float*)state;
  a.b = b; a.l = l; a.h = h; a.p = p; a.g = g; a.n = n; a.chunk = chunk;
  a.x_sb = x_sb; a.x_sl = x_sl; a.b_sb = b_sb; a.b_sl = b_sl;
  a.c_sb = c_sb; a.c_sl = c_sl;
  return a;
}

}  // namespace

extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* B, const void* C, const void* D,
                            const void* h0, void* y, void* state, int b,
                            int l, int h, int p, int g, int n, int chunk,
                            long long x_sb, long long x_sl, long long b_sb,
                            long long b_sl, long long c_sb, long long c_sl,
                            void* stream) {
  return (int)launch_f32(
      make_args(x, dt, A, B, C, D, h0, y, state, b, l, h, p, g, n, chunk,
                x_sb, x_sl, b_sb, b_sl, c_sb, c_sl),
      stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* D,
                             const void* h0, void* y, void* state, int b,
                             int l, int h, int p, int g, int n, int chunk,
                             long long x_sb, long long x_sl, long long b_sb,
                             long long b_sl, long long c_sb, long long c_sl,
                             void* stream) {
  return (int)launch_tc(
      make_args(x, dt, A, B, C, D, h0, y, state, b, l, h, p, g, n, chunk,
                x_sb, x_sl, b_sb, b_sl, c_sb, c_sl),
      stream);
}

// The bf16 kernel's dynamic shared memory (bytes) and resident CTAs per SM
// at state width n (p does not change them)
extern "C" int ssd_scan_bf16_info(int p, int n, int* smem, int* ctas_per_sm) {
  if (p <= 0 || n <= 0 || n > MAX_STATE) return (int)cudaErrorInvalidValue;
  if (n == 128)
    return (int)tc_info_inst<128, SSD_TILES, true>(n, smem, ctas_per_sm);
  if (n < 128)
    return (int)tc_info_inst<128, SSD_TILES, false>(n, smem, ctas_per_sm);
  return (int)tc_info_inst<256, 32, 64, 1, false>(n, smem, ctas_per_sm);
}
