// Fused GLM negative log-likelihood and its gradient for C weight vectors
// (the chains of an ensemble) in one pass over X.
//
// Replaces the Pallas TPU kernel src/repro/kernels/glm_potential.py:_kernel
// (reached through glm_potential_grad, glm_potential.py:62) and, for C > 1,
// jax.vmap of it over w (the JAX package's chain_vmap(jax.value_and_grad(
// potential)), src/repro/core/infer/mala.py:125, ensemble.py:222).  For
// each chain c, l = X w_c + offset:
//   bernoulli_logit: nll_c = sum softplus(l) - y l,  grad_c = X^T (sigmoid(l) - y)
//   normal:          nll_c = sum 0.5 ((l - y) / s)^2 + log s + 0.5 log 2 pi,
//                    grad_c = X^T (l - y) / s^2
// accumulating in float32 (FFMA only: no tensor cores, no TF32, so X is
// used exactly).
//
// What bounds it: one call must read X (n * d * 4 B), y and the offset
// (n * 4 B each): at n = 581,012 and d = 54 about 130 MB, ~39 us at
// 3.35 TB/s, whatever C is.  The operations, n (4 d + 12) C, reach the same
// time near C = 16 at 67 TFLOP/s.  So X is read once for all C chains, and
// the per-row work is done once per (row, chain), not once per lane:
//
// - Work split: persistent CTAs of 256 threads, at most 264 (two per SM of
//   an H100), each walking a contiguous range of row tiles in order.  A
//   tile is R rows (R a multiple of 4, at most 128, R d <= 6912 floats).
//   Grid, tile size and tile-to-CTA map depend on n and d only, never on C,
//   and every chain's sums run in an order fixed by (n, d): chain c of a
//   C-chain launch is bit-identical to a 1-chain launch on w_c.
// - Staging: a tile is one contiguous span of R d floats (plus R of y and of
//   the offset), copied into a 3-stage shared ring by 16-byte cp.async (R is
//   a multiple of 4, so every tile start is 16-byte aligned when the
//   operands are); the ragged tail of the last tile, and operands that are
//   not 16-byte aligned, take 4-byte cp.async.  Two tiles are in flight
//   while one is reduced.
// - Logits, terms, residuals: threads 2r and 2r + 1 own row r of the tile.
//   They form its CB logits from shared memory over the row's even and odd
//   steps (W held transposed (d, CB) in shared memory, so one 16-byte load
//   serves four chains) and sum the halves, even + odd, through one
//   shuffle; then the pair computes the row's CB terms and residuals, each
//   once.  A row's steps start at column 0, or at (2 r) mod d where d is a
//   multiple of 4 (where rows would share banks): at d = 54 a warp's 16
//   rows x 2 steps read 32 banks.  The split, not the number of chains,
//   fixes every logit's order of summation.
// - Gradient: thread items are (column, row slice) pairs, column d standing
//   for the nll (x = 1, the term in place of the residual); each item
//   accumulates resid x over its slice's rows, in row order, for all CB
//   chains in registers across tiles.  S = 4, 2 or 1 slices (by d) keep the
//   threads busy at C = 1; the slices are summed in order at the end.
// - Fold: per-CTA partials, then fixed-order folds by the last arrival
//   (an integer ticket after __threadfence, no float atomics): the last CTA
//   of each group of 16 folds its group's partials in CTA order, and the
//   last of those folds the groups in order into nll and grad.  One launch
//   a call; repeated calls are bit-identical.
// - Chains: up to 16 per CTA (CB = 1, 2, 4, 8 or 16, the chains past C
//   padded with w = 0 and dropped); more chains split over gridDim.y, each
//   group of 16 reading X again.
// - Data shards (glm_potential_partials_f32; replaces the loop of
//   src/repro/kernels/glm_potential.py:106 glm_potential_partials over
//   S equal row shards, one pallas_call each): gridDim.z = S, and the CTAs
//   of shard z walk only its m = n / S rows, x[z m : (z + 1) m], with the
//   grid, tile map, copy path (16-byte cp.async where the shard's rows are
//   16-byte aligned, else 4-byte) and fold order of a separate launch on
//   those rows.  Each (z, chain group) block folds into its own partials
//   and ticket region, so every shard's partials of every chain come from
//   one launch, each bit-identical to a single-shard launch on its rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_mma.cuh"  // cp.async helpers

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kChainsPerCta = 16;
constexpr int kMaxChains = 256;  // the wrapper's limit: 16 chain groups
constexpr int kChainGroups = kMaxChains / kChainsPerCta;
constexpr int kMaxShards = 65535;  // gridDim.z
constexpr int kMaxCtas = 264;    // 2 per SM of an H100
constexpr int kGroup = 16;       // CTAs per first-level fold
constexpr int kMaxGroups = (kMaxCtas + kGroup - 1) / kGroup;  // 17
constexpr int kTileFloats = 6912;  // X floats of a tile at most (27 KB)
constexpr float kHalfLog2Pi = 0.91893853320467274f;

// Everything here depends on n and d only.
struct Shape {
  int rows;         // R: rows of a tile, a multiple of 4
  int slices;       // S: row slices of the gradient's sums
  long long tiles;  // ceil(n / R)
  int ctas;         // G
  int groups;       // ceil(G / kGroup)
};

__host__ __device__ inline Shape shape_for(long long n, int d) {
  Shape s;
  int r = kTileFloats / d;
  r = r > 128 ? 128 : r;
  r &= ~3;
  s.rows = r < 4 ? 4 : r;
  s.slices = d < 64 ? 4 : (d < 128 ? 2 : 1);
  s.tiles = (n + s.rows - 1) / s.rows;
  s.ctas = (int)(s.tiles < kMaxCtas ? s.tiles : kMaxCtas);
  s.groups = (s.ctas + kGroup - 1) / kGroup;
  return s;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared floats: the ring (reused for the slices' partials at the end),
// W transposed, the residuals and the terms.
__host__ __device__ inline int ring_floats(const Shape& s, int d, int cb) {
  const int ring = kStages * (s.rows * d + 2 * s.rows);
  const int red = s.slices * cb * (d + 1);
  return round4(ring > red ? ring : red);
}

__host__ __device__ inline int smem_floats(const Shape& s, int d, int cb) {
  return ring_floats(s, d, cb) + round4(d * cb) + 2 * s.rows * cb;
}

template <int CB>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CB / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (CB == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int CB>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[CB]) {
  if constexpr (CB % 4 == 0) {
#pragma unroll
    for (int q = 0; q < CB / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (CB == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The (row, chain) term of the nll and its residual, every operation an
// explicitly rounded one so that no instantiation contracts it differently.
__device__ __forceinline__ void term_resid(int family, float l, float y,
                                           float scale, float scale2,
                                           float log_s, float& term,
                                           float& resid) {
  if (family == 0) {  // bernoulli_logit
    const float e = expf(-fabsf(l));
    term = __fsub_rn(__fadd_rn(fmaxf(l, 0.f), log1pf(e)), __fmul_rn(y, l));
    const float den = __fadd_rn(1.f, e);
    const float sig = l >= 0.f ? __fdiv_rn(1.f, den) : __fdiv_rn(e, den);
    resid = __fsub_rn(sig, y);
  } else {  // normal
    const float dl = __fsub_rn(l, y);
    const float zs = __fdiv_rn(dl, scale);
    term = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, zs), zs), log_s),
                     kHalfLog2Pi);
    resid = __fdiv_rn(dl, scale2);
  }
}

// count floats from global src into shared dst (dst 16-byte aligned)
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          int count, bool vec) {
  if (vec) {
    const int full = count >> 2;
    for (int i = threadIdx.x; i < full; i += kThreads)
      tc::cp_async16(dst + 4 * i, src + 4 * i, true);
    const int tail = count & 3;
    if ((int)threadIdx.x < tail)
      tc::cp_async4(dst + 4 * full + threadIdx.x, src + 4 * full + threadIdx.x,
                    true);
  } else {
    for (int i = threadIdx.x; i < count; i += kThreads)
      tc::cp_async4(dst + i, src + i, true);
  }
}

// dst[i] = src[i] + src[stride + i] + ... over `rows` rows (<= MAXR) in
// order, for i < items; src written by other CTAs, so read through L2.
template <int MAXR>
__device__ __forceinline__ void fold_rows(const float* src, int rows,
                                          int items, int stride,
                                          float* dst) {
  for (int i = threadIdx.x; i < items; i += kThreads) {
    float v[MAXR];
#pragma unroll
    for (int q = 0; q < MAXR; ++q)
      v[q] = q < rows ? __ldcg(src + (long long)q * stride + i) : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < MAXR; ++q)
      if (q < rows) s = __fadd_rn(s, v[q]);
    dst[i] = s;
  }
}

// gridDim = (G, ceil(C / CB), S); CB chains per CTA, J gradient items a
// thread, n rows a shard (S shards of n rows each in x, y and offset).
// part: S * gridDim.y * G rows of CB * (d + 1) floats; part2: S * gridDim.y
// * kMaxGroups rows of the same; tickets: S * kChainGroups * (kMaxGroups +
// 1) ints, zero at launch and left zero.  nll (C, S), grad (C, S, d).
template <int CB, int J>
__global__ void __launch_bounds__(kThreads, 2)
glm_chains_kernel(const float* __restrict__ x_all,
                  const float* __restrict__ y_all,
                  const float* __restrict__ offset_all,
                  const float* __restrict__ w, float scale, int family,
                  long long n, int d, int chains,
                  float* __restrict__ part, float* __restrict__ part2,
                  int* __restrict__ tickets, float* __restrict__ nll,
                  float* __restrict__ grad) {
  extern __shared__ __align__(16) float smem[];
  // this CTA's shard: its rows, and the copy path a launch on them takes
  const int shards = gridDim.z, z = blockIdx.z;
  const float* x = x_all + (long long)z * n * d;
  const float* y = y_all + (long long)z * n;
  const float* offset =
      offset_all != nullptr ? offset_all + (long long)z * n : nullptr;
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0) &&
                   ((uintptr_t)offset % 16 == 0);
  const long long zy = (long long)z * gridDim.y + blockIdx.y;
  const Shape sh = shape_for(n, d);
  const int R = sh.rows, S = sh.slices, cols = d + 1;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * CB;
  const int cg = chains - c0 < CB ? chains - c0 : CB;
  const int stage_floats = R * d + 2 * R;
  float* ring = smem;
  float* wt = smem + ring_floats(sh, d, CB);
  float* rs = wt + round4(d * CB);
  float* ts = rs + R * CB;

  // this group's W, transposed to (d, CB), zero past its chains
  for (int i = tid; i < d * CB; i += kThreads) {
    const int k = i / CB, c = i - k * CB;
    wt[i] = c < cg ? w[(long long)(c0 + c) * d + k] : 0.f;
  }

  const long long t0 = sh.tiles * blockIdx.x / sh.ctas;
  const int ntiles = (int)(sh.tiles * (blockIdx.x + 1) / sh.ctas - t0);
  auto issue = [&](int it) {  // start copying tile t0 + it into its stage
    if (it < ntiles) {
      const long long row0 = (t0 + it) * R;
      const int nv = (int)(n - row0 < R ? n - row0 : R);
      float* st = ring + (it % kStages) * stage_floats;
      copy_span(st, x + row0 * d, nv * d, vec);
      copy_span(st + R * d, y + row0, nv, vec);
      if (offset != nullptr) copy_span(st + R * d + R, offset + row0, nv, vec);
    }
    tc::cp_async_commit();  // empty groups keep the count uniform
  };

  const float log_s = family == 1 ? logf(scale) : 0.f;
  const float scale2 = __fmul_rn(scale, scale);
  const bool rotate = (d & 3) == 0;
  float acc[J][CB];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[j][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < ntiles; ++it) {
    issue(it + kStages - 1);
    tc::cp_async_wait<kStages - 1>();  // tile it has landed (this thread's)
    __syncthreads();                   // ... and every thread's
    const float* st = ring + (it % kStages) * stage_floats;
    const long long row0 = (t0 + it) * R;
    const int nv = (int)(n - row0 < R ? n - row0 : R);

    // 1. threads 2r and 2r + 1: row r's CB logits, over the row's even and
    //    odd steps, summed (even + odd) through one shuffle; then its CB
    //    terms and residuals, each once, the pair taking chains 2i and
    //    2i + 1
    {
      const int r = tid >> 1, p = tid & 1;
      const bool live = r < nv;
      const float* xr = st + (live ? r : 0) * d;  // a row past nv: dropped
      const int rot = rotate ? (2 * r) % d : 0;
      float l[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) l[c] = 0.f;
#pragma unroll 4
      for (int j = p; j < d; j += 2) {
        const int k = j + rot < d ? j + rot : j + rot - d;
        const float xv = xr[k];
        float wv[CB];
        load_vec<CB>(wt + k * CB, wv);
#pragma unroll
        for (int c = 0; c < CB; ++c) l[c] = __fmaf_rn(xv, wv[c], l[c]);
      }
#pragma unroll
      for (int c = 0; c < CB; ++c)  // even + odd on both lanes alike
        l[c] = __fadd_rn(l[c], __shfl_xor_sync(0xffffffffu, l[c], 1));
      const float yv = st[R * d + (live ? r : 0)];
      const float ov = offset != nullptr ? st[R * d + R + (live ? r : 0)]
                                         : 0.f;
#pragma unroll
      for (int i = 0; i < (CB + 1) / 2; ++i) {
        const int c = 2 * i + p;
        const float lc = p == 0 || CB == 1 ? l[2 * i] : l[(2 * i + 1) % CB];
        float tv, rv;
        term_resid(family, offset != nullptr ? __fadd_rn(lc, ov) : lc, yv,
                   scale, scale2, log_s, tv, rv);
        if (live && c < CB) {
          rs[r * CB + c] = rv;
          ts[r * CB + c] = tv;
        }
      }
    }
    __syncthreads();

    // 2. items (column, slice): resid x over the slice's rows, in order
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int item = tid + j * kThreads;
      if (item < cols * S) {
        const int s = item / cols, col = item - s * cols;
        const int r0 = s * (R / S);
        const int r1 = r0 + R / S < nv ? r0 + R / S : nv;
        const bool is_nll = col == d;
        const float* src = is_nll ? ts : rs;
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
          const float xv = is_nll ? 1.f : st[r * d + col];
          float v[CB];
          load_vec<CB>(src + r * CB, v);
#pragma unroll
          for (int c = 0; c < CB; ++c)
            acc[j][c] = __fmaf_rn(v[c], xv, acc[j][c]);
        }
      }
    }
    __syncthreads();  // the stage and rs/ts are free again
  }

  // the slices' partials through the (now idle) ring, summed in slice order
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = ring;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int item = tid + j * kThreads;
    if (item < cols * S) {
      const int s = item / cols, col = item - s * cols;
#pragma unroll
      for (int c = 0; c < CB; ++c) red[(s * CB + c) * cols + col] = acc[j][c];
    }
  }
  __syncthreads();
  const int items = cg * cols, stride = CB * cols;
  float* mine = part + (zy * sh.ctas + blockIdx.x) * stride;
  for (int i = tid; i < items; i += kThreads) {
    const int c = i / cols, col = i - c * cols;
    float v = red[c * cols + col];
    for (int s = 1; s < S; ++s) v = __fadd_rn(v, red[(s * CB + c) * cols + col]);
    mine[i] = v;
  }

  // first-level fold: the last CTA of each group of kGroup
  __shared__ int last;
  int* tk = tickets +
            ((long long)z * kChainGroups + blockIdx.y) * (kMaxGroups + 1);
  const int g1 = blockIdx.x / kGroup;
  const int in_group =
      sh.ctas - g1 * kGroup < kGroup ? sh.ctas - g1 * kGroup : kGroup;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(tk + g1, 1);
    last = t == in_group - 1;
    if (last) tk[g1] = 0;  // every CTA of the group has counted
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_rows<kGroup>(part + (zy * sh.ctas + g1 * kGroup) * stride, in_group,
                    items, stride, part2 + (zy * kMaxGroups + g1) * stride);

  // second-level fold: the last group's folder writes nll and grad
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = atomicAdd(tk + kMaxGroups, 1);
    last = t == sh.groups - 1;
    if (last) tk[kMaxGroups] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* top = part2 + zy * kMaxGroups * stride;
  for (int i = tid; i < items; i += kThreads) {
    float v[kMaxGroups];
#pragma unroll
    for (int q = 0; q < kMaxGroups; ++q)
      v[q] = q < sh.groups ? __ldcg(top + (long long)q * stride + i) : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxGroups; ++q)
      if (q < sh.groups) s = __fadd_rn(s, v[q]);
    const int c = i / cols, col = i - c * cols;
    const long long cz = (long long)(c0 + c) * shards + z;
    if (col == d)
      nll[cz] = s;
    else
      grad[cz * d + col] = s;
  }
}

int chains_per_cta(int chains) {
  return chains <= 1 ? 1 : chains <= 2 ? 2 : chains <= 4 ? 4
         : chains <= 8 ? 8 : kChainsPerCta;
}

template <int CB, int J>
cudaError_t launch(const Shape& sh, int d, int chains, int shards,
                   cudaStream_t st, const float* x, const float* y,
                   const float* off, const float* w, float scale, int family,
                   long long n, float* part, float* part2, int* tickets,
                   float* nll, float* grad) {
  static int allowed = 0;  // the dynamic shared-memory limit set so far
  const int bytes = 4 * smem_floats(sh, d, CB);
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        glm_chains_kernel<CB, J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  const dim3 grid(sh.ctas, (chains + CB - 1) / CB, shards);
  glm_chains_kernel<CB, J><<<grid, kThreads, bytes, st>>>(
      x, y, off, w, scale, family, n, d, chains, part, part2, tickets, nll,
      grad);
  return cudaGetLastError();
}

template <int CB>
cudaError_t launch_cb(const Shape& sh, int d, int chains, int shards,
                      cudaStream_t st, const float* x, const float* y,
                      const float* off, const float* w, float scale,
                      int family, long long n, float* part, float* part2,
                      int* tickets, float* nll, float* grad) {
  if ((d + 1) * sh.slices <= kThreads)
    return launch<CB, 1>(sh, d, chains, shards, st, x, y, off, w, scale,
                         family, n, part, part2, tickets, nll, grad);
  return launch<CB, 2>(sh, d, chains, shards, st, x, y, off, w, scale, family,
                       n, part, part2, tickets, nll, grad);
}

}  // namespace

extern "C" int glm_potential_max_chains() { return kMaxChains; }

// Floats of the two partial buffers for a call on n rows; tickets holds
// glm_potential_ticket_ints() ints, zeroed once (the kernel leaves it zero).
extern "C" long long glm_potential_part_floats(long long n, int d,
                                               int chains) {
  const int cb = chains_per_cta(chains);
  const long long groups_y = (chains + cb - 1) / cb;
  return groups_y * shape_for(n, d).ctas * cb * (d + 1);
}

extern "C" long long glm_potential_part2_floats(int d, int chains) {
  const int cb = chains_per_cta(chains);
  const long long groups_y = (chains + cb - 1) / cb;
  return groups_y * kMaxGroups * cb * (d + 1);
}

extern "C" int glm_potential_ticket_ints() {
  return kChainGroups * (kMaxGroups + 1);
}

// The same for S shards of m rows: S times the buffers of one shard.
extern "C" long long glm_potential_partials_part_floats(long long m, int d,
                                                        int chains,
                                                        int shards) {
  return (long long)shards * glm_potential_part_floats(m, d, chains);
}

extern "C" long long glm_potential_partials_part2_floats(int d, int chains,
                                                         int shards) {
  return (long long)shards * glm_potential_part2_floats(d, chains);
}

extern "C" long long glm_potential_partials_ticket_ints(int shards) {
  return (long long)shards * glm_potential_ticket_ints();
}

// x (shards * m, d), y (shards * m,), offset (shards * m,) or null, w
// (chains, d), all float32; family 0 = bernoulli_logit, 1 = normal.  nll
// (chains, shards), grad (chains, shards, d): shard z's partials of chain
// c, from x's rows z m to (z + 1) m.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int glm_potential_partials_f32(const void* x, const void* y,
                                          const void* offset, const void* w,
                                          float scale, int family,
                                          long long m, int d, int chains,
                                          int shards, void* part, void* part2,
                                          void* tickets, void* nll,
                                          void* grad, void* stream) {
  if (m <= 0 || d <= 0 || d > 256 || chains < 1 || chains > kMaxChains ||
      shards < 1 || shards > kMaxShards || (family != 0 && family != 1))
    return (int)cudaErrorInvalidValue;
  const Shape sh = shape_for(m, d);
  cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* of = (const float*)offset;
  const float* wf = (const float*)w;
  float* pa = (float*)part;
  float* pb = (float*)part2;
  int* tk = (int*)tickets;
  float* nl = (float*)nll;
  float* gr = (float*)grad;
  switch (chains_per_cta(chains)) {
    case 1:
      return (int)launch_cb<1>(sh, d, chains, shards, st, xf, yf, of, wf,
                               scale, family, m, pa, pb, tk, nl, gr);
    case 2:
      return (int)launch_cb<2>(sh, d, chains, shards, st, xf, yf, of, wf,
                               scale, family, m, pa, pb, tk, nl, gr);
    case 4:
      return (int)launch_cb<4>(sh, d, chains, shards, st, xf, yf, of, wf,
                               scale, family, m, pa, pb, tk, nl, gr);
    case 8:
      return (int)launch_cb<8>(sh, d, chains, shards, st, xf, yf, of, wf,
                               scale, family, m, pa, pb, tk, nl, gr);
    default:
      return (int)launch_cb<16>(sh, d, chains, shards, st, xf, yf, of, wf,
                                scale, family, m, pa, pb, tk, nl, gr);
  }
}

// x (n, d), y (n,), offset (n,) or null, w (chains, d), all float32; family
// 0 = bernoulli_logit, 1 = normal.  nll (chains,), grad (chains, d): the
// one-shard launch.  Returns the cudaError_t of the launch (0 on success).
extern "C" int glm_potential_grad_f32(const void* x, const void* y,
                                      const void* offset, const void* w,
                                      float scale, int family, long long n,
                                      int d, int chains, void* part,
                                      void* part2, void* tickets, void* nll,
                                      void* grad, void* stream) {
  return glm_potential_partials_f32(x, y, offset, w, scale, family, n, d,
                                    chains, 1, part, part2, tickets, nll,
                                    grad, stream);
}
