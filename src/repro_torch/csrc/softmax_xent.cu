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
//
// Replaces the Pallas TPU kernel src/repro/kernels/softmax_xent.py:_kernel
// (reached through _xent_fwd_kernel, softmax_xent.py:57; pallas_call at :64).
// As there, vocab blocks of the unembedding stream through fast memory and
// each token row keeps a running max, sum of exponentials and label logit.
// Unlike the TPU grid, which walks the vocab blocks in order on one core,
// the vocab is cut into splits that run in parallel: a CTA owns a 128-row
// tile of x and one split, walks its 128-wide vocab tiles and writes its
// rows' (max, sumexp, label logit); a second kernel merges the splits of a
// row in split order (no atomics: the same bits on every run) into lse, ce
// and z_loss.  The TPU kernel asserts T % 128 == 0 and V % 512 == 0; here a
// ragged T and V are masked (Qwen3's V = 151,936 is not a multiple of 512).
//
// Layout of a CTA (256 threads as 16 x 16): each vocab tile is a
// 128 x 128 x d product staged through shared memory 16 deep (x and W tiles
// as float32, the next depth slice loaded into registers while the current
// one is multiplied); thread (ty, tx) keeps an 8 x 8 block of logits in
// registers, rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and columns likewise
// with tx, read as float4 from shared memory.  The running max of a row is
// shared by its 16 threads (a shuffle per tile); each keeps its own running
// sum, merged once at the end.
//
// What bounds it: at gemma-2b's training shape (T = 2048 rows per
// microbatch, d = 2048, V = 256,000) the products are 2.15 TFLOP against
// ~1.06 GB of operands: bound by operations (2.2 ms at the bf16 tensor-core
// rate).  This first version multiplies on the CUDA cores in float32 (67
// TFLOP/s at most): tensor cores are for a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 128;  // token rows per CTA
constexpr int BV = 128;  // vocab columns per tile
constexpr int KD = 16;   // depth per shared-memory stage
constexpr int PAD = 4;   // keeps float4 rows 16-byte aligned
constexpr int LOADS = BT * KD / THREADS;  // elements each thread stages
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
  return (int)launch<__nv_bfloat16>(x, w, labels, part, ce, zl, lse, T, d, V,
                                    vd, nsplit, tiles_per_split,
                                    z_loss_weight, stream);
}
