// Flash attention forward (online softmax), causal or not, grouped-query:
//     o[b, s, h, :]  = softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :]) v[b, t, h / G, :]
//     lse[b, h, s]   = log sum_t exp(scale * q . k)
// with q (B, S, H, dq), k (B, S, KH, dq), v (B, S, KH, dv), G = H / KH, and
// causal masking t <= s.  o comes back in q's type (bfloat16 or float32),
// lse in float32 (what a backward pass needs).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _fwd_kernel (reached through _flash_fwd_impl, flash_attention.py:79).  As
// there: running max m, sum l and accumulator acc in float32, masked scores
// set to NEG_INF = -1e30, l clamped to 1e-30, lse = m + log l.  Unlike the
// TPU grid, which walks the k-tiles in order on one core with the running
// state in VMEM scratch, each CTA here owns one (b, h, 64-row q-tile) and
// walks the k-tiles in a loop, so the running state stays in registers; the
// k-tiles wholly above the diagonal are skipped when causal.  A ragged S
// (not a multiple of the tile) is masked here rather than asserted away.
//
// Layout of a CTA (256 threads, 16 row groups x 16 column lanes): thread
// (g, c) owns query rows 4g..4g+3 of the tile, the score columns c, c+16,
// c+32, c+48 of each k-tile, and the output columns c, c+16, ... of its rows
// (dv <= 256).  Shared memory holds, in float32: the q-tile [64][dq+1], the
// k-tile transposed [dq][65], the v-tile [64][dv] and the probabilities
// [64][65] (padded strides keep the banks apart), 116 KB at dq = dv = 128.
//
// What bounds it: at Qwen3-8B's prefill (B = 4, S = 512, H = 32, KH = 8,
// 128/128) the function moves ~42 MB and needs ~8.6 GFLOP of products,
// bound by bytes (12.5 us at 3.35 TB/s; 8.7 us for the products at the
// bf16 tensor-core rate).  This first version multiplies on the CUDA cores
// in float32 (tensor cores are for a later PR), so it is bound by the FMA
// issue rate and shared-memory loads, one CTA per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per k-tile
constexpr int THREADS = 256;
constexpr int ROWS = 4;      // query rows per thread
constexpr int COLS = 4;      // score columns per thread and k-tile
constexpr int MAXC = 16;     // output columns per thread: dv <= 16 * MAXC
constexpr float NEG_INF = -1e30f;

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
  return (int)launch<__nv_bfloat16>(q, k, v, o, lse, B, S, H, KH, dq, dv,
                                    scale, causal, stream);
}
