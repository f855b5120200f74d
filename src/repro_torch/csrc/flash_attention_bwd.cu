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
// Layout (256 threads, 16 row groups x 16 column lanes, as in the forward
// kernel csrc/flash_attention.cu): thread (g, c) owns 4 rows of its tile and
// the columns c, c + 16 of the 32-wide tile it walks, and the output columns
// c, c + 16, ... (head dims up to 256) of its 4 rows.  Every operand is
// staged in shared memory as float32 with odd strides (dim + 1, 33), so a
// half-warp reading one column of a row-major tile, or one row of a
// transposed one, touches 16 banks.  At dq = dv = 256 a CTA holds 207 KB:
// its 64-row tile of two operands and the 32-wide tile of two others, each
// transposed, plus the 64 x 32 probabilities; one CTA per SM.
//
// What bounds it: at gemma-2b's training shapes (B = 2, S = 1024, H = 8,
// KH = 1, 256/256, causal) the dq pass needs 3 and the dkv pass 4 products of
// (S^2 / 2) x 256 per head, ~12.9 and ~17.2 GFLOP, against ~21 MB of
// operands: bound by operations (13 and 17 us at the bf16 tensor-core rate).
// This first version multiplies on the CUDA cores in float32 (tensor cores
// are for a later PR), so it is bound by the FMA rate and shared-memory
// loads, one CTA per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* delta, void* dq, int B, int S, int H, int KH,
                      int dqd, int dvd, float scale, int causal,
                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (bad_shape(B, H, KH, dqd, dvd)) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * S * H;
  const int warps = THREADS / 32;
  delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, st>>>(
      (const T*)o, (const T*)dout, (float*)delta, rows, S, H, dvd);
  cudaError_t err = cudaGetLastError();
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
  const int G = H / KH;
  const long long nk = (long long)B * S * KH * dqd;
  const long long nv = (long long)B * S * KH * dvd;
  group_sum_kernel<T><<<(unsigned)((nk + 255) / 256), 256, 0, st>>>(
      (const float*)dk_h, (T*)dk, nk, G, dqd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_sum_kernel<T><<<(unsigned)((nv + 255) / 256), 256, 0, st>>>(
      (const float*)dv_h, (T*)dv, nv, G, dvd);
  return cudaGetLastError();
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
  return (int)launch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, B,
                                       S, H, KH, dqd, dvd, scale, causal,
                                       stream);
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
  return (int)launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk_h, dv_h,
                                        dk, dv, B, S, H, KH, dqd, dvd, scale,
                                        causal, stream);
}
