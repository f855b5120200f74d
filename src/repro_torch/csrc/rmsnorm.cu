// RMSNorm forward and backward over the rows of a (rows, d) matrix:
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w
//     dx[r, :]  = rstd * (g * w) - xhat * rstd * mean(g * w * xhat)
//     dw        = sum_r g[r, :] * xhat[r, :]        (xhat = x * rstd)
// with float32 statistics and a float32 weight; out and dx in x's type
// (bfloat16 or float32), dw in float32.
//
// Forward: replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:
// _fwd_kernel (reached through _fwd, rmsnorm.py:49).  The TPU kernel tiles
// 256 rows by the full width into VMEM and asserts rows % 256 == 0 above 256
// rows; here a team of threads owns a row, so any row count is taken and
// nothing is padded.
//
// What bounds it: every element is read and its result written once, so
// 2 * rows * d * sizeof(T) bytes plus the weight row, with ~3 float32
// operations per element: bound by bytes at every width the LM uses
// (d = 4096 for the block norms, 1024 for mamba2's, 128 for Qwen3's
// per-head q/k norms).
//   - A team of TPR threads (a power of two, 4 to 256) owns a row; thread
//     i of a team loads the 16-byte vectors i, i + TPR, ... (at most
//     FWD_NV = 4) and holds them in registers between the sum of squares
//     and the write, so the row is read once.  TPR is the smallest that
//     covers the row: 128 at d = 4096 in bf16 (two teams a block), 4 at
//     d = 128 (eight rows a warp).  Rows wider than 256 FWD_NV vectors take
//     a second kernel that reads the row again (from L2) for the write.
//   - A team has FWD_RB rows in flight (their loads issued together; one,
//     as measured fastest: more rows a team cost registers and blocks per
//     SM); its weight vectors (float4s) are loaded once, after the row's.
//   - Scalar loads where d is not a multiple of the vector or a pointer is
//     not 16-byte aligned.
//
// Backward: replaces src/repro/kernels/rmsnorm.py:_bwd_kernel (reached
// through _bwd, rmsnorm.py:67).  As there, rstd is recomputed from the saved
// x (cheaper than storing it for the large activations this normalizes) and
// dw comes out as per-block float32 partials that are summed afterwards, in
// a fixed order: no atomics, the same bits on every run.  Bound by bytes: x
// and g read, dx written (25 MB at gemma-2b's (2048, 2048) bf16).
//   - A team of TPR threads (a power of two, 32 to 256) owns a row; thread
//     i of a team holds the 16-byte vectors i, i + TPR, ... (at most NV) of
//     x and g in registers between the row's reduction and its dx write, so
//     each row is read once, and its float32 dw for those columns.  TPR is
//     the smallest that covers the row: 64 at d = 2048 in bf16, 4 teams a
//     block.  Rows wider than 256 NV vectors (d > 8192 in bf16, 4096 in
//     float32, 1024 with scalar loads) take a second kernel that reads the
//     row again (from L2) for dx, its dw partial row in global memory.
//   - A team has RB rows in flight (their loads issued together).  Scalar
//     loads where d is not a multiple of the vector or a pointer is not
//     16-byte aligned.
//   - Partition: min(BWD_BLOCKS, rows / teams) blocks walking the rows in a
//     fixed stride, a function of rows and d (and the vector width), not of
//     the card: 128 dw partial rows at gemma's shape (1 MB).  A block's
//     teams are summed in shared memory in team order.
//   - The partials are summed by a second kernel: a block of 8 warps per 32
//     columns, warp w walking partials w, w + 8, ..., the 8 warp sums added
//     in warp order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// ---------------------------------------------------------------------------
// vector loads and stores shared by the forward and the backward
// ---------------------------------------------------------------------------

constexpr int BWD_THREADS = 256;
constexpr int BWD_BLOCKS = 128;  // the most dw partial rows (kernels/rmsnorm.py)
constexpr int NV = 4;            // 16-byte vectors of a row a thread holds
constexpr int RB = 2;            // rows a team has in flight

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// V elements of T as loaded: one 16-byte load, or one element
template <typename T, int V>
struct Vec {
  uint4 u;
};
template <typename T>
struct Vec<T, 1> {
  T u;
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_v(const T* p) {
  Vec<T, V> r;
  if constexpr (V == 1)
    r.u = *p;
  else
    r.u = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zero_v() {
  Vec<T, V> r;
  if constexpr (V == 1)
    r.u = from_f<T>(0.f);
  else
    r.u = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

__device__ __forceinline__ float2 bf2(unsigned int w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ unsigned int pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

template <int V>
__device__ __forceinline__ void unpack(const Vec<float, V>& r,
                                       float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = r.u;
  } else {
    f[0] = __uint_as_float(r.u.x);
    f[1] = __uint_as_float(r.u.y);
    f[2] = __uint_as_float(r.u.z);
    f[3] = __uint_as_float(r.u.w);
  }
}

template <int V>
__device__ __forceinline__ void unpack(const Vec<__nv_bfloat16, V>& r,
                                       float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __bfloat162float(r.u);
  } else {
    const unsigned int w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = bf2(w[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&f)[V]) {
  if constexpr (V == 1)
    *p = f[0];
  else
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p,
                                        const float (&f)[V]) {
  if constexpr (V == 1)
    *p = __float2bfloat16_rn(f[0]);
  else
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]),
                   pack_bf2(f[4], f[5]), pack_bf2(f[6], f[7]));
}

// V float32 weights (16-byte loads when V is a multiple of 4)
template <int V>
__device__ __forceinline__ void load_w(const float* p, float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(p + i);
      f[i] = v4.x;
      f[i + 1] = v4.y;
      f[i + 2] = v4.z;
      f[i + 3] = v4.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// The 16-byte vectors of a row a thread holds and the rows a team has in
// flight (FWD_NV, FWD_RB); chosen on the card (PERF.md §6): 4, 1 (80
// registers at bf16) beat 4, 2 (123), 4, 4, 8, 2 and 2, 4 at every timed
// shape.
#ifndef RMS_FWD_TILES
#define RMS_FWD_TILES 4, 1
#endif
constexpr int FWD_THREADS = 256;
constexpr int FWD_NV_RB[2] = {RMS_FWD_TILES};
constexpr int FWD_NV = FWD_NV_RB[0];
constexpr int FWD_RB = FWD_NV_RB[1];

// Teams of tpr threads (a power of two, 4 to 256), each owning FWD_RB rows
// (first, first + stride, ...): thread i of a team loads the vectors i,
// i + tpr, ... of each, holds them between the sum of squares and the
// write, and multiplies by its weight vectors, loaded once.  A team
// narrower than a warp reduces by shuffles inside its lanes; a wider one
// adds its warps' sums in shared memory in warp order.
template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, long long rows, int d, float eps,
                       int tpr) {
  __shared__ float red[FWD_THREADS / 32][FWD_RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int teams = FWD_THREADS / tpr;
  const int team = tid / tpr, ti = tid - team * tpr;
  const int nvec = d / V;
  const long long stride = (long long)gridDim.x * teams;
  const long long first = (long long)blockIdx.x * teams + team;

  Vec<T, V> xr[FWD_RB][FWD_NV];
#pragma unroll
  for (int rb = 0; rb < FWD_RB; ++rb) {
    const long long row = first + rb * stride;
#pragma unroll
    for (int i = 0; i < FWD_NV; ++i) {
      const int j = ti + i * tpr;
      xr[rb][i] = (row < rows && j < nvec) ? load_v<T, V>(x + row * d + j * V)
                                           : zero_v<T, V>();
    }
  }
  float wv[FWD_NV][V];
#pragma unroll
  for (int i = 0; i < FWD_NV; ++i) {
    const int j = ti + i * tpr;
    if (j < nvec) load_w<V>(w + j * V, wv[i]);
  }
  float ss[FWD_RB];
#pragma unroll
  for (int rb = 0; rb < FWD_RB; ++rb) {
    ss[rb] = 0.f;
#pragma unroll
    for (int i = 0; i < FWD_NV; ++i) {
      float xv[V];
      unpack(xr[rb][i], xv);
#pragma unroll
      for (int e = 0; e < V; ++e) ss[rb] = fmaf(xv[e], xv[e], ss[rb]);
    }
    // the team's lanes (all of the warp's lanes take part)
    for (int off = min(tpr, 32) >> 1; off > 0; off >>= 1)
      ss[rb] += __shfl_xor_sync(0xffffffffu, ss[rb], off);
  }
  if (tpr > 32) {  // the team's warps, in order
    if (lane == 0)
#pragma unroll
      for (int rb = 0; rb < FWD_RB; ++rb) red[warp][rb] = ss[rb];
    __syncthreads();
    const int wpt = tpr / 32;
#pragma unroll
    for (int rb = 0; rb < FWD_RB; ++rb) {
      ss[rb] = 0.f;
      for (int u = team * wpt; u < (team + 1) * wpt; ++u) ss[rb] += red[u][rb];
    }
  }
#pragma unroll
  for (int rb = 0; rb < FWD_RB; ++rb) {
    const long long row = first + rb * stride;
    if (row >= rows) continue;
    const float r = rsqrtf(ss[rb] / (float)d + eps);
#pragma unroll
    for (int i = 0; i < FWD_NV; ++i) {
      const int j = ti + i * tpr;
      if (j < nvec) {
        float xv[V], o[V];
        unpack(xr[rb][i], xv);
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = (xv[e] * r) * wv[i][e];
        store_v<V>(out + row * d + j * V, o);
      }
    }
  }
}

// Rows wider than the registers hold (d > 8192 in bf16, 4096 in float32,
// 1024 with scalar loads): one block a row, reading it twice (the sum of
// squares, then the write, the second read from L2).
template <typename T, int V>
__global__ void __launch_bounds__(FWD_THREADS)
    rmsnorm_fwd_wide_kernel(const T* __restrict__ x,
                            const float* __restrict__ w, T* __restrict__ out,
                            long long rows, int d, float eps) {
  __shared__ float red[FWD_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = d / V;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int j = tid; j < nvec; j += FWD_THREADS) {
    float xv[V];
    unpack(load_v<T, V>(xr + j * V), xv);
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(xv[e], xv[e], ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = 0.f;
  for (int u = 0; u < FWD_THREADS / 32; ++u) ss += red[u];
  const float r = rsqrtf(ss / (float)d + eps);
  for (int j = tid; j < nvec; j += FWD_THREADS) {
    float xv[V], wv[V], o[V];
    unpack(load_v<T, V>(xr + j * V), xv);
    load_w<V>(w + j * V, wv);
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = (xv[e] * r) * wv[e];
    store_v<V>(out + row * d + j * V, o);
  }
}

template <typename T, int V>
cudaError_t launch_fwd_v(const void* x, const void* w, void* out,
                         long long rows, int d, float eps, cudaStream_t s) {
  const int nvec = d / V;
  int tpr = 4;
  while (tpr < FWD_THREADS && tpr * FWD_NV < nvec) tpr *= 2;
  if (tpr * FWD_NV >= nvec) {
    const int teams = FWD_THREADS / tpr;
    const long long blocks =
        (rows + (long long)teams * FWD_RB - 1) / ((long long)teams * FWD_RB);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_fwd_kernel<T, V><<<(unsigned)blocks, FWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (T*)out, rows, d, eps, tpr);
  } else {
    if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    rmsnorm_fwd_wide_kernel<T, V><<<(unsigned)rows, FWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (T*)out, rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, long long rows,
                   int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(out);
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch_fwd_v<T, V>(x, w, out, rows, d, eps, s)
             : launch_fwd_v<T, 1>(x, w, out, rows, d, eps, s);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Teams of tpr threads, each owning a row at a time (rows first + k * stride
// for the team's k-th row), the row's vectors in registers; RB rows a
// chunk.  dw_part gets the block's partial row; shared memory holds the
// teams' partials (teams * d floats) when there is more than one team.
template <typename T, int V>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ dw_part, long long rows, int d,
                       float eps, int tpr) {
  extern __shared__ float team_dw[];  // [teams][d]
  __shared__ float red[2][BWD_THREADS / 32][2 * RB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int teams = BWD_THREADS / tpr;
  const int team = tid / tpr, ti = tid - team * tpr;
  const int wpt = tpr / 32;  // warps per team
  const int nvec = d / V;
  const long long stride = (long long)gridDim.x * teams;
  const long long first = (long long)blockIdx.x * teams + team;

  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = ti + i * tpr;
#pragma unroll
    for (int e = 0; e < V; ++e) wv[i][e] = acc[i][e] = 0.f;
    if (j < nvec) load_w<V>(w + j * V, wv[i]);
  }

  int par = 0;
  for (long long k0 = 0; (long long)blockIdx.x * teams + k0 * stride < rows;
       k0 += RB) {
    Vec<T, V> xr[RB][NV], gr[RB][NV];
    float ss[RB], sg[RB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const long long row = first + (k0 + rb) * stride;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = ti + i * tpr;
        if (row < rows && j < nvec) {
          xr[rb][i] = load_v<T, V>(x + row * d + j * V);
          gr[rb][i] = load_v<T, V>(g + row * d + j * V);
        } else {
          xr[rb][i] = gr[rb][i] = zero_v<T, V>();
        }
      }
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      ss[rb] = sg[rb] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float xv[V], gv[V];
        unpack(xr[rb][i], xv);
        unpack(gr[rb][i], gv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss[rb] = fmaf(xv[e], xv[e], ss[rb]);
          sg[rb] = fmaf(gv[e] * wv[i][e], xv[e], sg[rb]);
        }
      }
      ss[rb] = warp_sum(ss[rb]);
      sg[rb] = warp_sum(sg[rb]);
    }
    if (wpt > 1) {  // the team's warps, in order
      if (lane == 0)
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          red[par][warp][2 * rb] = ss[rb];
          red[par][warp][2 * rb + 1] = sg[rb];
        }
      __syncthreads();
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        ss[rb] = sg[rb] = 0.f;
        for (int u = team * wpt; u < (team + 1) * wpt; ++u) {
          ss[rb] += red[par][u][2 * rb];
          sg[rb] += red[par][u][2 * rb + 1];
        }
      }
      par ^= 1;  // the next chunk writes the other half: no second barrier
    }
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const long long row = first + (k0 + rb) * stride;
      if (row >= rows) continue;
      const float r = rsqrtf(ss[rb] / (float)d + eps);
      // mean(g * w * xhat) = r * sum(g * w * x) / d, times r for dx
      const float c = r * (r * sg[rb] / (float)d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = ti + i * tpr;
        if (j < nvec) {
          float xv[V], gv[V], out[V];
          unpack(xr[rb][i], xv);
          unpack(gr[rb][i], gv);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xhat = xv[e] * r;
            out[e] = r * (gv[e] * wv[i][e]) - xhat * c;
            acc[i][e] = fmaf(gv[e], xhat, acc[i][e]);
          }
          store_v<V>(dx + row * d + j * V, out);
        }
      }
    }
  }

  float* part = dw_part + (long long)blockIdx.x * d;
  float* dst = teams > 1 ? team_dw + team * d : part;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = ti + i * tpr;
    if (j < nvec)
#pragma unroll
      for (int e = 0; e < V; ++e) dst[j * V + e] = acc[i][e];
  }
  if (teams > 1) {
    __syncthreads();
    for (int col = tid; col < d; col += BWD_THREADS) {
      float sum = 0.f;
      for (int u = 0; u < teams; ++u) sum += team_dw[u * d + col];
      part[col] = sum;
    }
  }
}

// Rows wider than the registers hold: one block (one team) a row at a
// time, reading it twice (the reduction, then dx and dw); the block's dw
// partial row accumulates in dw_part, each column by its own thread.
template <typename T, int V>
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_bwd_wide_kernel(const T* __restrict__ x,
                            const float* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ dw_part, long long rows,
                            int d, float eps) {
  __shared__ float red[2][BWD_THREADS / 32][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = d / V;
  float* part = dw_part + (long long)blockIdx.x * d;
  for (int j = tid; j < nvec; j += BWD_THREADS)
#pragma unroll
    for (int e = 0; e < V; ++e) part[j * V + e] = 0.f;
  int par = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float ss = 0.f, sg = 0.f;
    for (int j = tid; j < nvec; j += BWD_THREADS) {
      float xv[V], gv[V], wv[V];
      unpack(load_v<T, V>(xr + j * V), xv);
      unpack(load_v<T, V>(gr + j * V), gv);
      load_w<V>(w + j * V, wv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xv[e], xv[e], ss);
        sg = fmaf(gv[e] * wv[e], xv[e], sg);
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if (lane == 0) {
      red[par][warp][0] = ss;
      red[par][warp][1] = sg;
    }
    __syncthreads();
    ss = sg = 0.f;
    for (int u = 0; u < BWD_THREADS / 32; ++u) {
      ss += red[par][u][0];
      sg += red[par][u][1];
    }
    par ^= 1;
    const float r = rsqrtf(ss / (float)d + eps);
    const float c = r * (r * sg / (float)d);
    for (int j = tid; j < nvec; j += BWD_THREADS) {
      float xv[V], gv[V], wv[V], out[V];
      unpack(load_v<T, V>(xr + j * V), xv);
      unpack(load_v<T, V>(gr + j * V), gv);
      load_w<V>(w + j * V, wv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float xhat = xv[e] * r;
        out[e] = r * (gv[e] * wv[e]) - xhat * c;
        part[j * V + e] = fmaf(gv[e], xhat, part[j * V + e]);
      }
      store_v<V>(dx + row * d + j * V, out);
    }
  }
}

// dw[col] = sum of the nparts partial rows in order: 8 warps per 32
// columns, warp u summing partials u, u + 8, ...; then the 8 warp sums in
// warp order
__global__ void __launch_bounds__(BWD_THREADS)
    rmsnorm_dw_sum_kernel(const float* __restrict__ dw_part,
                          float* __restrict__ dw, int nparts, int d) {
  __shared__ float sums[BWD_THREADS / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4
    for (int p = warp; p < nparts; p += BWD_THREADS / 32)
      s += dw_part[(long long)p * d + col];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < BWD_THREADS / 32; ++u) t += sums[u][lane];
    dw[col] = t;
  }
}

template <typename T, int V>
cudaError_t launch_bwd_v(const void* x, const void* w, const void* g,
                         void* dx, void* dw_part, long long rows, int d,
                         float eps, cudaStream_t s, int* nparts) {
  const int nvec = d / V;
  int tpr = 32;
  while (tpr < BWD_THREADS && tpr * NV < nvec) tpr *= 2;
  if (tpr * NV >= nvec) {
    const int teams = BWD_THREADS / tpr;
    *nparts = (int)min((long long)BWD_BLOCKS, (rows + teams - 1) / teams);
    const size_t smem = teams > 1 ? sizeof(float) * teams * d : 0;
    rmsnorm_bwd_kernel<T, V><<<*nparts, BWD_THREADS, smem, s>>>(
        (const T*)x, (const float*)w, (const T*)g, (T*)dx, (float*)dw_part,
        rows, d, eps, tpr);
  } else {
    *nparts = (int)min((long long)BWD_BLOCKS, rows);
    rmsnorm_bwd_wide_kernel<T, V><<<*nparts, BWD_THREADS, 0, s>>>(
        (const T*)x, (const float*)w, (const T*)g, (T*)dx, (float*)dw_part,
        rows, d, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* dw_part, void* dw, long long rows, int d,
                       float eps, void* stream) {
  if (d <= 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(g) && aligned16(dx);
  int nparts = 0;
  if (rows > 0) {
    cudaError_t err =
        vec ? launch_bwd_v<T, V>(x, w, g, dx, dw_part, rows, d, eps, s,
                                 &nparts)
            : launch_bwd_v<T, 1>(x, w, g, dx, dw_part, rows, d, eps, s,
                                 &nparts);
    if (err != cudaSuccess) return err;
  }
  rmsnorm_dw_sum_kernel<<<(unsigned)((d + 31) / 32), BWD_THREADS, 0, s>>>(
      (const float*)dw_part, (float*)dw, nparts, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_fwd_f32(const void* x, const void* w, void* out,
                               long long rows, int d, float eps,
                               void* stream) {
  return (int)launch<float>(x, w, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_fwd_bf16(const void* x, const void* w, void* out,
                                long long rows, int d, float eps,
                                void* stream) {
  return (int)launch<__nv_bfloat16>(x, w, out, rows, d, eps, stream);
}

// dw_part holds min(rows, 128) * d floats of scratch (BWD_BLOCKS)
extern "C" int rmsnorm_bwd_f32(const void* x, const void* w, const void* g,
                               void* dx, void* dw_part, void* dw,
                               long long rows, int d, float eps,
                               void* stream) {
  return (int)launch_bwd<float>(x, w, g, dx, dw_part, dw, rows, d, eps,
                                stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* w, const void* g,
                                void* dx, void* dw_part, void* dw,
                                long long rows, int d, float eps,
                                void* stream) {
  return (int)launch_bwd<__nv_bfloat16>(x, w, g, dx, dw_part, dw, rows, d,
                                        eps, stream);
}
