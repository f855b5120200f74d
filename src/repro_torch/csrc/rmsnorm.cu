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
// rows; here one warp owns one row, so any row count is taken and nothing is
// padded.
//
// What bounds it: every element is read and its result written once, so
// 2 * rows * d * sizeof(T) bytes plus the weight row, with ~4 float32
// operations per element: bound by bytes at every width the LM uses
// (d = 4096 for the block norms, 128 for Qwen3's per-head q/k norms).  A
// lane reads the elements lane, lane + 32, ... of its warp's row, so a warp's
// loads are contiguous; the second pass re-reads the row (16 KB at
// d = 4096 in bfloat16) from L1/L2 rather than holding it in registers, which
// keeps the kernel independent of d.  Eight rows (warps) per block.
//
// Backward: replaces src/repro/kernels/rmsnorm.py:_bwd_kernel (reached
// through _bwd, rmsnorm.py:67).  As there, rstd is recomputed from the saved
// x (cheaper than storing it for the large activations this normalizes) and
// dw comes out as per-block float32 partials that are summed afterwards.
// Blocks run in no order on the card, so the partials are summed by a second
// kernel, one thread per column walking the blocks in order: no atomics, the
// same bits on every run.  A block owns 8 rows: each warp first reduces one
// row's sum(x^2) and sum(g * w * x); then the block's threads walk the
// columns (adjacent threads on adjacent columns: coalesced) and, for each,
// the 8 rows, writing dx and summing the column's dw partial.  Bound by
// bytes: x and g read, dx written, plus rows / 8 float32 partial rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       T* __restrict__ out, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f(xr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>((to_f(xr[i]) * r) * w[i]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, long long rows,
                   int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_fwd_kernel<T><<<(unsigned)blocks, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (T*)out, rows, d, eps);
  return cudaGetLastError();
}


// rows [row0, row0 + WARPS) of one block: each warp reduces one row
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ dw_part, long long rows, int d,
                       float eps) {
  __shared__ float rstd_s[WARPS];
  __shared__ float c_s[WARPS];  // rstd * mean(g * w * xhat)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = (long long)blockIdx.x * WARPS;
  const long long row = row0 + warp;
  if (row < rows) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float ss = 0.f, sgwx = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float xv = to_f(xr[i]);
      ss = fmaf(xv, xv, ss);
      sgwx = fmaf(to_f(gr[i]) * w[i], xv, sgwx);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgwx += __shfl_xor_sync(0xffffffffu, sgwx, off);
    }
    const float r = rsqrtf(ss / (float)d + eps);
    if (lane == 0) {
      rstd_s[warp] = r;
      // mean(g * w * xhat) = r * sum(g * w * x) / d, times r for dx
      c_s[warp] = r * (r * sgwx / (float)d);
    }
  }
  __syncthreads();
  const int nrows = (int)min((long long)WARPS, rows - row0);
  for (int col = threadIdx.x; col < d; col += WARPS * 32) {
    const float wc = w[col];
    float acc = 0.f;
    for (int i = 0; i < nrows; ++i) {
      const long long off = (row0 + i) * d + col;
      const float r = rstd_s[i];
      const float xv = to_f(x[off]);
      const float gv = to_f(g[off]);
      const float xhat = xv * r;
      dx[off] = from_f<T>(r * (gv * wc) - xhat * c_s[i]);
      acc = fmaf(gv, xhat, acc);
    }
    dw_part[(long long)blockIdx.x * d + col] = acc;
  }
}

// dw[col] = sum over the blocks' partials, in block order
__global__ void rmsnorm_dw_sum_kernel(const float* __restrict__ dw_part,
                                      float* __restrict__ dw, int nblocks,
                                      int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) s += dw_part[(long long)b * d + col];
  dw[col] = s;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* g, void* dx,
                       void* dw_part, void* dw, long long rows, int d,
                       float eps, void* stream) {
  if (d <= 0) return cudaSuccess;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    rmsnorm_bwd_kernel<T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        (const T*)x, (const float*)w, (const T*)g, (T*)dx, (float*)dw_part,
        rows, d, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  rmsnorm_dw_sum_kernel<<<(unsigned)((d + 255) / 256), 256, 0, s>>>(
      (const float*)dw_part, (float*)dw, (int)blocks, d);
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

// dw_part holds ceil(rows / 8) * d floats of scratch
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
