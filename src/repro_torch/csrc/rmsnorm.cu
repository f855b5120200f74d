// RMSNorm forward over the rows of a (rows, d) matrix:
//     out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w
// with float32 statistics and a float32 weight, the result cast to x's type
// (bfloat16 or float32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py:_fwd_kernel
// (reached through _fwd, rmsnorm.py:49).  The TPU kernel tiles 256 rows by
// the full width into VMEM and asserts rows % 256 == 0 above 256 rows; here
// one warp owns one row, so any row count is taken and nothing is padded.
//
// What bounds it: every element is read and its result written once, so
// 2 * rows * d * sizeof(T) bytes plus the weight row, with ~4 float32
// operations per element: bound by bytes at every width the LM uses
// (d = 4096 for the block norms, 128 for Qwen3's per-head q/k norms).  A
// lane reads the elements lane, lane + 32, ... of its warp's row, so a warp's
// loads are contiguous; the second pass re-reads the row (16 KB at
// d = 4096 in bfloat16) from L1/L2 rather than holding it in registers, which
// keeps the kernel independent of d.  Eight rows (warps) per block.
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
