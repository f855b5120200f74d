// Fused leapfrog half-step for HMC/NUTS with a diagonal mass matrix.
//
// Replaces the Pallas TPU kernel src/repro/kernels/leapfrog.py:_kernel
// (reached through leapfrog_halfstep, leapfrog.py:40).  One pass computes
//     r' = r - (eps / 2) * g
//     z' = z + eps * (r' * m_inv)
// over flat (D,) vectors, in float or double (the TPU kernel computes in
// promote(dtype, f32), so f32 chains stay f32 and f64 chains stay f64).
//
// eps is read from a device scalar: NUTS negates it when growing the tree
// leftwards and dual averaging rescales it every warmup step, and passing
// it as a host value would cost a device->host read per launch.
//
// What bounds it: at the main path's D = 54 the kernel moves 6 * 54 * 4 B,
// so its time is launch latency, not bytes or operations.  At D ~ 1e6 it is
// bound by bytes (four reads and two writes per element), which the
// grid-stride loop streams with neighbouring threads on neighbouring
// addresses.  The TPU wrapper pads D to the block; here the tail is simply
// masked by the loop bound.  Fusing this step into the tree's own kernel
// (or a CUDA graph) to remove the launch is later work.
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void leapfrog_halfstep_kernel(const T* __restrict__ eps_ptr,
                                         const T* __restrict__ z,
                                         const T* __restrict__ r,
                                         const T* __restrict__ g,
                                         const T* __restrict__ m_inv,
                                         T* __restrict__ z_out,
                                         T* __restrict__ r_out,
                                         long long n) {
  const T eps = *eps_ptr;
  const T half_eps = T(0.5) * eps;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T r_new = r[i] - half_eps * g[i];
    r_out[i] = r_new;
    z_out[i] = z[i] + eps * (r_new * m_inv[i]);
  }
}

template <typename T>
cudaError_t launch(const void* eps, const void* z, const void* r,
                   const void* g, const void* m_inv, void* z_out, void* r_out,
                   long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  leapfrog_halfstep_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)eps, (const T*)z, (const T*)r, (const T*)g, (const T*)m_inv,
      (T*)z_out, (T*)r_out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int leapfrog_halfstep_f32(const void* eps, const void* z,
                                     const void* r, const void* g,
                                     const void* m_inv, void* z_out,
                                     void* r_out, long long n, void* stream) {
  return (int)launch<float>(eps, z, r, g, m_inv, z_out, r_out, n, stream);
}

extern "C" int leapfrog_halfstep_f64(const void* eps, const void* z,
                                     const void* r, const void* g,
                                     const void* m_inv, void* z_out,
                                     void* r_out, long long n, void* stream) {
  return (int)launch<double>(eps, z, r, g, m_inv, z_out, r_out, n, stream);
}
