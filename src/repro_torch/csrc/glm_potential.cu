// Fused GLM negative log-likelihood and its gradient in one pass over X.
//
// Replaces the Pallas TPU kernel src/repro/kernels/glm_potential.py:_kernel
// (reached through glm_potential_grad, glm_potential.py:62).  For
// l = X w + offset it computes
//   bernoulli_logit: nll = sum softplus(l) - y l,  grad = X^T (sigmoid(l) - y)
//   normal:          nll = sum 0.5 ((l - y) / s)^2 + log s + 0.5 log 2 pi,
//                    grad = X^T (l - y) / s^2
// accumulating in float.  Value and gradient consume the same residual
// against the same row of X, so one read of X serves both.
//
// Layout: one warp per row at a time.  Lane j holds columns j, j + 32, ...
// of w in registers (CPL columns per lane, d <= 256), forms its part of the
// row's dot product, and a butterfly shuffle gives every lane the same
// logit (each stage adds the same two values in either order, so the lanes
// agree bit for bit).  Each lane then accumulates resid * x for its own
// columns in registers.  Rows are dealt to warps round-robin; each warp
// takes two rows per iteration so that two rows' loads are in flight.
//
// Determinism: the TPU grid runs in order and carries the sum across grid
// steps.  Blocks here run in no order, so each block writes one partial nll
// and one partial gradient row to a scratch buffer (warps folded in warp
// order), and a second small kernel folds the partials with a fixed
// strided-then-tree order.  No float atomics: repeated runs are
// bit-identical.
//
// What bounds it: bytes.  One call must read X (n * d * 4 B), y and the
// offset (n * 4 B each): at n = 581,012 and d = 54 that is about 130 MB, or
// roughly 39 us at 3.35 TB/s.  The operations (4 n d flops) are far below
// the card's float rate.  The TPU wrapper pads d to 128 lanes and n to the
// block; here X is read unpadded and the ragged column and row edges are
// masked in the kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps per block
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM of an H100
constexpr float kHalfLog2Pi = 0.91893853320467274f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int FAMILY>
__device__ __forceinline__ void term_resid(float l, float y, float scale,
                                           float log_s, float& term,
                                           float& resid) {
  if (FAMILY == 0) {  // bernoulli_logit
    term = fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))) - y * l;
    const float e = expf(-fabsf(l));
    const float sig = l >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    resid = sig - y;
  } else {  // normal
    const float zs = (l - y) / scale;
    term = 0.5f * zs * zs + log_s + kHalfLog2Pi;
    resid = (l - y) / (scale * scale);
  }
}

template <int CPL, int FAMILY>
__global__ void __launch_bounds__(kWarps * 32)
glm_partials_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ offset,
                    const float* __restrict__ w, float scale, long long n,
                    int d, float* __restrict__ part_nll,
                    float* __restrict__ part_grad) {
  __shared__ float red_grad[kWarps][CPL * 32];
  __shared__ float red_nll[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float wreg[CPL], acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = lane + 32 * c;
    wreg[c] = col < d ? w[col] : 0.f;
    acc[c] = 0.f;
  }
  const float log_s = FAMILY == 1 ? logf(scale) : 0.f;
  float nll_acc = 0.f;
  const long long total = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < n;
       row += 2 * total) {
    const long long row2 = row + total;
    const bool has2 = row2 < n;
    float xa[CPL], xb[CPL];
    float da = 0.f, db = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int col = lane + 32 * c;
      xa[c] = col < d ? x[row * d + col] : 0.f;
      xb[c] = (has2 && col < d) ? x[row2 * d + col] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      da += xa[c] * wreg[c];
      db += xb[c] * wreg[c];
    }
    da = warp_sum(da);
    db = warp_sum(db);
    float term, resid;
    term_resid<FAMILY>(da + (offset ? offset[row] : 0.f), y[row], scale,
                       log_s, term, resid);
    nll_acc += term;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] += resid * xa[c];
    if (has2) {
      term_resid<FAMILY>(db + (offset ? offset[row2] : 0.f), y[row2], scale,
                         log_s, term, resid);
      nll_acc += term;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[c] += resid * xb[c];
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) red_grad[warp][lane + 32 * c] = acc[c];
  if (lane == 0) red_nll[warp] = nll_acc;
  __syncthreads();
  for (int col = threadIdx.x; col < d; col += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red_grad[k][col];
    part_grad[(long long)blockIdx.x * d + col] = s;
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red_nll[k];
    part_nll[blockIdx.x] = s;
  }
}

// One block per gradient column, plus one (blockIdx.x == d) for the nll.
__global__ void glm_fold_kernel(const float* __restrict__ part_nll,
                                const float* __restrict__ part_grad,
                                int blocks, int d, float* __restrict__ nll,
                                float* __restrict__ grad) {
  __shared__ float buf[256];
  const int col = blockIdx.x;
  float s = 0.f;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x)
    s += col < d ? part_grad[(long long)b * d + col] : part_nll[b];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) buf[threadIdx.x] += buf[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (col < d) grad[col] = buf[0];
    else *nll = buf[0];
  }
}

template <int CPL>
void launch_partials(int family, int blocks, cudaStream_t stream,
                     const float* x, const float* y, const float* offset,
                     const float* w, float scale, long long n, int d,
                     float* part_nll, float* part_grad) {
  if (family == 0)
    glm_partials_kernel<CPL, 0><<<blocks, kWarps * 32, 0, stream>>>(
        x, y, offset, w, scale, n, d, part_nll, part_grad);
  else
    glm_partials_kernel<CPL, 1><<<blocks, kWarps * 32, 0, stream>>>(
        x, y, offset, w, scale, n, d, part_nll, part_grad);
}

}  // namespace

// Number of partial rows the scratch buffers must hold for n rows.
extern "C" int glm_potential_num_blocks(long long n) {
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

// family: 0 = bernoulli_logit, 1 = normal.  offset may be null.
// part_nll holds `blocks` floats, part_grad `blocks * d`; nll one float,
// grad d floats.  Returns the cudaError_t of the launches (0 on success).
extern "C" int glm_potential_grad_f32(const void* x, const void* y,
                                      const void* offset, const void* w,
                                      float scale, int family, long long n,
                                      int d, void* part_nll, void* part_grad,
                                      int blocks, void* nll, void* grad,
                                      void* stream) {
  if (n <= 0 || d <= 0 || d > 256 || (family != 0 && family != 1))
    return (int)cudaErrorInvalidValue;
  if (blocks != glm_potential_num_blocks(n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* of = (const float*)offset;
  const float* wf = (const float*)w;
  float* pn = (float*)part_nll;
  float* pg = (float*)part_grad;
  const int cpl = (d + 31) / 32;
  if (cpl <= 1)
    launch_partials<1>(family, blocks, s, xf, yf, of, wf, scale, n, d, pn, pg);
  else if (cpl <= 2)
    launch_partials<2>(family, blocks, s, xf, yf, of, wf, scale, n, d, pn, pg);
  else if (cpl <= 4)
    launch_partials<4>(family, blocks, s, xf, yf, of, wf, scale, n, d, pn, pg);
  else
    launch_partials<8>(family, blocks, s, xf, yf, of, wf, scale, n, d, pn, pg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glm_fold_kernel<<<d + 1, 256, 0, s>>>(pn, pg, blocks, d, (float*)nll,
                                        (float*)grad);
  return (int)cudaGetLastError();
}
