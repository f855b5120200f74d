// Mamba-2 SSD (state-space duality) chunked scan, forward.  For one batch
// row and one head, over chunks of c positions taken in order, with
// cum = cumsum(dt * A) inside the chunk:
//     y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) (C_i . state^T) + D x_i
//     s'   = exp(cum_end) s + sum_j dt_j exp(cum_end - cum_j) x_j^T B_j
// x (b, l, h, p), B and C (b, l, g, n) in float32 or bfloat16 (head hh reads
// group hh / (h / g)), dt (b, l, h), A (h,), D (h,) and the entering state
// h0 (b, h, p, n) in float32; y (b, l, h, p) in x's type, the final state
// (b, h, p, n) in float32.  All arithmetic is float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:_kernel
// (reached through _ssd_fwd, ssd_scan.py:64).  There the grid's chunk axis
// runs in order on one core and the (p, n) state waits in VMEM between grid
// steps, after the wrapper has materialized B and C repeated over the heads
// and every operand transposed to (b*h, chunks, c, .) in HBM.  Here:
//   - B and C are read in place by group index, and x, B, C through their
//     batch and row strides (slices of the in-projection are not copied);
//   - blocks run in parallel in no order, so one CTA owns one (batch, head,
//     32 of its p channels) and walks the chunks in a loop; its 32 x n
//     float32 state rows stay in shared memory across the chunks.  The p
//     split doubles the CTAs at p = 64 (256 for mamba2-370m at b = 4, two
//     per SM) at the cost of each CTA forming the C B^T scores itself;
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
// the float32 rate.  This first version runs on the CUDA cores in float32
// from shared memory: 4 x 4 score micro-tiles per thread, 8 outputs per
// thread for y; wgmma tiles and sharing C B^T across a group's heads are
// later speed work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PB = 32;         // state rows (head channels) per CTA
constexpr int TI = 64;         // query rows per tile
constexpr int TJ = 64;         // key rows per tile
constexpr int MAX_CHUNK = 256;
constexpr int MAX_STATE = 256;

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

template <typename T>
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
  const T* X = (const T*)a.x + bb * a.x_sb + (long long)hh * a.p + p0;
  const T* Bg = (const T*)a.B + bb * a.b_sb + (long long)gg * n;
  const T* Cg = (const T*)a.C + bb * a.c_sb + (long long)gg * n;
  const long long y_sl = (long long)a.h * a.p;
  T* Y = (T*)a.y + (long long)bb * a.l * y_sl + (long long)hh * a.p + p0;
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
            (i0 + r < c) ? to_f(Cg[(t0 + i0 + r) * a.c_sl + k]) : 0.f;
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
              (j0 + r < c) ? to_f(Bg[(t0 + j0 + r) * a.b_sl + k]) : 0.f;
        }
        for (int e = tid; e < TJ * PB; e += THREADS) {
          const int r = e / PB, q = e % PB;
          xj[e] = (j0 + r < c && q < pw)
                      ? to_f(X[(t0 + j0 + r) * a.x_sl + q]) : 0.f;
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
            if (a.D) v = fmaf(Dh, to_f(X[(t0 + i) * a.x_sl + pc]), v);
            Y[(t0 + i) * y_sl + pc] = from_f<T>(v);
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
            (j0 + r < c) ? to_f(Bg[(t0 + j0 + r) * a.b_sl + k]) : 0.f;
      }
      for (int e = tid; e < TJ * PB; e += THREADS) {
        const int r = e / PB, q = e % PB, j = j0 + r;
        xj[e] = (j < c && q < pw)
                    ? to_f(X[(t0 + j) * a.x_sl + q]) *
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

template <typename T>
cudaError_t launch(const Args& a, void* stream) {
  if (a.b <= 0 || a.h <= 0 || a.p <= 0) return cudaSuccess;
  if (a.g <= 0 || a.h % a.g != 0 || a.n <= 0 || a.n > MAX_STATE ||
      a.chunk <= 0 || a.chunk > MAX_CHUNK || a.l % a.chunk != 0 ||
      (long long)a.b * a.h > 0x7fffffffLL || (a.p + PB - 1) / PB > 65535)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(a.n);
  // Raise the kernel's dynamic shared-memory limit once per size, so a
  // launch captured into a CUDA graph makes no attribute call.
  static size_t configured = 0;
  if (bytes > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    configured = bytes;
  }
  dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.p + PB - 1) / PB));
  ssd_scan_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
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
  return (int)launch<float>(
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
  return (int)launch<__nv_bfloat16>(
      make_args(x, dt, A, B, C, D, h0, y, state, b, l, h, p, g, n, chunk,
                x_sb, x_sl, b_sb, b_sl, c_sb, c_sl),
      stream);
}
