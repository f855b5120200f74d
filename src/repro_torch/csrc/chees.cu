// The close of a ChEES transition in one launch (chees_accept_f32/f64).
//
// Replaces no TPU kernel: in the JAX package this is plain jnp inside the
// compiled transition, src/repro/core/infer/ensemble.py:339-361 (the
// energies, the accept test, the selection, the running mean) and its
// adapt_update's harmonic mean, chees_gradient (ensemble.py:225) and pooled
// Welford fold.  In the port it ran as ~20-90 eager ops a transition after
// the trajectory, which now replays from CUDA graphs (csrc/leapfrog_batch.cu).
// After the trajectory's last potential, one launch computes, with every
// formula in the order of the plain version (kernels/leapfrog.py,
// chees_accept_ref):
//     r1 = r - (0.5 * eps) * g1                       the closing half-kick
//     ke0 = 0.5 * sum(r0 * (m_inv * r0)), r0 = n / sqrt(m_inv)
//     ke1 = 0.5 * sum(r1 * (m_inv * r1))
//     energy_cur = pe0 + ke0, energy_new = pe1 + ke1
//     delta = energy_new - energy_cur (+inf where energy_new is NaN)
//     accept_prob = min(exp(-delta), 1) (NaN stays NaN, as torch.clamp)
//     diverging = delta > max_delta, accept = u < accept_prob
//     z, grad, pe, energy selected per chain
// after warmup the running mean accept probability (n_post > 0, a host
// int); in warmup, packed into stats[2] for the host's one read:
//     stats[0] = 1 / mean(1 / max(accept_prob, 1e-10))   (harmonic mean)
//     stats[1] = the ChEES gradient of chees_gradient: weights = accept_prob
//       (0 where diverging), keep = weights > 0 applied before any
//       arithmetic, the weighted column means over chains, the centred
//       per-chain sums h * (|z1c|^2 - |z0c|^2) * (z1c . v1), v1 = m_inv * r1,
//       the weighted cross-chain sum over the weight sum, 0 if not finite
// and in a middle-window iteration the pooled Welford fold of the selected
// z into the running (mean, m2), with welford_combine's count ratios as
// host numbers (written to fresh buffers, so an earlier state keeps its
// accumulator).
//
// Rounding: every elementwise operation is rounded on its own (__fmul_rn,
// __fdiv_rn, ...) in the plain version's order, the cross-chain sums
// follow chain_sum's pairwise fold exactly (halves added, an odd last row
// carried), and a division by a host number is a multiply by its
// reciprocal, as PyTorch does it on the card.  So the selections, the
// running mean, the harmonic mean and the Welford state are bit-identical
// to the plain version for the same accept_prob.  The five sums over D
// (ke0, ke1 and the three centred sums) are taken in double, each term
// first rounded in T, in a fixed order: a fixed warp-shuffle tree, then a
// CTA's warps and tiles in order, then the CTAs in order (sums[C, 5] holds
// them, rounded to T, for the checks).
//
// Design.  The work has dependencies across the whole ensemble: ke1 needs a
// sum over D, the test needs ke1, the column means need every chain's
// weight, the centred sums need the column means, the gradient needs every
// chain's sums.  A cooperative grid of persistent CTAs walks tiles of W
// columns.  Phase A: a warp takes a chain, its lanes this CTA's columns of
// it, and forms the chain's two kinetic-energy partials (the chains run in
// parallel, each lane's loads independent, so at (8, 54) the pass costs
// about one load's latency).  A grid barrier joins them; every CTA then
// folds the CTAs' partials in the same order and forms the per-chain
// scalars itself (CTA 0 writes them), so one barrier suffices.  Phase B,
// in warmup only: a thread takes a column with all C rows of it (the
// column's chain fold in its slot of shared memory) for the Welford fold
// and the gradient's column means, kept in a (2, D) scratch that only this
// CTA reads back.  Phase C: a warp a chain again, for the selection and
// the centred partials; a second barrier (only when the gradient is
// wanted) lets CTA 0 finish the gradient.
//
// What bounds it: at the main path's (8, 54) one CTA of 256 threads does
// everything and the cost is the launch, the barrier and the dependent
// loads of two or three passes (latency).  At (64, 1e6) it is bytes: n, r,
// g1, z0, z1, g0 read and z, g written once each (warmup with the gradient
// rereads z0, z1, r and g1 and writes and reads the column means), at most
// a co-resident grid.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float exp_(float a) { return expf(a); }
__device__ __forceinline__ double exp_(double a) { return exp(a); }
__device__ __forceinline__ float pos_inf(float) {
  return __int_as_float(0x7f800000);
}
__device__ __forceinline__ double pos_inf(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}

constexpr int kStats = 1;  // warmup: the harmonic mean into stats[0]
constexpr int kGrad = 2;   // and the ChEES gradient into stats[1]
constexpr int kFold = 4;   // a middle-window iteration: the Welford fold
constexpr int kMaxChains = 256;
constexpr int kThreads = 256;
constexpr size_t kFoldBytes = 24576;  // the per-column chain folds
constexpr int kSums = 5;              // ke0, ke1, |z1c|^2, |z0c|^2, z1c.v1

template <typename T>
struct Params {
  const T *z0, *pe0, *g0, *n, *m_inv, *z1, *r, *pe1, *g1, *eps, *u,
      *mean_in, *wf_mean, *wf_m2;
  T *z_out, *pe_out, *g_out, *energy_out, *accept_prob, *mean_out, *stats,
      *wf_mean_out, *wf_m2_out, *sums;
  T* colmean;  // [2][D]: the gradient's weighted column means of z0, z1
  bool* diverging;
  double* part;  // [ctas][kSums][C]
  T max_delta, h, r_mean, r_m2, inv_n_post;
  long long n_post, cols;
  int rows, flags, tile;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // lane 0 holds the warp's sum
}

// chain_sum's fold of x[0..m) held in shared memory with stride `stride`:
// add the halves, carry an odd last row, until one is left.
template <typename T>
__device__ T fold_rows(T* x, int m, int stride) {
  while (m > 1) {
    const int h = m / 2;
    for (int i = 0; i < h; ++i)
      x[i * stride] = add_rn(x[i * stride], x[(h + i) * stride]);
    if (m & 1) x[h * stride] = x[2 * h * stride];
    m = h + (m & 1);
  }
  return x[0];
}

// chain_sum over the C values val(0..C) of one column: its first level
// computed from val, the rest in this thread's slot buf[0, W, 2W, ...].
template <typename T, typename F>
__device__ T fold_chains(T* buf, int W, int C, F val) {
  if (C == 1) return val(0);
  const int h = C / 2;
  for (int i = 0; i < h; ++i) buf[i * W] = add_rn(val(i), val(h + i));
  if (C & 1) buf[h * W] = val(2 * h);
  return fold_rows(buf, h + (C & 1), W);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chees_accept_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_wsum;
  const int C = p.rows;
  const long long D = p.cols;
  const int W = p.tile;  // columns a tile; the column folds' threads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = kThreads / 32;
  const int G = gridDim.x;
  T* w_s = reinterpret_cast<T*>(smem_raw);  // [C] weights
  T* ap_s = w_s + C;                         // [C] accept_prob
  T* tmp = ap_s + C;                         // [C] a chain fold
  T* fold = tmp + C;                         // [(C + 1) / 2][W]
  int* acc_s = reinterpret_cast<int*>(fold + ((C + 1) / 2) * W);  // [C]
  const bool want_grad = (p.flags & kGrad) != 0;
  const bool want_fold = (p.flags & kFold) != 0;
  const T eps = *p.eps;
  const T half_eps = mul_rn(T(0.5), eps);  // exact
  const long long tiles = (D + W - 1) / W;
  double* part = p.part + (long long)blockIdx.x * kSums * C;

  // ---- phase A: a warp a chain, its lanes over this CTA's columns (in a
  // fixed order), the chain's kinetic energies partial over the CTA
  for (int c = warp; c < C; c += warps) {
    double t0 = 0.0, t1 = 0.0;
    for (long long tile = blockIdx.x; tile < tiles; tile += G) {
      const long long end = (tile + 1) * W < D ? (tile + 1) * W : D;
      for (long long col = tile * W + lane; col < end; col += 32) {
        const long long i = (long long)c * D + col;
        const T mi = p.m_inv[col];
        const T r0 = div_rn(p.n[i], sqrt_rn(mi));
        t0 += (double)mul_rn(r0, mul_rn(mi, r0));
        const T r1 = sub_rn(p.r[i], mul_rn(half_eps, p.g1[i]));
        t1 += (double)mul_rn(r1, mul_rn(mi, r1));
      }
    }
    t0 = warp_sum(t0);
    t1 = warp_sum(t1);
    if (lane == 0) {
      part[c] = t0;
      part[C + c] = t1;
    }
  }
  cg::this_grid().sync();

  // ---- every CTA: the per-chain scalars, from the CTAs' partials in order
  for (int c = tid; c < C; c += kThreads) {
    double s0 = 0.0, s1 = 0.0;
    for (int g = 0; g < G; ++g) {
      s0 += __ldcg(p.part + (long long)g * kSums * C + c);
      s1 += __ldcg(p.part + (long long)g * kSums * C + C + c);
    }
    const T ke0 = mul_rn(T(0.5), (T)s0), ke1 = mul_rn(T(0.5), (T)s1);
    const T e_cur = add_rn(p.pe0[c], ke0);
    const T e_new = add_rn(p.pe1[c], ke1);
    const T delta = isnan(e_new) ? pos_inf(T(0)) : sub_rn(e_new, e_cur);
    T ap = exp_(-delta);
    if (ap > T(1)) ap = T(1);  // torch.clamp(max=1): NaN stays NaN
    const bool div = delta > p.max_delta;
    const bool accept = p.u[c] < ap;
    ap_s[c] = ap;
    w_s[c] = div ? T(0) : ap;
    acc_s[c] = accept;
    if (blockIdx.x == 0) {
      p.accept_prob[c] = ap;
      p.diverging[c] = div;
      p.pe_out[c] = accept ? p.pe1[c] : p.pe0[c];
      p.energy_out[c] = accept ? e_new : e_cur;
      p.sums[c * kSums] = ke0;
      p.sums[c * kSums + 1] = ke1;
      if (!want_grad)
        for (int k = 2; k < kSums; ++k) p.sums[c * kSums + k] = T(0);
      if (p.n_post > 0) {
        const T m = p.mean_in[c];
        p.mean_out[c] = add_rn(m, mul_rn(sub_rn(ap, m), p.inv_n_post));
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < C; ++c) tmp[c] = w_s[c];
    T ws = fold_rows(tmp, C, 1);
    if (ws < T(1e-10)) ws = T(1e-10);  // torch.clamp(min=1e-10)
    s_wsum = ws;
    if (blockIdx.x == 0 && (p.flags & kStats)) {
      for (int c = 0; c < C; ++c) {
        T a = ap_s[c];
        if (a < T(1e-10)) a = T(1e-10);
        tmp[c] = div_rn(T(1), a);
      }
      const T mean = mul_rn(fold_rows(tmp, C, 1), div_rn(T(1), (T)C));
      p.stats[0] = div_rn(T(1), mean);
      if (!want_grad) p.stats[1] = T(0);
    }
  }
  __syncthreads();
  const T w_sum = s_wsum;

  // ---- phase B: a thread a column, all C rows of it: the Welford fold
  // and the gradient's weighted column means (colmean[0:D] and [D:2D], read
  // back below by this CTA alone)
  if (want_fold || want_grad) {
    const T inv_c = div_rn(T(1), (T)C);
    T* buf = fold + tid;
    for (long long tile = blockIdx.x; tile < tiles && tid < W; tile += G) {
      const long long col = tile * W + tid;
      if (col >= D) break;
      if (want_fold) {
        auto z_next = [&](int c) {
          const long long i = (long long)c * D + col;
          return acc_s[c] ? p.z1[i] : p.z0[i];
        };
        const T mean_b = mul_rn(fold_chains(buf, W, C, z_next), inv_c);
        const T m2_b = fold_chains(buf, W, C, [&](int c) {
          const T d = sub_rn(z_next(c), mean_b);
          return mul_rn(d, d);
        });
        const T am = p.wf_mean[col], a2 = p.wf_m2[col];
        const T dl = sub_rn(mean_b, am);
        p.wf_mean_out[col] = add_rn(am, mul_rn(dl, p.r_mean));
        p.wf_m2_out[col] =
            add_rn(add_rn(a2, m2_b), mul_rn(mul_rn(dl, dl), p.r_m2));
      }
      if (want_grad) {
        p.colmean[col] = div_rn(fold_chains(buf, W, C, [&](int c) {
                                  return mul_rn(
                                      w_s[c], p.z0[(long long)c * D + col]);
                                }),
                                w_sum);
        p.colmean[D + col] = div_rn(fold_chains(buf, W, C, [&](int c) {
                                      const T z1 =
                                          w_s[c] > T(0)
                                              ? p.z1[(long long)c * D + col]
                                              : T(0);
                                      return mul_rn(w_s[c], z1);
                                    }),
                                    w_sum);
      }
    }
    __syncthreads();
  }

  // ---- phase C: a warp a chain again: the selection, and the centred
  // sums partial over the CTA
  for (int c = warp; c < C; c += warps) {
    const bool accept = acc_s[c] != 0;
    const bool keep = w_s[c] > T(0);  // a dropped chain's z1c and v1 are 0
    double a = 0.0, b = 0.0, v = 0.0;
    for (long long tile = blockIdx.x; tile < tiles; tile += G) {
      const long long end = (tile + 1) * W < D ? (tile + 1) * W : D;
      for (long long col = tile * W + lane; col < end; col += 32) {
        const long long i = (long long)c * D + col;
        const T z0 = p.z0[i], z1 = p.z1[i];
        p.z_out[i] = accept ? z1 : z0;
        p.g_out[i] = accept ? p.g1[i] : p.g0[i];
        if (!want_grad) continue;
        const T z0c = sub_rn(z0, p.colmean[col]);
        b += (double)mul_rn(z0c, z0c);
        if (keep) {
          const T z1c = sub_rn(z1, p.colmean[D + col]);
          const T r1 = sub_rn(p.r[i], mul_rn(half_eps, p.g1[i]));
          const T v1 = mul_rn(p.m_inv[col], r1);
          a += (double)mul_rn(z1c, z1c);
          v += (double)mul_rn(z1c, v1);
        }
      }
    }
    if (!want_grad) continue;
    a = warp_sum(a);
    b = warp_sum(b);
    v = warp_sum(v);
    if (lane == 0) {
      part[2 * C + c] = a;
      part[3 * C + c] = b;
      part[4 * C + c] = v;
    }
  }
  if (!want_grad) return;
  cg::this_grid().sync();

  // ---- CTA 0: the gradient from every chain's centred sums
  if (blockIdx.x != 0) return;
  for (int c = tid; c < C; c += kThreads) {
    double s[3] = {0.0, 0.0, 0.0};
    for (int g = 0; g < G; ++g)
      for (int k = 0; k < 3; ++k)
        s[k] += __ldcg(p.part + (long long)g * kSums * C + (2 + k) * C + c);
    const T s1 = (T)s[0], s0 = (T)s[1], s2 = (T)s[2];
    const T per_chain = mul_rn(mul_rn(p.h, sub_rn(s1, s0)), s2);
    tmp[c] = mul_rn(w_s[c], per_chain);
    p.sums[c * kSums + 2] = s1;
    p.sums[c * kSums + 3] = s0;
    p.sums[c * kSums + 4] = s2;
  }
  __syncthreads();
  if (tid == 0) {
    const T grad = div_rn(fold_rows(tmp, C, 1), w_sum);
    p.stats[1] = isfinite(grad) ? grad : T(0);
  }
}

// Columns a tile: the column folds keep (C + 1) / 2 values of each in
// shared memory.
int tile_width(int rows, size_t tsize) {
  int w = kThreads;
  while (w > 32 && (size_t)((rows + 1) / 2) * w * tsize > kFoldBytes) w >>= 1;
  return w;
}

size_t smem_bytes(int rows, int w, size_t tsize) {
  return (size_t)3 * rows * tsize + (size_t)((rows + 1) / 2) * w * tsize +
         (size_t)rows * sizeof(int);
}

// CTAs of one launch: one per tile of columns, at most what is co-resident
// (a cooperative launch), cached per device and chain count.
template <typename T>
int max_ctas(int rows, long long cols) {
  static int resident_cache[16][kMaxChains + 1];  // 0: not asked yet
  const int w = tile_width(rows, sizeof(T));
  const size_t smem = smem_bytes(rows, w, sizeof(T));
  if (smem > 48 * 1024) return -1;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return -1;
  int& resident = resident_cache[dev][rows];
  if (resident == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, chees_accept_kernel<T>, kThreads, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return -1;
    resident = per_sm * sms;
  }
  const long long tiles = (cols + w - 1) / w;
  const long long ctas = tiles < resident ? tiles : resident;
  return ctas < 1 ? -1 : (int)ctas;
}

template <typename T>
cudaError_t launch(const void* z0, const void* pe0, const void* g0,
                   const void* n, const void* m_inv, const void* z1,
                   const void* r, const void* pe1, const void* g1,
                   const void* eps, const void* u, const void* mean_in,
                   const void* wf_mean, const void* wf_m2, double max_delta,
                   double h, double r_mean, double r_m2, long long n_post,
                   int flags, long long rows, long long cols, int ctas,
                   void* z_out, void* pe_out, void* g_out, void* energy_out,
                   void* accept_prob, void* diverging, void* mean_out,
                   void* stats, void* wf_mean_out, void* wf_m2_out,
                   void* sums, void* colmean, void* part, void* stream) {
  const bool stats_ok = (flags & kStats) ? stats != nullptr : true;
  const bool grad_ok = (flags & kGrad) ? colmean != nullptr : true;
  const bool fold_ok = (flags & kFold) ? wf_mean && wf_m2 && wf_mean_out &&
                                             wf_m2_out
                                       : true;
  if (rows < 1 || rows > kMaxChains || cols < 1 || ctas < 1 ||
      (flags & ~(kStats | kGrad | kFold)) ||
      ((flags & kGrad) && !(flags & kStats)) || !stats_ok || !fold_ok ||
      !grad_ok ||
      (n_post > 0 && (flags || !mean_in || !mean_out)) || n_post < 0)
    return cudaErrorInvalidValue;
  const int max = max_ctas<T>((int)rows, cols);
  if (max < 1 || ctas > max) return cudaErrorInvalidValue;
  const int w = tile_width((int)rows, sizeof(T));
  Params<T> p;
  p.z0 = (const T*)z0;
  p.pe0 = (const T*)pe0;
  p.g0 = (const T*)g0;
  p.n = (const T*)n;
  p.m_inv = (const T*)m_inv;
  p.z1 = (const T*)z1;
  p.r = (const T*)r;
  p.pe1 = (const T*)pe1;
  p.g1 = (const T*)g1;
  p.eps = (const T*)eps;
  p.u = (const T*)u;
  p.mean_in = (const T*)mean_in;
  p.wf_mean = (const T*)wf_mean;
  p.wf_m2 = (const T*)wf_m2;
  p.z_out = (T*)z_out;
  p.pe_out = (T*)pe_out;
  p.g_out = (T*)g_out;
  p.energy_out = (T*)energy_out;
  p.accept_prob = (T*)accept_prob;
  p.mean_out = (T*)mean_out;
  p.stats = (T*)stats;
  p.wf_mean_out = (T*)wf_mean_out;
  p.wf_m2_out = (T*)wf_m2_out;
  p.sums = (T*)sums;
  p.colmean = (T*)colmean;
  p.diverging = (bool*)diverging;
  p.part = (double*)part;
  p.max_delta = (T)max_delta;
  p.h = (T)h;
  p.r_mean = (T)r_mean;
  p.r_m2 = (T)r_m2;
  // (mean + (ap - mean) / n_post): PyTorch multiplies by the reciprocal of
  // a host number, formed in T on the host
  p.inv_n_post = n_post > 0 ? (T)1 / (T)n_post : (T)0;
  p.n_post = n_post;
  p.cols = cols;
  p.rows = (int)rows;
  p.flags = flags;
  p.tile = w;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)chees_accept_kernel<T>,
                                     dim3((unsigned)ctas), dim3(kThreads),
                                     args,
                                     smem_bytes((int)rows, w, sizeof(T)),
                                     (cudaStream_t)stream);
}

}  // namespace

extern "C" int chees_accept_max_chains() { return kMaxChains; }

// CTAs (and so rows of the [ctas][5][C] double workspace) of a launch over
// a (rows, cols) ensemble; -1 if it cannot launch.
extern "C" int chees_accept_ctas(long long rows, long long cols,
                                 int is_double) {
  if (rows < 1 || rows > kMaxChains || cols < 1) return -1;
  return is_double ? max_ctas<double>((int)rows, cols)
                   : max_ctas<float>((int)rows, cols);
}

// flags: 1 warmup statistics (stats[0], the harmonic mean), 2 also the
// ChEES gradient (stats[1]), 4 the Welford fold (wf_* in and out).  n_post
// > 0: after warmup (mean_in, mean_out; flags 0).
#define CHEES_ACCEPT(NAME, T)                                               \
  extern "C" int NAME(                                                      \
      const void* z0, const void* pe0, const void* g0, const void* n,       \
      const void* m_inv, const void* z1, const void* r, const void* pe1,    \
      const void* g1, const void* eps, const void* u, const void* mean_in,  \
      const void* wf_mean, const void* wf_m2, double max_delta, double h,   \
      double r_mean, double r_m2, long long n_post, int flags,              \
      long long rows, long long cols, int ctas, void* z_out, void* pe_out,  \
      void* g_out, void* energy_out, void* accept_prob, void* diverging,    \
      void* mean_out, void* stats, void* wf_mean_out, void* wf_m2_out,      \
      void* sums, void* colmean, void* part, void* stream) {                \
    return (int)launch<T>(z0, pe0, g0, n, m_inv, z1, r, pe1, g1, eps, u,    \
                          mean_in, wf_mean, wf_m2, max_delta, h, r_mean,    \
                          r_m2, n_post, flags, rows, cols, ctas, z_out,     \
                          pe_out, g_out, energy_out, accept_prob, diverging, \
                          mean_out, stats, wf_mean_out, wf_m2_out, sums,    \
                          colmean, part, stream);                           \
  }

CHEES_ACCEPT(chees_accept_f32, float)
CHEES_ACCEPT(chees_accept_f64, double)
