// Fused GroupNorm + affine + SiLU for Hopper (sm_90a): forward (B6) and
// backward (B7).
//
// Replaces the Pallas TPU kernels of medvae_tpu/ops/groupnorm_swish.py:
//   B6 _fwd_kernel:  y = silu(xhat * gamma + beta),  xhat = (x - mean_g) * rstd_g,
//                    the group statistics over (channels of the group) x (h w),
//                    z and SiLU in fp32, one cast to x's type at the end;
//   B7 _bwd_kernel:  dz = g s (1 + z (1 - s)), s = sigmoid(z);
//                    dgamma = sum dz xhat, dbeta = sum dz over batch and space;
//                    dx = rstd (dxhat - mean_g(dxhat) - xhat mean_g(dxhat xhat)),
//                    dxhat = dz gamma.
// x is (b, c, h, w) NCHW and contiguous, so the hw elements of one (image,
// channel) are one contiguous row, and the cg rows of a group are adjacent.
// G = c / cg groups, gamma and beta fp32 (c,), eps 1e-6 in the model.
//
// Bound: both are memory bound (a few operations per element). B6 must read x
// and write y once (2 N bytes-per-element); B7 must read x and g and write dx
// (3 N). At (32, 128, 224, 224) bf16 that is 822 MB and 1.23 GB, 0.245 and
// 0.368 ms at 3.35 TB/s.
//
// What this design does about that bound, simply (speed is a later step):
// every pass is a coalesced stream of 16-byte loads where the row length
// allows it (8 bf16 or 4 fp32 per access; rows whose length is not a multiple
// of that take 8-, 4- or 2-byte accesses), and the statistics never round
// trip through more than a few floats per row. It reads x twice in B6 (stats,
// then apply) and x and g twice in B7, so it can reach at best 2/3 and 3/5 of
// the bound; a single pass that keeps a group in shared memory is the next
// design.
//
// Determinism: no atomics anywhere. Cross-block sums are partials written to
// a workspace and reduced in a fixed order by a second kernel, so a run is
// bitwise repeatable.
//
// Forward, three launches:
//  1. gn_row_stats: one warp per (row, split). A row of hw elements is cut into
//     `splits` contiguous pieces when there are too few rows to fill the card
//     (32 rows x 128 channels at bucket 1); each warp writes the fp32 sums of
//     d = x - x[row start] and d^2 over its piece. The shift by the row's first
//     element keeps E[d^2] - E[d]^2 well conditioned when |mean| >> std.
//  2. gn_group_stats: one thread per (image, group) combines its cg x splits
//     partials in fp64 with Chan's rule (mean of the pieces, then their M2 and
//     the spread of their means) and writes mean and rstd, fp32 (b, G). The
//     autograd Function saves these for B7.
//  3. gn_swish_apply: elementwise, one vector per thread.
// Backward, three launches:
//  1. gn_bwd_row: one warp per (row, split) recomputes xhat, z and dz and
//     writes sum dz xhat and sum dz over its piece. Because gamma is constant
//     along a row, the group sums of dxhat and dxhat xhat are gamma_c times
//     these, so one reduction serves dgamma, dbeta and the group means.
//  2. gn_bwd_reduce: blocks [0, c) each reduce one channel's partials over the
//     batch (fp64, a fixed per-thread stride, then a fixed shared-memory tree)
//     into dgamma and dbeta; the blocks after them each take 256 (image,
//     group) pairs and write mean_g(dxhat) and mean_g(dxhat xhat).
//  3. gn_bwd_apply: elementwise dx.
//
// C interface (bound with ctypes; each returns the first CUDA error of its
// launches, 0 on success; ws is caller-allocated fp32 scratch of
// 2 b c splits floats (forward) or 2 b c splits + 2 b G floats (backward)):
//   int medvae_gn_swish_fwd_{bf16,f32}(x, gamma, beta, y, mean, rstd, ws,
//                                      b, c, hw, groups, splits, eps, stream)
//   int medvae_gn_swish_bwd_{bf16,f32}(x, g, gamma, beta, mean, rstd, dx,
//                                      dgamma, dbeta, ws,
//                                      b, c, hw, groups, splits, stream)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kApplyBlocks = 132 * 16;  // grid-stride cap of the elementwise passes

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// one memory access of VEC elements: a raw word of 16, 8, 4 or 2 bytes
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned; };
template <> struct Raw<2> { using type = unsigned short; };

template <typename T, int VEC>
__device__ __forceinline__ void load_pack(const T* __restrict__ p, float (&out)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R r = *reinterpret_cast<const R*>(p);
  T v[VEC];
  memcpy(v, &r, sizeof(R));
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_float(v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* __restrict__ p, const float (&in)[VEC]) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  T v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = from_float<T>(in[i]);
  R r;
  memcpy(&r, v, sizeof(R));
  *reinterpret_cast<R*>(p) = r;
}

__device__ __forceinline__ float sigmoid_fp32(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// [lo, hi) of vectors of split s, when nv vectors are cut into `splits`
// contiguous pieces (trailing pieces may be empty)
__device__ __forceinline__ void split_range(int nv, int splits, int s, int& lo, int& hi) {
  const int chunk = (nv + splits - 1) / splits;
  lo = min(s * chunk, nv);
  hi = min(lo + chunk, nv);
}

// ------------------------------------------------------------- forward ---- //

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_row_stats(const T* __restrict__ x, float* __restrict__ part, int rows, int hw, int splits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)rows * splits) return;  // the whole warp leaves together
  const int row = (int)(item / splits);
  const int s = (int)(item - (long long)row * splits);
  int lo, hi;
  split_range(hw / VEC, splits, s, lo, hi);
  const T* xr = x + (size_t)row * hw;
  const float shift = to_float(xr[0]);
  float s1 = 0.0f, s2 = 0.0f;
  for (int v = lo + lane; v < hi; v += 32) {
    float xv[VEC];
    load_pack<T, VEC>(xr + (size_t)v * VEC, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = xv[i] - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    part[2 * item] = s1;
    part[2 * item + 1] = s2;
  }
}

template <typename T>
__global__ void gn_group_stats(const T* __restrict__ x, const float* __restrict__ part,
                               float* __restrict__ mean, float* __restrict__ rstd, int b, int c,
                               int hw, int groups, int splits, int vec, float eps) {
  const int bg = blockIdx.x * blockDim.x + threadIdx.x;
  if (bg >= b * groups) return;
  const int bi = bg / groups, g = bg - bi * groups, cg = c / groups;
  const int nv = hw / vec;
  const double n_total = (double)cg * hw;
  // pass 1: the group mean from each piece's shifted sum
  double sum = 0.0;
  for (int k = 0; k < cg; ++k) {
    const size_t row = (size_t)bi * c + (size_t)g * cg + k;
    const double shift = to_float(x[row * hw]);
    for (int s = 0; s < splits; ++s) {
      int lo, hi;
      split_range(nv, splits, s, lo, hi);
      const double n = (double)(hi - lo) * vec;
      if (n > 0.0) sum += n * shift + (double)part[2 * (row * splits + s)];
    }
  }
  const double mu = sum / n_total;
  // pass 2: M2 = sum over pieces of (their own M2 + n (mean_p - mu)^2)
  double m2 = 0.0;
  for (int k = 0; k < cg; ++k) {
    const size_t row = (size_t)bi * c + (size_t)g * cg + k;
    const double shift = to_float(x[row * hw]);
    for (int s = 0; s < splits; ++s) {
      int lo, hi;
      split_range(nv, splits, s, lo, hi);
      const double n = (double)(hi - lo) * vec;
      if (n <= 0.0) continue;
      const double s1 = part[2 * (row * splits + s)];
      const double s2 = part[2 * (row * splits + s) + 1];
      const double dm = shift + s1 / n - mu;
      m2 += (s2 - s1 * s1 / n) + n * dm * dm;
    }
  }
  const double var = fmax(m2 / n_total, 0.0);
  mean[bg] = (float)mu;
  rstd[bg] = (float)(1.0 / sqrt(var + (double)eps));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_swish_apply(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ y, unsigned nvec, unsigned c,
               unsigned hw, unsigned cg) {
  const unsigned groups = c / cg;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec; v += gridDim.x * blockDim.x) {
    const unsigned e = v * VEC;
    const unsigned row = e / hw;
    const unsigned ch = row % c;
    const unsigned grp = (row / c) * groups + ch / cg;
    const float mu = mean[grp], rs = rstd[grp], ga = gamma[ch], be = beta[ch];
    float vals[VEC];
    load_pack<T, VEC>(x + e, vals);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (vals[i] - mu) * rs;
      const float z = xhat * ga + be;
      vals[i] = z * sigmoid_fp32(z);
    }
    store_pack<T, VEC>(y + e, vals);
  }
}

// ------------------------------------------------------------ backward ---- //

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_row(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ gamma,
           const float* __restrict__ beta, const float* __restrict__ mean,
           const float* __restrict__ rstd, float* __restrict__ part, int rows, int c, int hw,
           int cg, int splits) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= (long long)rows * splits) return;
  const int row = (int)(item / splits);
  const int s = (int)(item - (long long)row * splits);
  const int ch = row % c;
  const int grp = (row / c) * (c / cg) + ch / cg;
  const float mu = mean[grp], rs = rstd[grp], ga = gamma[ch], be = beta[ch];
  int lo, hi;
  split_range(hw / VEC, splits, s, lo, hi);
  const size_t base = (size_t)row * hw;
  float a = 0.0f, bsum = 0.0f;
  for (int v = lo + lane; v < hi; v += 32) {
    float xv[VEC], gv[VEC];
    load_pack<T, VEC>(x + base + (size_t)v * VEC, xv);
    load_pack<T, VEC>(g + base + (size_t)v * VEC, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (xv[i] - mu) * rs;
      const float z = xhat * ga + be;
      const float sg = sigmoid_fp32(z);
      const float dz = gv[i] * sg * (1.0f + z * (1.0f - sg));
      a += dz * xhat;
      bsum += dz;
    }
  }
  a = warp_sum(a);
  bsum = warp_sum(bsum);
  if (lane == 0) {
    part[2 * item] = a;
    part[2 * item + 1] = bsum;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce(const float* __restrict__ part, const float* __restrict__ gamma,
              float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ m12,
              int b, int c, int hw, int groups, int splits) {
  __shared__ double sh_a[kThreads];
  __shared__ double sh_b[kThreads];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < c) {  // one channel: dgamma, dbeta over the batch
    const int ch = blockIdx.x;
    double a = 0.0, bs = 0.0;
    for (int bi = tid; bi < b; bi += kThreads) {
      const float* p = part + 2 * ((size_t)bi * c + ch) * splits;
      for (int s = 0; s < splits; ++s) {
        a += p[2 * s];
        bs += p[2 * s + 1];
      }
    }
    sh_a[tid] = a;
    sh_b[tid] = bs;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) {
        sh_a[tid] += sh_a[tid + w];
        sh_b[tid] += sh_b[tid + w];
      }
      __syncthreads();
    }
    if (tid == 0) {
      dgamma[ch] = (float)sh_a[0];
      dbeta[ch] = (float)sh_b[0];
    }
    return;
  }
  const int bg = ((int)blockIdx.x - c) * kThreads + tid;
  if (bg >= b * groups) return;
  const int bi = bg / groups, g = bg - bi * groups, cg = c / groups;
  double m1 = 0.0, m2 = 0.0;
  for (int k = 0; k < cg; ++k) {
    const int ch = g * cg + k;
    const double ga = gamma[ch];
    const float* p = part + 2 * ((size_t)bi * c + ch) * splits;
    double a = 0.0, bs = 0.0;
    for (int s = 0; s < splits; ++s) {
      a += p[2 * s];
      bs += p[2 * s + 1];
    }
    m1 += ga * bs;
    m2 += ga * a;
  }
  const double n = (double)cg * hw;
  m12[2 * bg] = (float)(m1 / n);
  m12[2 * bg + 1] = (float)(m2 / n);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ mean,
             const float* __restrict__ rstd, const float* __restrict__ m12, T* __restrict__ dx,
             unsigned nvec, unsigned c, unsigned hw, unsigned cg) {
  const unsigned groups = c / cg;
  for (unsigned v = blockIdx.x * blockDim.x + threadIdx.x; v < nvec; v += gridDim.x * blockDim.x) {
    const unsigned e = v * VEC;
    const unsigned row = e / hw;
    const unsigned ch = row % c;
    const unsigned grp = (row / c) * groups + ch / cg;
    const float mu = mean[grp], rs = rstd[grp], ga = gamma[ch], be = beta[ch];
    const float m1 = m12[2 * grp], m2 = m12[2 * grp + 1];
    float xv[VEC], gv[VEC];
    load_pack<T, VEC>(x + e, xv);
    load_pack<T, VEC>(g + e, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (xv[i] - mu) * rs;
      const float z = xhat * ga + be;
      const float sg = sigmoid_fp32(z);
      const float dz = gv[i] * sg * (1.0f + z * (1.0f - sg));
      xv[i] = rs * (dz * ga - m1 - xhat * m2);
    }
    store_pack<T, VEC>(dx + e, xv);
  }
}

// ---------------------------------------------------------------- host ---- //

// the widest access (in elements, at most 16 bytes) that tiles every row
template <typename T>
int pick_vec(int hw) {
  for (int v = 16 / (int)sizeof(T); v > 1; v >>= 1) {
    if (hw % v == 0) return v;
  }
  return 1;
}

// VEC elements of T, capped at 16 bytes (the switch below names every case
// for both types; pick_vec never selects a capped one)
template <typename T>
constexpr int cap16(int vec) {
  return vec * (int)sizeof(T) <= 16 ? vec : 16 / (int)sizeof(T);
}

bool bad_shape(int b, int c, int hw, int groups, int splits) {
  if (b < 1 || c < 1 || hw < 1 || groups < 1 || splits < 1 || c % groups != 0) return true;
  const long long n = (long long)b * c * hw;
  return n >= (1LL << 31) || (long long)b * c * splits >= (1LL << 31) / 2;
}

unsigned apply_blocks(unsigned nvec) {
  const unsigned blocks = (nvec + kThreads - 1) / kThreads;
  return blocks < (unsigned)kApplyBlocks ? blocks : (unsigned)kApplyBlocks;
}

template <typename T, int VEC>
int fwd(const T* x, const float* gamma, const float* beta, T* y, float* mean, float* rstd,
        float* ws, int b, int c, int hw, int groups, int splits, float eps, cudaStream_t st) {
  const int rows = b * c;
  const long long items = (long long)rows * splits;
  gn_row_stats<T, VEC><<<(unsigned)((items + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      x, ws, rows, hw, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bg = b * groups;
  gn_group_stats<T><<<(bg + 127) / 128, 128, 0, st>>>(x, ws, mean, rstd, b, c, hw, groups, splits,
                                                       VEC, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned nvec = (unsigned)((long long)rows * hw / VEC);
  gn_swish_apply<T, VEC><<<apply_blocks(nvec), kThreads, 0, st>>>(
      x, gamma, beta, mean, rstd, y, nvec, (unsigned)c, (unsigned)hw, (unsigned)(c / groups));
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int bwd(const T* x, const T* g, const float* gamma, const float* beta, const float* mean,
        const float* rstd, T* dx, float* dgamma, float* dbeta, float* ws, int b, int c, int hw,
        int groups, int splits, cudaStream_t st) {
  const int rows = b * c;
  const long long items = (long long)rows * splits;
  float* m12 = ws + 2 * items;
  gn_bwd_row<T, VEC><<<(unsigned)((items + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      x, g, gamma, beta, mean, rstd, ws, rows, c, hw, c / groups, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bg = b * groups;
  gn_bwd_reduce<<<c + (bg + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ws, gamma, dgamma, dbeta, m12, b, c, hw, groups, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned nvec = (unsigned)((long long)rows * hw / VEC);
  gn_bwd_apply<T, VEC><<<apply_blocks(nvec), kThreads, 0, st>>>(
      x, g, gamma, beta, mean, rstd, m12, dx, nvec, (unsigned)c, (unsigned)hw,
      (unsigned)(c / groups));
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_any(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
            void* ws, int b, int c, int hw, int groups, int splits, float eps, void* stream) {
  if (bad_shape(b, c, hw, groups, splits)) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  float* wp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_vec<T>(hw)) {
    case 8: return fwd<T, cap16<T>(8)>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, splits, eps, st);
    case 4: return fwd<T, 4>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, splits, eps, st);
    case 2: return fwd<T, 2>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, splits, eps, st);
    default: return fwd<T, 1>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, splits, eps, st);
  }
}

template <typename T>
int bwd_any(const void* x, const void* g, const void* gamma, const void* beta, const void* mean,
            const void* rstd, void* dx, void* dgamma, void* dbeta, void* ws, int b, int c, int hw,
            int groups, int splits, void* stream) {
  if (bad_shape(b, c, hw, groups, splits)) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* wp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_vec<T>(hw)) {
    case 8: return bwd<T, cap16<T>(8)>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, splits, st);
    case 4: return bwd<T, 4>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, splits, st);
    case 2: return bwd<T, 2>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, splits, st);
    default: return bwd<T, 1>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, splits, st);
  }
}

}  // namespace

extern "C" int medvae_gn_swish_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                        void* y, void* mean, void* rstd, void* ws, int b, int c,
                                        int hw, int groups, int splits, float eps, void* stream) {
  return fwd_any<bf16>(x, gamma, beta, y, mean, rstd, ws, b, c, hw, groups, splits, eps, stream);
}

extern "C" int medvae_gn_swish_fwd_f32(const void* x, const void* gamma, const void* beta,
                                       void* y, void* mean, void* rstd, void* ws, int b, int c,
                                       int hw, int groups, int splits, float eps, void* stream) {
  return fwd_any<float>(x, gamma, beta, y, mean, rstd, ws, b, c, hw, groups, splits, eps, stream);
}

extern "C" int medvae_gn_swish_bwd_bf16(const void* x, const void* g, const void* gamma,
                                        const void* beta, const void* mean, const void* rstd,
                                        void* dx, void* dgamma, void* dbeta, void* ws, int b,
                                        int c, int hw, int groups, int splits, void* stream) {
  return bwd_any<bf16>(x, g, gamma, beta, mean, rstd, dx, dgamma, dbeta, ws, b, c, hw, groups,
                       splits, stream);
}

extern "C" int medvae_gn_swish_bwd_f32(const void* x, const void* g, const void* gamma,
                                       const void* beta, const void* mean, const void* rstd,
                                       void* dx, void* dgamma, void* dbeta, void* ws, int b,
                                       int c, int hw, int groups, int splits, void* stream) {
  return bwd_any<float>(x, g, gamma, beta, mean, rstd, dx, dgamma, dbeta, ws, b, c, hw, groups,
                        splits, stream);
}
