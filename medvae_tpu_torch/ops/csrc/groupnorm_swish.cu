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
// x is (b, c, h, w) NCHW and contiguous, so the cg = c / G channels of one
// (image, group) are adjacent rows: every group is one contiguous span of
// L = cg h w elements, and x is b G such spans end to end. gamma and beta are
// fp32 (c,), eps 1e-6 in the model.
//
// Bound: both are memory bound (a few operations per element). B6 must read x
// and write y once (2 N bytes-per-element); B7 must read x and g and write dx
// (3 N). At (32, 128, 224, 224) bf16 that is 822 MB and 1.23 GB, 0.245 and
// 0.368 ms at 3.35 TB/s.
//
// Design: a group fits on chip (the 28² CVAE's are 0.2-3 KB, the flagship's
// largest 401 KB in bf16), so each instance below but `streamed` reads every
// input byte once into shared memory, takes the statistics exactly in two
// passes over the resident data (the mean, then sum (x - mean)^2, fp32), and
// writes the output from there. The wrapper (ops/groupnorm_swish.py:
// gn_swish_plan) picks the instance and its sizes and passes them in; the
// kernels check that the shared memory the plan states is what they use.
//
//  resident  whole groups per block. A persistent grid (as many blocks as
//            the occupancy calculator fits on the card at once, given the
//            kernel's registers and the plan's shared memory); each block walks
//            spans of k groups (k L bytes a multiple of 16) through a ring of
//            `stages` shared-memory stages. A producer warp loads a span by
//            cp.async.bulk (1-D bulk copies completing on an mbarrier), and
//            once eight compute warps have written the output over it, stores
//            it by a bulk store and loads the span after next there; so the
//            compute warps never wait on memory but for the span they need.
//            A group is reduced by a segment of 8, 16 or 32 lanes of a warp
//            (L up to 256, 1024, 2048: several groups a warp, whose latency
//            chains overlap), else by the whole block. Accesses are vectors
//            of up to 16 bytes that tile the group; where they do not tile a
//            row (h w = 49 at 7²), a vector's elements take their own row's
//            gamma and beta. A span whose bytes are not a multiple of 16
//            (only the last can be) is copied with plain loads and stores.
//  cluster   one group across a thread-block cluster of 2-8 blocks, each
//            bulk-loading one slice. Each block reduces its slice; the ranks
//            exchange their partials through distributed shared memory and
//            combine them in rank order after a cluster barrier (no atomics,
//            so every rank holds the same bits), once for the mean and once
//            for sum (x - mean)^2 (B6), or once for the per-channel sums of
//            dz xhat and dz (B7). Groups whose bytes are not a multiple of 16
//            take plain loads.
//  streamed  the first design's kernels, for groups no cluster of 8 holds
//            (fp32 at (32, 128, 448, 448); no shipped configuration): three
//            launches each way that read x twice (and g twice), with shifted
//            sums per row cut into `splits` pieces and combined in fp64.
// B6 is one launch (resident, cluster). B7 is two: the first sums each
// (image, channel)'s dz xhat and dz into a (c, 2, b) fp32 workspace and then
// writes dx from the resident x and g, forming dz again in fp32 (as the TPU
// kernel and the plain version do: dz is never rounded to x's type); the
// second (gn_bwd_params) reduces the workspace over the batch in a fixed
// order into dgamma and dbeta. B7 takes B6's (b, G) mean and rstd. SiLU's
// sigmoid uses the SFU's exp2 and reciprocal (a few ulp).
//
// Determinism: no atomics anywhere; every sum is taken in a fixed order, so a
// run is bitwise repeatable.
//
// C interface (bound with ctypes; each returns the first CUDA error of its
// launches, 0 on success). `plan` is (instance, groups_per_span, stages,
// cluster, splits, lanes, smem_bytes) with instance 0 resident,
// 1 cluster, 2 streamed; ws is caller-allocated fp32 scratch of
// 2 b c splits floats (streamed forward), 2 b c splits + 2 b G (streamed
// backward), 2 b c (resident and cluster backward), none otherwise:
//   int medvae_gn_swish_fwd_{bf16,f32}(x, gamma, beta, y, mean, rstd, ws,
//                                      b, c, hw, groups, <plan>, eps, stream)
//   int medvae_gn_swish_bwd_{bf16,f32}(x, g, gamma, beta, mean, rstd, dx,
//                                      dgamma, dbeta, ws,
//                                      b, c, hw, groups, <plan>, stream)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace cgrp = cooperative_groups;

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

// ------------------------------------------------- streamed: forward ---- //

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

// ------------------------------------------------ streamed: backward ---- //

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

// B7's second launch for the resident and cluster instances: block ch sums
// the first launch's part[(2 ch + j) b + i] over the images i (fp64, a fixed
// per-thread stride over coalesced rows, then a fixed shared-memory tree)
// into dgamma[ch] (j = 0) and dbeta[ch] (j = 1).
__global__ void __launch_bounds__(kThreads)
gn_bwd_params(const float* __restrict__ part, float* __restrict__ dgamma, float* __restrict__ dbeta,
              int b) {
  __shared__ double sh_a[kThreads];
  __shared__ double sh_b[kThreads];
  const int ch = blockIdx.x, tid = threadIdx.x;
  const float* pa = part + (size_t)(2 * ch) * b;
  const float* pb = pa + b;
  double a = 0.0, bs = 0.0;
  for (int i = tid; i < b; i += kThreads) {
    a += pa[i];
    bs += pb[i];
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
}

// ----------------------------------------------- resident and cluster ---- //

// The dynamic shared memory of the resident and cluster kernels: a header of
// kHeader bytes (the mbarriers, the reductions' scratch, the per-channel
// partials and the cluster's exchanged ones), then the data.
constexpr int kHeader = 3072;
constexpr int kMaxStages = 8;
constexpr int kChunks = 4;          // bulk loads a cluster's slice arrives in (B6; B7's in one)
constexpr int kMaxCg = 32;          // channels of a group a block or a cluster reduces
constexpr int kRedStride = 2 * kMaxCg;
constexpr int kPiece = 64;          // vectors a warp takes at a time in B7's block-wide sums
// mbarriers at 0: up to 2 kMaxStages (resident) or kChunks (cluster)
constexpr int kScratchOff = 128;    // kWarps floats: block_sum's
constexpr int kRedOff = 192;        // kWarps x kRedStride floats: each warp's channel sums
constexpr int kExchangeOff = 2240;  // 2 x kMaxCg floats: the block's, which its cluster reads
constexpr int kTotalsOff = 2496;    // 2 x kMaxCg floats: the group's channel sums
constexpr int kMaxCluster = 8;
constexpr int kResidentThreads = kThreads + 32;  // eight compute warps and a producer

// fp32 sum of v over each aligned segment of nt lanes (8, 16 or 32) of a
// warp, in a fixed order; every lane of the segment gets it.
__device__ __forceinline__ float seg_sum(float v, int nt) {
  for (int o = nt >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 sum of v over the block's 256 reducing threads, in a fixed order;
// every thread gets it. (They meet on named barrier 1; the resident kernel's
// producer warp is not among them.)
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  consumers_sync();  // the scratch's previous readers are done
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  consumers_sync();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += scratch[w];
  return t;
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this block's shared memory, completing
// on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// 1-D bulk copy from shared memory to device memory, in the issuing thread's
// bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src), "r"(bytes)
               : "memory");
}

// n elements by threads first, first + stride, ...: 16 bytes a thread where
// both ends are 16-byte aligned and n fills whole vectors, else one element
template <typename T>
__device__ __forceinline__ void plain_copy(T* __restrict__ dst, const T* __restrict__ src, long long n,
                                           int first, int stride) {
  if ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | (n * sizeof(T))) % 16 == 0) {
    const long long nv = n * (long long)sizeof(T) / 16;
    for (long long i = first; i < nv; i += stride) {
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
    return;
  }
  for (long long i = first; i < n; i += stride) dst[i] = src[i];
}

// Walks elements e = first, first + stride, ... of a group with the channel
// (within the group) each lies in, rows of hw elements, without a division a
// step.
struct ChannelWalk {
  int k, off, hw;  // element e = k hw + off
  __device__ ChannelWalk(int e, int hw_) : k(e / hw_), off(e - (e / hw_) * hw_), hw(hw_) {}
  __device__ __forceinline__ void step(int stride) {
    off += stride;
    while (off >= hw) {
      off -= hw;
      ++k;
    }
  }
};

// fp32 SiLU's sigmoid in the resident and cluster kernels: the SFU's exp2 and
// reciprocal (a few ulp; the streamed kernels keep expf and a division)
__device__ __forceinline__ float sigmoid_fast(float z) { return __fdividef(1.0f, 1.0f + __expf(-z)); }

__device__ __forceinline__ float silu_z(float x, float mu, float rs, float ga, float be) {
  const float z = (x - mu) * rs * ga + be;
  return z * sigmoid_fast(z);
}

// dz = g s (1 + z (1 - s)) at one element, with its xhat
__device__ __forceinline__ float dz_at(float x, float gv, float mu, float rs, float ga, float be,
                                       float& xhat) {
  xhat = (x - mu) * rs;
  const float z = xhat * ga + be;
  const float sg = sigmoid_fast(z);
  return gv * sg * (1.0f + z * (1.0f - sg));
}

// ---- passes over resident data, vectors [v0, v1) of VEC elements at p, one
// thread t of nt taking v0 + t, v0 + t + nt, ...

template <typename T, int VEC>
__device__ __forceinline__ float sum_x(const T* p, int v0, int v1, int t, int nt) {
  float s = 0.0f;
  for (int v = v0 + t; v < v1; v += nt) {
    float xv[VEC];
    load_pack<T, VEC>(p + (size_t)v * VEC, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += xv[i];
  }
  return s;
}

template <typename T, int VEC>
__device__ __forceinline__ float sum_sq(const T* p, int v0, int v1, int t, int nt, float mu) {
  float s = 0.0f;
  for (int v = v0 + t; v < v1; v += nt) {
    float xv[VEC];
    load_pack<T, VEC>(p + (size_t)v * VEC, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = xv[i] - mu;
      s += d * d;
    }
  }
  return s;
}

// (sum dz xhat, sum dz) added to (a, b) over the vectors of one channel row
template <typename T, int VEC>
__device__ __forceinline__ void row_sums(const T* xp, const T* gp, int v0, int v1, int t, int nt,
                                         float mu, float rs, float ga, float be, float& a, float& b) {
  for (int v = v0 + t; v < v1; v += nt) {
    float xv[VEC], gv[VEC];
    load_pack<T, VEC>(xp + (size_t)v * VEC, xv);
    load_pack<T, VEC>(gp + (size_t)v * VEC, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xhat;
      const float dz = dz_at(xv[i], gv[i], mu, rs, ga, be, xhat);
      a += dz * xhat;
      b += dz;
    }
  }
}

// dx = rstd (dz gamma - m1 - xhat m2) at one element, dz formed again in
// fp32 from x and g
__device__ __forceinline__ float dx_at(float x, float gv, float mu, float rs, float ga, float be,
                                       float m1, float m2) {
  float xhat;
  const float dz = dz_at(x, gv, mu, rs, ga, be, xhat);
  return rs * (dz * ga - m1 - xhat * m2);
}

// The block's per-channel partials: red[w * kRedStride + 2 k + {0, 1}] holds
// warp w's (sum dz xhat, sum dz) of channel k. Thread j < 2 cg adds warp
// 0..7's in that order (no atomics).
__device__ __forceinline__ float warps_total(const float* red, int j) {
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w * kRedStride + j];
  return t;
}

// Vectors of a resident group: VEC elements that tile the group (its start
// is aligned to them), so a vector may straddle two channel rows when VEC
// does not divide h w (VEC <= h w, so never three). Per element, the
// channel's gamma and beta are the vector's first row's or the next one's.
struct RowPair {
  float ga0, be0, ga1, be1;
  int edge;  // the vector's elements from edge on lie in the next row
};

template <int VEC>
__device__ __forceinline__ RowPair row_pair(const ChannelWalk& cw, int cg, const float* __restrict__ gamma,
                                            const float* __restrict__ beta) {
  const int edge = cw.hw - cw.off;
  const int k1 = edge < VEC && cw.k + 1 < cg ? cw.k + 1 : cw.k;
  return RowPair{gamma[cw.k], beta[cw.k], gamma[k1], beta[k1], edge};
}

// B7's first pass over elements [e0, e1) of the block's data (element e is
// element lo + e of its group, rows of hw): a row's share of at least
// kWarps pieces of kPiece vectors is taken by the whole block; a shorter one
// is cut into such pieces, which the block's warps take in turn (piece p to
// warp p % kWarps), so a short row does not leave most threads idle. Each
// warp adds its share of channel k's (sum dz xhat, sum dz) to red[warp *
// kRedStride + 2 k + {0, 1}], in a fixed order.
template <typename T, int VEC>
__device__ void piece_sums(const T* xs, const T* gs, int e0, int e1, int lo, int hw,
                           const float* __restrict__ gamma, const float* __restrict__ beta, float mu,
                           float rs, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int p = 0;
  for (int k = (lo + e0) / hw; k <= (lo + e1 - 1) / hw; ++k) {
    const int v0 = max(e0, k * hw - lo) / VEC, v1 = min(e1, (k + 1) * hw - lo) / VEC;
    const bool whole_block = v1 - v0 >= kWarps * kPiece;
    for (int pv = v0; pv < v1; pv += whole_block ? v1 - v0 : kPiece, ++p) {
      if (!whole_block && p % kWarps != warp) continue;
      float a = 0.0f, b = 0.0f;
      if (whole_block) {
        row_sums<T, VEC>(xs, gs, v0, v1, threadIdx.x, kThreads, mu, rs, gamma[k], beta[k], a, b);
      } else {
        row_sums<T, VEC>(xs, gs, pv, min(pv + kPiece, v1), lane, 32, mu, rs, gamma[k], beta[k], a, b);
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        red[warp * kRedStride + 2 * k] += a;
        red[warp * kRedStride + 2 * k + 1] += b;
      }
    }
  }
}

// ---- B6 on one resident group of cg rows of hw elements at xs, reduced by
// thread t of nt: a segment of 8, 16 or 32 lanes of a warp, or (BLOCK) the
// block's 256 threads. Writes y over x, and mean and rstd, where `write` (a
// segment with no group of its own repeats another's and writes nothing).
// ROWS: VEC divides h w, so the last pass walks row by row with the row's
// gamma and beta; else it walks the group's vectors with a RowPair each.
template <typename T, int VEC, bool BLOCK, bool ROWS>
__device__ void fwd_group(T* xs, int cg, int hw, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps, float* mean_out,
                          float* rstd_out, int t, int nt, bool write, float* scratch) {
  const int L = cg * hw, nv = L / VEC;
  float s = sum_x<T, VEC>(xs, 0, nv, t, nt);
  const float mu = (BLOCK ? block_sum(s, scratch) : seg_sum(s, nt)) / (float)L;
  s = sum_sq<T, VEC>(xs, 0, nv, t, nt, mu);
  const float rs = 1.0f / sqrtf((BLOCK ? block_sum(s, scratch) : seg_sum(s, nt)) / (float)L + eps);
  if (t == 0 && write) {
    *mean_out = mu;
    *rstd_out = rs;
  }
  if (!write) return;
  if constexpr (ROWS) {
    for (int k = 0; k < cg; ++k) {
      const float ga = gamma[k], be = beta[k];
      T* row = xs + (size_t)k * hw;
      for (int v = t; v < hw / VEC; v += nt) {
        float xv[VEC];
        load_pack<T, VEC>(row + (size_t)v * VEC, xv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[i] = silu_z(xv[i], mu, rs, ga, be);
        store_pack<T, VEC>(row + (size_t)v * VEC, xv);
      }
    }
  } else {
    ChannelWalk cw(t * VEC, hw);
    for (int v = t; v < nv; v += nt, cw.step(nt * VEC)) {
      const RowPair rp = row_pair<VEC>(cw, cg, gamma, beta);
      float xv[VEC];
      load_pack<T, VEC>(xs + (size_t)v * VEC, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const bool next = i >= rp.edge;
        xv[i] = silu_z(xv[i], mu, rs, next ? rp.ga1 : rp.ga0, next ? rp.be1 : rp.be0);
      }
      store_pack<T, VEC>(xs + (size_t)v * VEC, xv);
    }
  }
}

// ---- B7 on one resident group: x at xs, the incoming gradient at gs,
// reduced as in fwd_group. The first pass sums channel k's (sum dz xhat,
// sum dz) into part[2 k pstride] and part[(2 k + 1) pstride]; the second
// writes dx over x from x and g, forming dz again. Without ROWS a row's first
// pass takes the vectors that hold any of its elements and only those
// elements. A segment reduces each channel itself; the block (cg <= kMaxCg)
// gathers its warps' partials in `red` and adds them in warp order.
template <typename T, int VEC, bool BLOCK, bool ROWS>
__device__ void bwd_group(T* xs, const T* gs, int cg, int hw, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float mu, float rs,
                          float* __restrict__ part, int pstride, int t, int nt, bool write,
                          float* red, float* totals) {
  const int L = cg * hw, nv = L / VEC;
  const float inv_n = 1.0f / (float)L;
  float m1 = 0.0f, m2 = 0.0f;
  if constexpr (BLOCK && ROWS) {
    for (int j = t; j < kWarps * kRedStride; j += kThreads) red[j] = 0.0f;
    consumers_sync();
    piece_sums<T, VEC>(xs, gs, 0, L, 0, hw, gamma, beta, mu, rs, red);
  }
  for (int k = 0; k < cg && !(BLOCK && ROWS); ++k) {
    const float ga = gamma[k], be = beta[k];
    float a = 0.0f, b = 0.0f;
    if constexpr (ROWS) {
      row_sums<T, VEC>(xs + (size_t)k * hw, gs + (size_t)k * hw, 0, hw / VEC, t, nt, mu, rs, ga, be, a,
                       b);
    } else {
      const int e0 = k * hw, e1 = e0 + hw;
      for (int v = e0 / VEC + t; v < (e1 + VEC - 1) / VEC; v += nt) {
        float xv[VEC], gv[VEC];
        load_pack<T, VEC>(xs + (size_t)v * VEC, xv);
        load_pack<T, VEC>(gs + (size_t)v * VEC, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xhat;
          const float dz = dz_at(xv[i], gv[i], mu, rs, ga, be, xhat);
          const bool in = v * VEC + i >= e0 && v * VEC + i < e1;
          a += in ? dz * xhat : 0.0f;
          b += in ? dz : 0.0f;
        }
      }
    }
    if constexpr (BLOCK) {
      a = warp_sum(a);
      b = warp_sum(b);
      if ((t & 31) == 0) {
        red[(t >> 5) * kRedStride + 2 * k] = a;
        red[(t >> 5) * kRedStride + 2 * k + 1] = b;
      }
    } else {
      a = seg_sum(a, nt);
      b = seg_sum(b, nt);
      if (t == 0 && write) {
        part[(size_t)(2 * k) * pstride] = a;
        part[(size_t)(2 * k + 1) * pstride] = b;
      }
      m1 += ga * b;
      m2 += ga * a;
    }
  }
  if constexpr (BLOCK) {
    consumers_sync();
    if (t < 2 * cg) {
      totals[t] = warps_total(red, t);
      part[(size_t)t * pstride] = totals[t];
    }
    consumers_sync();
    for (int k = 0; k < cg; ++k) {
      m1 += gamma[k] * totals[2 * k + 1];
      m2 += gamma[k] * totals[2 * k];
    }
  } else {
    __syncwarp();  // the segment's reads of x are done before dx overwrites it
  }
  if (!write) return;
  m1 *= inv_n;
  m2 *= inv_n;
  if constexpr (ROWS) {
    for (int k = 0; k < cg; ++k) {
      const float ga = gamma[k], be = beta[k];
      T* row = xs + (size_t)k * hw;
      const T* grow = gs + (size_t)k * hw;
      for (int v = t; v < hw / VEC; v += nt) {
        float xv[VEC], gv[VEC];
        load_pack<T, VEC>(row + (size_t)v * VEC, xv);
        load_pack<T, VEC>(grow + (size_t)v * VEC, gv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[i] = dx_at(xv[i], gv[i], mu, rs, ga, be, m1, m2);
        store_pack<T, VEC>(row + (size_t)v * VEC, xv);
      }
    }
  } else {
    ChannelWalk cw(t * VEC, hw);
    for (int v = t; v < nv; v += nt, cw.step(nt * VEC)) {
      const RowPair rp = row_pair<VEC>(cw, cg, gamma, beta);
      float xv[VEC], gv[VEC];
      load_pack<T, VEC>(xs + (size_t)v * VEC, xv);
      load_pack<T, VEC>(gs + (size_t)v * VEC, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const bool next = i >= rp.edge;
        xv[i] = dx_at(xv[i], gv[i], mu, rs, next ? rp.ga1 : rp.ga0, next ? rp.be1 : rp.be0, m1, m2);
      }
      store_pack<T, VEC>(xs + (size_t)v * VEC, xv);
    }
  }
}

// The resident instance of B6 (BWD false) and of B7's first launch (BWD
// true). A persistent grid: block j takes spans j, j + gridDim.x, ... of
// k groups each, through `stages` ring stages of cap = k L elements (and as
// many again for g) after the header. Warps 0-7 compute; warp 8 is the
// producer: it loads span i into stage i % stages (full[s] completes when
// the bytes land), and once the compute warps have written the output over
// it (empty[s]) stores it, waits until the store has read the stage, and
// loads span i + stages there. So no compute warp waits on a store. A span
// whose bytes are not a multiple of 16 (only the last can be) is copied by
// the producer warp with plain loads and stores.
template <typename T, bool BWD, bool BLOCK, int VEC, bool ROWS>
__device__ __forceinline__ void resident_body(const T* __restrict__ x, const T* __restrict__ g,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, T* __restrict__ out,
                                              float* __restrict__ mean, float* __restrict__ rstd,
                                              float* __restrict__ part, int ngroups, int c, int hw,
                                              int cg, int k, int stages, int lanes, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = cg * hw, G = c / cg, batch = ngroups / G;
  const long long cap = (long long)k * L;  // elements a stage holds (of x; as many of g)
  const uint32_t bars = smem_u32(smem);  // full[s] at 8 s, empty[s] at 8 (kMaxStages + s)
  float* scratch = reinterpret_cast<float*>(smem + kScratchOff);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* totals = reinterpret_cast<float*>(smem + kTotalsOff);
  T* data = reinterpret_cast<T*>(smem + kHeader);
  const long long nspans = ((long long)ngroups + k - 1) / k;
  const int mine = blockIdx.x < nspans ? (int)((nspans - 1 - blockIdx.x) / gridDim.x + 1) : 0;

  auto span_of = [&](int i) { return (long long)blockIdx.x + (long long)i * gridDim.x; };
  auto elems = [&](int i) { return min(cap, (ngroups - span_of(i) * k) * (long long)L); };
  auto stage_x = [&](int i) { return data + (size_t)(i % stages) * cap * (BWD ? 2 : 1); };
  auto full = [&](int i) { return bars + 8 * (i % stages); };
  auto empty = [&](int i) { return bars + 8 * (kMaxStages + i % stages); };
  auto is_bulk = [&](int i) { return (elems(i) * (long long)sizeof(T)) % 16 == 0; };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kMaxStages + s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    // span i into its stage (the stage is free)
    auto load = [&](int i) {
      const long long off = span_of(i) * cap, n_el = elems(i);
      T* dst = stage_x(i);
      if (is_bulk(i)) {
        if (lane == 0) {
          const uint32_t bytes = (uint32_t)(n_el * sizeof(T));
          mbar_expect_tx(full(i), bytes * (BWD ? 2 : 1));
          bulk_load(smem_u32(dst), x + off, bytes, full(i));
          if (BWD) bulk_load(smem_u32(dst + cap), g + off, bytes, full(i));
        }
      } else {
        plain_copy(dst, x + off, n_el, lane, 32);
        if (BWD) plain_copy(dst + cap, g + off, n_el, lane, 32);
        __syncwarp();
        if (lane == 0) mbar_arrive(full(i));
      }
    };
    // span i's output out of its stage, once the compute warps are done
    auto store = [&](int i) {
      mbar_wait(empty(i), (uint32_t)((i / stages) & 1));
      const long long off = span_of(i) * cap, n_el = elems(i);
      if (is_bulk(i)) {
        if (lane == 0) {
          bulk_store(out + off, smem_u32(stage_x(i)), (uint32_t)(n_el * sizeof(T)));
          tma_store_commit();
          tma_store_wait_read();  // the stage may be loaded again
        }
      } else {
        plain_copy(out + off, stage_x(i), n_el, lane, 32);
      }
      __syncwarp();
    };
    for (int i = 0; i < mine; ++i) {
      if (i >= stages) store(i - stages);
      load(i);
    }
    for (int i = max(0, mine - stages); i < mine; ++i) store(i);
    if (lane == 0) tma_store_wait_all();
    return;
  }

  for (int i = 0; i < mine; ++i) {
    mbar_wait(full(i), (uint32_t)((i / stages) & 1));
    T* xs = stage_x(i);
    T* gsm = xs + cap;
    const int n_in = (int)(elems(i) / L);
    const long long group0 = span_of(i) * k;
    if constexpr (BLOCK) {
      for (int gi = 0; gi < n_in; ++gi) {
        const long long grp = group0 + gi;
        const int ch0 = (int)(grp % G) * cg;
        if (BWD) {
          bwd_group<T, VEC, true, ROWS>(xs + (size_t)gi * L, gsm + (size_t)gi * L, cg, hw, gamma + ch0,
                                        beta + ch0, mean[grp], rstd[grp],
                                        part + (size_t)(2 * ch0) * batch + grp / G, batch, tid,
                                        kThreads, true, red, totals);
        } else {
          fwd_group<T, VEC, true, ROWS>(xs + (size_t)gi * L, cg, hw, gamma + ch0, beta + ch0, eps,
                                        mean + grp, rstd + grp, tid, kThreads, true, scratch);
        }
      }
    } else {
      // each warp takes 32 / lanes groups at a time, a segment of `lanes`
      // lanes each; a segment past the span's last group repeats it unwritten
      const int per_warp = 32 / lanes;
      for (int base = warp * per_warp; base < n_in; base += kWarps * per_warp) {
        const int own = base + lane / lanes;
        const bool write = own < n_in;
        const int gi = write ? own : n_in - 1;
        const long long grp = group0 + gi;
        const int ch0 = (int)(grp % G) * cg;
        if (BWD) {
          bwd_group<T, VEC, false, ROWS>(xs + (size_t)gi * L, gsm + (size_t)gi * L, cg, hw,
                                         gamma + ch0, beta + ch0, mean[grp], rstd[grp],
                                         part + (size_t)(2 * ch0) * batch + grp / G, batch,
                                         lane % lanes, lanes, write, red, totals);
        } else {
          fwd_group<T, VEC, false, ROWS>(xs + (size_t)gi * L, cg, hw, gamma + ch0, beta + ch0, eps,
                                         mean + grp, rstd + grp, lane % lanes, lanes, write, scratch);
        }
      }
    }
    fence_async_shared();  // this thread's writes of the output, to the bulk store
    mbar_arrive(empty(i));
  }
}

// The cluster instance: cluster r of `n` blocks takes group r = blockIdx.x /
// n; its rank-th block holds elements [rank sl, min(L, (rank + 1) sl)) of
// it, sl a multiple of 8, x (and g) after the header, g sl elements after x. A slice arrives in kChunks bulk
// loads, each on its own mbarrier, so the first pass starts on the first
// chunk; the last pass stores each chunk as it is done.
template <typename T, bool BWD, int VEC>
__device__ __forceinline__ void cluster_body(const T* __restrict__ x, const T* __restrict__ g,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, T* __restrict__ out,
                                             float* __restrict__ mean, float* __restrict__ rstd,
                                             float* __restrict__ part, int ngroups, int c, int hw,
                                             int cg, int sl, float eps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int chunks = BWD ? 1 : kChunks;
  const int L = cg * hw, G = c / cg;
  const int lo = min(rank * sl, L), hi = min(lo + sl, L), len = hi - lo;
  const int ck = ((len + chunks - 1) / chunks + 7) / 8 * 8;  // chunk, a multiple of 8 elements
  const uint32_t bars = smem_u32(smem);
  float* scratch = reinterpret_cast<float*>(smem + kScratchOff);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* exch = reinterpret_cast<float*>(smem + kExchangeOff);
  float* totals = reinterpret_cast<float*>(smem + kTotalsOff);
  T* xs = reinterpret_cast<T*>(smem + kHeader);
  T* gsm = xs + sl;
  const bool bulk = ((long long)L * sizeof(T)) % 16 == 0;  // then every slice and chunk is aligned
  const int batch = ngroups / G;
  const long long grp = blockIdx.x / n;
  const long long base = grp * L + lo;
  const int ch0 = (int)(grp % G) * cg;
  const float* gamma_g = gamma + ch0;
  const float* beta_g = beta + ch0;
  auto chunk_lo = [&](int q) { return min(q * ck, len); };

  if (bulk) {
    if (tid == 0) {
      for (int q = 0; q < chunks; ++q) mbar_init(bars + 8 * q, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int q = 0; q < chunks; ++q) {
        const uint32_t bytes = (uint32_t)(chunk_lo(q + 1) - chunk_lo(q)) * sizeof(T);
        mbar_expect_tx(bars + 8 * q, bytes * (BWD ? 2 : 1));
        if (bytes > 0) {
          bulk_load(smem_u32(xs + chunk_lo(q)), x + base + chunk_lo(q), bytes, bars + 8 * q);
          if (BWD) bulk_load(smem_u32(gsm + chunk_lo(q)), g + base + chunk_lo(q), bytes, bars + 8 * q);
        }
      }
    }
  } else {
    plain_copy(xs, x + base, len, tid, kThreads);
    if (BWD) plain_copy(gsm, g + base, len, tid, kThreads);
  }
  if (BWD) {
    for (int j = tid; j < kWarps * kRedStride; j += kThreads) red[j] = 0.0f;
  }
  __syncthreads();
  auto arrived = [&](int q) {  // chunk q of the slice is in shared memory
    if (bulk) mbar_wait(bars + 8 * q, 0);
  };
  // the chunked last pass: `body(v0, v1)` over each chunk's vectors, then
  // the chunk's bulk store
  auto last_pass = [&](auto body) {
    for (int q = 0; q < chunks; ++q) {
      body(chunk_lo(q) / VEC, chunk_lo(q + 1) / VEC);
      if (bulk) {
        fence_async_shared();
        __syncthreads();
        if (tid == 0 && chunk_lo(q + 1) > chunk_lo(q)) {
          bulk_store(out + base + chunk_lo(q), smem_u32(xs + chunk_lo(q)),
                     (uint32_t)(chunk_lo(q + 1) - chunk_lo(q)) * sizeof(T));
        }
      }
    }
    if (bulk) {
      if (tid == 0) {
        tma_store_commit();
        tma_store_wait_all();
      }
    } else {
      __syncthreads();
      plain_copy(out + base, xs, len, tid, kThreads);
    }
  };

  if (!BWD) {
    float s = 0.0f;
    for (int q = 0; q < chunks; ++q) {
      arrived(q);
      s += sum_x<T, VEC>(xs, chunk_lo(q) / VEC, chunk_lo(q + 1) / VEC, tid, kThreads);
    }
    s = block_sum(s, scratch);
    if (tid == 0) exch[0] = s;
    cluster.sync();
    float total = 0.0f;
    for (int r = 0; r < n; ++r) total += cluster.map_shared_rank(exch, r)[0];
    const float mu = total / (float)L;
    float m2 = block_sum(sum_sq<T, VEC>(xs, 0, len / VEC, tid, kThreads, mu), scratch);
    if (tid == 0) exch[1] = m2;
    cluster.sync();
    total = 0.0f;
    for (int r = 0; r < n; ++r) total += cluster.map_shared_rank(exch, r)[1];
    cluster.sync();  // no rank reads this block's partials any more: it may exit
    const float rs = 1.0f / sqrtf(total / (float)L + eps);
    if (rank == 0 && tid == 0) {
      mean[grp] = mu;
      rstd[grp] = rs;
    }
    last_pass([&](int v0, int v1) {
      ChannelWalk cw(lo + (v0 + tid) * VEC, hw);
      for (int v = v0 + tid; v < v1; v += kThreads, cw.step(kThreads * VEC)) {
        float xv[VEC];
        load_pack<T, VEC>(xs + (size_t)v * VEC, xv);
        const float ga = gamma_g[cw.k], be = beta_g[cw.k];
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[i] = silu_z(xv[i], mu, rs, ga, be);
        store_pack<T, VEC>(xs + (size_t)v * VEC, xv);
      }
    });
  } else {
    const float mu = mean[grp], rs = rstd[grp];
    // each warp's share of each channel's (sum dz xhat, sum dz), chunk by
    // chunk, into red in a fixed order
    for (int q = 0; q < chunks; ++q) {
      arrived(q);
      if (chunk_lo(q + 1) > chunk_lo(q)) {
        piece_sums<T, VEC>(xs, gsm, chunk_lo(q), chunk_lo(q + 1), lo, hw, gamma_g, beta_g, mu, rs, red);
      }
    }
    __syncthreads();
    for (int j = tid; j < 2 * cg; j += kThreads) exch[j] = warps_total(red, j);
    cluster.sync();
    // each channel's sums over the ranks, in rank order
    for (int j = tid; j < 2 * cg; j += kThreads) {
      float t = 0.0f;
      for (int r = 0; r < n; ++r) t += cluster.map_shared_rank(exch, r)[j];
      totals[j] = t;
      if (rank == 0) part[(size_t)(2 * ch0 + j) * batch + grp / G] = t;
    }
    cluster.sync();  // no rank reads this block's partials any more: it may exit
    float m1 = 0.0f, m2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      m1 += gamma_g[k] * totals[2 * k + 1];
      m2 += gamma_g[k] * totals[2 * k];
    }
    m1 /= (float)L;
    m2 /= (float)L;
    last_pass([&](int v0, int v1) {
      ChannelWalk cw(lo + (v0 + tid) * VEC, hw);
      for (int v = v0 + tid; v < v1; v += kThreads, cw.step(kThreads * VEC)) {
        float xv[VEC], gv[VEC];
        load_pack<T, VEC>(xs + (size_t)v * VEC, xv);
        load_pack<T, VEC>(gsm + (size_t)v * VEC, gv);
        const float ga = gamma_g[cw.k], be = beta_g[cw.k];
#pragma unroll
        for (int i = 0; i < VEC; ++i) xv[i] = dx_at(xv[i], gv[i], mu, rs, ga, be, m1, m2);
        store_pack<T, VEC>(xs + (size_t)v * VEC, xv);
      }
    });
  }
}

// The four kernels, named by pass and instance (chip_smoke.py's profile
// sorts kernels into B6 and B7 by name), each with VEC elements an access:
// the widest (at most 16 bytes) that tiles a row of h w.
#define GN_RESIDENT_ARGS                                                                        \
  const T *__restrict__ x, const T *__restrict__ g, const float *__restrict__ gamma,            \
      const float *__restrict__ beta, T *__restrict__ out, float *__restrict__ mean,           \
      float *__restrict__ rstd, float *__restrict__ part, int ngroups, int c, int hw, int cg,  \
      int k, int stages, int lanes, float eps
#define GN_CLUSTER_ARGS                                                                         \
  const T *__restrict__ x, const T *__restrict__ g, const float *__restrict__ gamma,            \
      const float *__restrict__ beta, T *__restrict__ out, float *__restrict__ mean,           \
      float *__restrict__ rstd, float *__restrict__ part, int ngroups, int c, int hw, int cg, int sl, \
      float eps

template <typename T, bool BLOCK, int VEC, bool ROWS>
__global__ void __launch_bounds__(kResidentThreads) gn_fwd_resident(GN_RESIDENT_ARGS) {
  resident_body<T, false, BLOCK, VEC, ROWS>(x, g, gamma, beta, out, mean, rstd, part, ngroups, c, hw,
                                            cg, k, stages, lanes, eps);
}

template <typename T, bool BLOCK, int VEC, bool ROWS>
__global__ void __launch_bounds__(kResidentThreads) gn_bwd_resident(GN_RESIDENT_ARGS) {
  resident_body<T, true, BLOCK, VEC, ROWS>(x, g, gamma, beta, out, mean, rstd, part, ngroups, c, hw,
                                           cg, k, stages, lanes, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) gn_fwd_cluster(GN_CLUSTER_ARGS) {
  cluster_body<T, false, VEC>(x, g, gamma, beta, out, mean, rstd, part, ngroups, c, hw, cg, sl, eps);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) gn_bwd_cluster(GN_CLUSTER_ARGS) {
  cluster_body<T, true, VEC>(x, g, gamma, beta, out, mean, rstd, part, ngroups, c, hw, cg, sl, eps);
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

// ------------------------------------------------------------ the plan ---- //

enum Instance { kResident = 0, kCluster = 1, kStreamed = 2 };
constexpr long long kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

// ops/groupnorm_swish.py:GnPlan, field for field
struct Plan {
  int instance, span, stages, cluster, splits, lanes, smem;
};

int slice_len(int L, int n) { return ((L + n - 1) / n + 7) / 8 * 8; }

// the dynamic shared memory the plan's kernel uses, as gn_swish_plan counts it
long long plan_smem(const Plan& p, int L, int el, bool bwd) {
  const int nbuf = bwd ? 2 : 1;
  if (p.instance == kResident) return kHeader + (long long)p.stages * p.span * L * el * nbuf;
  if (p.instance == kCluster) return kHeader + (long long)slice_len(L, p.cluster) * el * nbuf;
  return 0;
}

bool bad_plan(const Plan& p, int cg, int hw, int el, bool bwd) {
  const int L = cg * hw;
  if (p.instance == kStreamed) return p.splits < 1;
  if (p.instance != kResident && p.instance != kCluster) return true;
  if (p.smem != plan_smem(p, L, el, bwd) || p.smem > kMaxSmem) return true;
  if (p.instance == kResident) {
    return p.span < 1 || p.stages < 1 || p.stages > kMaxStages ||
           ((long long)p.span * L * el) % 16 != 0 ||
           (p.lanes != 8 && p.lanes != 16 && p.lanes != 32 && p.lanes != kThreads) ||
           (p.lanes == kThreads && cg > kMaxCg);
  }
  return p.cluster < 1 || p.cluster > kMaxCluster || cg > kMaxCg;
}

// ------------------------------------------------------------- launches ---- //

template <typename T, bool BWD, int VEC, bool ROWS>
int launch_resident(const T* x, const T* g, const float* gamma, const float* beta, T* out,
                    float* mean, float* rstd, float* part, int b, int c, int hw, int groups,
                    const Plan& p, float eps, cudaStream_t st) {
  const bool block = p.lanes == kThreads;
  auto kernel = BWD ? (block ? &gn_bwd_resident<T, true, VEC, ROWS>
                            : &gn_bwd_resident<T, false, VEC, ROWS>)
                    : (block ? &gn_fwd_resident<T, true, VEC, ROWS>
                             : &gn_fwd_resident<T, false, VEC, ROWS>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid: every block resident at once (registers and shared
  // memory both counted), no more blocks than spans
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kResidentThreads, p.smem)) !=
          cudaSuccess) {
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long spans = ((long long)b * groups + p.span - 1) / p.span;
  const unsigned blocks = (unsigned)(spans < (long long)per_sm * sms ? spans : (long long)per_sm * sms);
  kernel<<<blocks, kResidentThreads, p.smem, st>>>(x, g, gamma, beta, out, mean, rstd, part, b * groups, c,
                                                   hw, c / groups, p.span, p.stages, p.lanes, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool BWD, int VEC>
int launch_cluster(const T* x, const T* g, const float* gamma, const float* beta, T* out,
                   float* mean, float* rstd, float* part, int b, int c, int hw, int groups,
                   const Plan& p, float eps, cudaStream_t st) {
  const int cg = c / groups;
  auto kernel = BWD ? &gn_bwd_cluster<T, VEC> : &gn_fwd_cluster<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.cluster * b * groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, g, gamma, beta, out, mean, rstd, part, b * groups, c, hw,
                           cg, slice_len(cg * hw, p.cluster), eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the widest access (in elements, at most 16 bytes and at most h w) that
// tiles every group of L elements
template <typename T>
int pick_group_vec(int L, int hw) {
  for (int v = 16 / (int)sizeof(T); v > 1; v >>= 1) {
    if (L % v == 0 && v <= hw) return v;
  }
  return 1;
}

// the resident launch at the widest access that tiles a group (row by row
// where that access also tiles a row), or the cluster launch at the widest
// that tiles a row
template <typename T, bool BWD>
int launch_on_chip(const T* x, const T* g, const float* gamma, const float* beta, T* out,
                   float* mean, float* rstd, float* part, int b, int c, int hw, int groups,
                   const Plan& p, float eps, cudaStream_t st) {
  const int vec = p.instance == kResident ? pick_group_vec<T>(hw * (c / groups), hw) : pick_vec<T>(hw);
  const bool rows = hw % vec == 0;
#define GN_LAUNCH(V)                                                                             \
  if (p.instance == kCluster) {                                                                  \
    return launch_cluster<T, BWD, V>(x, g, gamma, beta, out, mean, rstd, part, b, c, hw, groups, \
                                     p, eps, st);                                                \
  }                                                                                              \
  return rows ? launch_resident<T, BWD, V, true>(x, g, gamma, beta, out, mean, rstd, part, b, c, \
                                                 hw, groups, p, eps, st)                         \
              : launch_resident<T, BWD, V, false>(x, g, gamma, beta, out, mean, rstd, part, b,   \
                                                  c, hw, groups, p, eps, st)
  switch (vec) {
    case 8: GN_LAUNCH(cap16<T>(8));
    case 4: GN_LAUNCH(4);
    case 2: GN_LAUNCH(2);
    default: GN_LAUNCH(1);
  }
#undef GN_LAUNCH
}

// --------------------------------------------------------------- streamed ---- //

template <typename T, int VEC>
int streamed_fwd(const T* x, const float* gamma, const float* beta, T* y, float* mean, float* rstd,
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
int streamed_bwd(const T* x, const T* g, const float* gamma, const float* beta, const float* mean,
                 const float* rstd, T* dx, float* dgamma, float* dbeta, float* ws, int b, int c,
                 int hw, int groups, int splits, cudaStream_t st) {
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

// --------------------------------------------------------------- entries ---- //

template <typename T>
int fwd_any(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
            void* ws, int b, int c, int hw, int groups, const Plan& p, float eps, void* stream) {
  if (bad_shape(b, c, hw, groups, p.instance == kStreamed ? p.splits : 1) ||
      bad_plan(p, c / groups, hw, (int)sizeof(T), false)) {
    return (int)cudaErrorInvalidValue;
  }
  const T* xp = static_cast<const T*>(x);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  float* wp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.instance != kStreamed) {
    return launch_on_chip<T, false>(xp, nullptr, ga, be, yp, mp, rp, nullptr, b, c, hw, groups, p, eps, st);
  }
  const int s = p.splits;
  switch (pick_vec<T>(hw)) {
    case 8: return streamed_fwd<T, cap16<T>(8)>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, s, eps, st);
    case 4: return streamed_fwd<T, 4>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, s, eps, st);
    case 2: return streamed_fwd<T, 2>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, s, eps, st);
    default: return streamed_fwd<T, 1>(xp, ga, be, yp, mp, rp, wp, b, c, hw, groups, s, eps, st);
  }
}

template <typename T>
int bwd_any(const void* x, const void* g, const void* gamma, const void* beta, const void* mean,
            const void* rstd, void* dx, void* dgamma, void* dbeta, void* ws, int b, int c, int hw,
            int groups, const Plan& p, void* stream) {
  if (bad_shape(b, c, hw, groups, p.instance == kStreamed ? p.splits : 1) ||
      bad_plan(p, c / groups, hw, (int)sizeof(T), true)) {
    return (int)cudaErrorInvalidValue;
  }
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* mp = static_cast<float*>(const_cast<void*>(mean));
  float* rp = static_cast<float*>(const_cast<void*>(rstd));
  T* dxp = static_cast<T*>(dx);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* wp = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.instance == kResident || p.instance == kCluster) {
    // launch 1: dx and the (c, 2, b) per-channel sums; launch 2: their sums
    // over the batch, one block a channel
    const int err = launch_on_chip<T, true>(xp, gp, ga, be, dxp, mp, rp, wp, b, c, hw, groups, p, 0.0f, st);
    if (err != 0) return err;
    gn_bwd_params<<<c, kThreads, 0, st>>>(wp, dg, db, b);
    return (int)cudaGetLastError();
  }
  const int s = p.splits;
  switch (pick_vec<T>(hw)) {
    case 8: return streamed_bwd<T, cap16<T>(8)>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, s, st);
    case 4: return streamed_bwd<T, 4>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, s, st);
    case 2: return streamed_bwd<T, 2>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, s, st);
    default: return streamed_bwd<T, 1>(xp, gp, ga, be, mp, rp, dxp, dg, db, wp, b, c, hw, groups, s, st);
  }
}

}  // namespace

#define PLAN_ARGS int instance, int span, int stages, int cluster, int splits, int lanes, int smem
#define PLAN Plan{instance, span, stages, cluster, splits, lanes, smem}

extern "C" int medvae_gn_swish_fwd_bf16(const void* x, const void* gamma, const void* beta,
                                        void* y, void* mean, void* rstd, void* ws, int b, int c,
                                        int hw, int groups, PLAN_ARGS, float eps, void* stream) {
  return fwd_any<bf16>(x, gamma, beta, y, mean, rstd, ws, b, c, hw, groups, PLAN, eps, stream);
}

extern "C" int medvae_gn_swish_fwd_f32(const void* x, const void* gamma, const void* beta,
                                       void* y, void* mean, void* rstd, void* ws, int b, int c,
                                       int hw, int groups, PLAN_ARGS, float eps, void* stream) {
  return fwd_any<float>(x, gamma, beta, y, mean, rstd, ws, b, c, hw, groups, PLAN, eps, stream);
}

extern "C" int medvae_gn_swish_bwd_bf16(const void* x, const void* g, const void* gamma,
                                        const void* beta, const void* mean, const void* rstd,
                                        void* dx, void* dgamma, void* dbeta, void* ws, int b,
                                        int c, int hw, int groups, PLAN_ARGS, void* stream) {
  return bwd_any<bf16>(x, g, gamma, beta, mean, rstd, dx, dgamma, dbeta, ws, b, c, hw, groups, PLAN,
                       stream);
}

extern "C" int medvae_gn_swish_bwd_f32(const void* x, const void* g, const void* gamma,
                                       const void* beta, const void* mean, const void* rstd,
                                       void* dx, void* dgamma, void* dbeta, void* ws, int b,
                                       int c, int hw, int groups, PLAN_ARGS, void* stream) {
  return bwd_any<float>(x, g, gamma, beta, mean, rstd, dx, dgamma, dbeta, ws, b, c, hw, groups, PLAN,
                        stream);
}
