// Fused Adam / AdamW for Hopper (sm_90a): the clip's global norm and the
// update of every parameter, each a few multi-tensor launches.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax's chain
// (zero_nans -> clip_by_global_norm -> adam / adamw), which XLA fuses on the
// TPU. The port's plain chain (medvae_tpu_torch/train/optim.py:
// Optimizer.apply, then the step's p += u * lr_scale) issues ~27 elementwise
// PyTorch launches a tensor, each a full fp32 pass. These kernels compute the
// same numbers:
//
//   adamw_sumsq_kernel  one fp64 partial sum of g^2 a block (NaN read as 0,
//                       as zero_nans leaves it; +-inf stays) into a workspace;
//   adamw_norm_kernel   one block: the partials summed in a fixed order, the
//                       sqrt written to a 0-d fp32 tensor. No atomics, so two
//                       runs give the same bits;
//   adamw_update_kernel reads g, m, v, p once and writes m, v, p once:
//                         g = isnan(g) ? 0 : g
//                         g = norm < clip ? g : (g / norm) * clip
//                         m = (1 - b1) g + b1 m
//                         v = (1 - b2) g^2 + b2 v
//                         u = (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd p for AdamW]
//                         p = p + (u * neg_lr) * lr_scale
//                       Every product, quotient, sum and root is a _rn
//                       intrinsic, so nvcc contracts nothing into an FMA and
//                       each operation rounds as PyTorch's separate fp32
//                       kernels round it: given the same norm, m, v and p
//                       equal the plain chain's bit for bit. neg_lr, bc1, bc2,
//                       lr_scale and the norm are read from device memory, so
//                       the host reads nothing while an update runs.
//
// Bound: bytes (a few operations an element). The least a step moves is
// 32 B a parameter: the norm reads g (4 B), the update reads g, m, v, p and
// writes m, v, p (28 B). For the 224^2 GAN's 906.3 M + 2.8 M params that is
// 29 GB, 8.7 ms at 3.35 TB/s.
//
// Design: a launch covers up to kMaxTensors tensors whose pointers, sizes and
// first blocks travel in the launch's arguments (`Table`, under 4 KB), so a
// CUDA graph captures a launch whole and nothing is copied from the host. A
// tensor is cut into chunks of kChunk elements, one block a chunk; a block
// finds its tensor by a binary search of the table's first blocks. G's 250
// tensors take four launches of each kernel, the 180 that hold under 64 K
// params a block each. Inside a chunk a block walks 16-byte vectors, two a
// thread an iteration, and the last (< 4) elements one at a time; a tensor
// whose four pointers are not all 16-byte aligned is walked one element at a
// time. Chunks start at multiples of kChunk, so an aligned tensor stays
// aligned in every chunk.

#include "hopper.cuh"

namespace {

constexpr int kMaxTensors = 64;  // tensors a launch: the table is a kernel argument (< 4 KB)
constexpr long long kChunk = 65536;  // elements a block
constexpr int kThreads = 256;
constexpr int kNormThreads = 1024;

struct Table {
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* p[kMaxTensors];
  long long n[kMaxTensors];
  int first[kMaxTensors + 1];  // the first block of each tensor; first[count] = the blocks
  int count;
};
static_assert(sizeof(Table) < 4000, "a launch's table must fit the 4 KB of kernel arguments");

// The scalars of an update: the Python-float constants as fp32 (formed in
// double on the host and cast, as PyTorch casts a Python scalar operand) and
// the device scalars the step fills before it runs.
struct Hyper {
  float clip, c1, b1, c2, b2, eps, wd;
  const float* norm;  // null without the clip
  const float* neg_lr;
  const float* bc1;
  const float* bc2;
  const float* lr_scale;
};

__device__ __forceinline__ int tensor_of(const Table& t, int block) {
  int lo = 0, hi = t.count;  // first[lo] <= block < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.first[mid] <= block) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

__device__ __forceinline__ double square0(float x) {
  const double y = isnan(x) ? 0.0 : (double)x;
  return y * y;
}

// The block's threads' values summed in a fixed order (warp shuffles, then
// warp 0 over the warps' sums); the result is thread 0's.
template <int kBlock>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = x;
  __syncthreads();
  x = lane < kBlock / 32 ? warps[lane] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) adamw_sumsq_kernel(const Table t, double* partials) {
  const int block = blockIdx.x;
  const int i = tensor_of(t, block);
  const long long lo = (long long)(block - t.first[i]) * kChunk;
  const long long hi = lo + kChunk < t.n[i] ? lo + kChunk : t.n[i];
  const float* g = t.g[i];
  double acc = 0.0;
  long long tail = lo;
  if (aligned16(g)) {
    const float4* g4 = reinterpret_cast<const float4*>(g + lo);
    const int nv = (int)((hi - lo) >> 2);
#pragma unroll 4
    for (int k = threadIdx.x; k < nv; k += kThreads) {
      const float4 x = __ldcs(g4 + k);
      acc += square0(x.x) + square0(x.y) + square0(x.z) + square0(x.w);
    }
    tail = lo + 4LL * nv;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) acc += square0(g[e]);
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[block] = acc;
}

__global__ void __launch_bounds__(kNormThreads) adamw_norm_kernel(const double* partials, int count,
                                                                  float* norm) {
  double acc = 0.0;
  for (int k = threadIdx.x; k < count; k += kNormThreads) acc += partials[k];
  acc = block_sum<kNormThreads>(acc);
  if (threadIdx.x == 0) *norm = (float)sqrt(acc);
}

struct Scalars {
  float clip, c1, b1, c2, b2, eps, wd, norm, neg_lr, bc1, bc2, lr_scale;
  bool keep;
};

template <bool kClip, bool kDecay>
__device__ __forceinline__ void update(float g, float& m, float& v, float& p, const Scalars& s) {
  g = isnan(g) ? 0.0f : g;
  if (kClip && !s.keep) g = __fmul_rn(__fdiv_rn(g, s.norm), s.clip);
  m = __fadd_rn(__fmul_rn(s.c1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.c2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (kDecay) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fadd_rn(p, __fmul_rn(__fmul_rn(u, s.neg_lr), s.lr_scale));
}

template <bool kClip, bool kDecay>
__device__ __forceinline__ void update4(const float4 g, float4& m, float4& v, float4& p, const Scalars& s) {
  update<kClip, kDecay>(g.x, m.x, v.x, p.x, s);
  update<kClip, kDecay>(g.y, m.y, v.y, p.y, s);
  update<kClip, kDecay>(g.z, m.z, v.z, p.z, s);
  update<kClip, kDecay>(g.w, m.w, v.w, p.w, s);
}

template <bool kClip, bool kDecay>
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(const Table t, const Hyper h) {
  const int block = blockIdx.x;
  const int i = tensor_of(t, block);
  const long long lo = (long long)(block - t.first[i]) * kChunk;
  const long long hi = lo + kChunk < t.n[i] ? lo + kChunk : t.n[i];
  Scalars s;
  s.clip = h.clip, s.c1 = h.c1, s.b1 = h.b1, s.c2 = h.c2, s.b2 = h.b2, s.eps = h.eps, s.wd = h.wd;
  s.norm = kClip ? *h.norm : 0.0f;
  s.keep = kClip ? s.norm < s.clip : true;
  s.neg_lr = *h.neg_lr, s.bc1 = *h.bc1, s.bc2 = *h.bc2, s.lr_scale = *h.lr_scale;
  const float* g = t.g[i];
  float* m = t.m[i];
  float* v = t.v[i];
  float* p = t.p[i];
  long long tail = lo;
  if (aligned16(g) && aligned16(m) && aligned16(v) && aligned16(p)) {
    const float4* g4 = reinterpret_cast<const float4*>(g + lo);
    float4* m4 = reinterpret_cast<float4*>(m + lo);
    float4* v4 = reinterpret_cast<float4*>(v + lo);
    float4* p4 = reinterpret_cast<float4*>(p + lo);
    const int nv = (int)((hi - lo) >> 2);
    int k = threadIdx.x;
    for (; k + kThreads < nv; k += 2 * kThreads) {  // two vectors a thread: eight loads in flight
      const int k2 = k + kThreads;
      const float4 ga = __ldcs(g4 + k), gb = __ldcs(g4 + k2);
      float4 ma = m4[k], mb = m4[k2], va = v4[k], vb = v4[k2], pa = p4[k], pb = p4[k2];
      update4<kClip, kDecay>(ga, ma, va, pa, s);
      update4<kClip, kDecay>(gb, mb, vb, pb, s);
      m4[k] = ma, m4[k2] = mb, v4[k] = va, v4[k2] = vb, p4[k] = pa, p4[k2] = pb;
    }
    if (k < nv) {
      float4 mk = m4[k], vk = v4[k], pk = p4[k];
      update4<kClip, kDecay>(__ldcs(g4 + k), mk, vk, pk, s);
      m4[k] = mk, v4[k] = vk, p4[k] = pk;
    }
    tail = lo + 4LL * nv;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    float me = m[e], ve = v[e], pe = p[e];
    update<kClip, kDecay>(g[e], me, ve, pe, s);
    m[e] = me, v[e] = ve, p[e] = pe;
  }
}

// The table of `count` tensors (1..kMaxTensors, each of >= 1 element); its
// blocks in *blocks. m, v, p may be null (the norm's launches).
int fill_table(Table* t, const void* const* g, void* const* m, void* const* v, void* const* p,
               const long long* n, int count, const char* launcher, int* blocks) {
  if (count < 1 || count > kMaxTensors) {
    return fail((int)cudaErrorInvalidValue, "%s: %d tensors in one launch (1 to %d)", launcher, count,
                kMaxTensors);
  }
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 1) return fail((int)cudaErrorInvalidValue, "%s: tensor %d has %lld elements", launcher, i, n[i]);
    t->g[i] = static_cast<const float*>(g[i]);
    t->m[i] = m ? static_cast<float*>(m[i]) : nullptr;
    t->v[i] = v ? static_cast<float*>(v[i]) : nullptr;
    t->p[i] = p ? static_cast<float*>(p[i]) : nullptr;
    t->n[i] = n[i];
    t->first[i] = (int)total;
    total += (n[i] + kChunk - 1) / kChunk;
    if (total > 0x7fffffffLL) return fail((int)cudaErrorInvalidValue, "%s: over 2^31 blocks", launcher);
  }
  t->first[count] = (int)total;
  t->count = count;
  *blocks = (int)total;
  return 0;
}

}  // namespace

// One adamw_sumsq launch over `count` tensors: a partial a block into
// partials[0 .. blocks).
extern "C" int medvae_adamw_sumsq(const void* const* g, const long long* n, int count, void* partials,
                                  void* stream) {
  int err = check_no_pending_error("medvae_adamw_sumsq");
  if (err != 0) return err;
  Table t;
  int blocks = 0;
  err = fill_table(&t, g, nullptr, nullptr, nullptr, n, count, "medvae_adamw_sumsq", &blocks);
  if (err != 0) return err;
  adamw_sumsq_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t, static_cast<double*>(partials));
  return launch_status("adamw_sumsq_kernel");
}

// The adamw_norm launch: sqrt of the sum of partials[0 .. count) into *norm.
extern "C" int medvae_adamw_norm(const void* partials, int count, void* norm, void* stream) {
  const int err = check_no_pending_error("medvae_adamw_norm");
  if (err != 0) return err;
  if (count < 1) return fail((int)cudaErrorInvalidValue, "medvae_adamw_norm: %d partials", count);
  adamw_norm_kernel<<<1, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), count, static_cast<float*>(norm));
  return launch_status("adamw_norm_kernel");
}

// One adamw_update launch over `count` tensors; `norm` null without the clip,
// `decay` nonzero for AdamW.
extern "C" int medvae_adamw_update(const void* const* g, void* const* m, void* const* v, void* const* p,
                                   const long long* n, int count, const void* norm, float clip, float c1,
                                   float b1, float c2, float b2, float eps, float wd, int decay,
                                   const void* neg_lr, const void* bc1, const void* bc2,
                                   const void* lr_scale, void* stream) {
  int err = check_no_pending_error("medvae_adamw_update");
  if (err != 0) return err;
  Table t;
  int blocks = 0;
  err = fill_table(&t, g, m, v, p, n, count, "medvae_adamw_update", &blocks);
  if (err != 0) return err;
  const Hyper h{clip, c1, b1, c2, b2, eps, wd, static_cast<const float*>(norm),
                static_cast<const float*>(neg_lr), static_cast<const float*>(bc1),
                static_cast<const float*>(bc2), static_cast<const float*>(lr_scale)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (norm != nullptr && decay) {
    adamw_update_kernel<true, true><<<blocks, kThreads, 0, st>>>(t, h);
  } else if (norm != nullptr) {
    adamw_update_kernel<true, false><<<blocks, kThreads, 0, st>>>(t, h);
  } else if (decay) {
    adamw_update_kernel<false, true><<<blocks, kThreads, 0, st>>>(t, h);
  } else {
    adamw_update_kernel<false, false><<<blocks, kThreads, 0, st>>>(t, h);
  }
  return launch_status("adamw_update_kernel");
}
