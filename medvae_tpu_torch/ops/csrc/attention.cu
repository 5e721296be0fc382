// Whole-sequence single-head attention for Hopper (sm_90a): forward B4 and
// backward B5.
//
// Replaces the Pallas TPU kernels of medvae_tpu/ops/attention.py:
//   B4 _attention_fwd_kernel: O = softmax(Q K^T c^-1/2) V,
//   B5 _attention_bwd_kernel: recompute P, then dV = P^T G, dP = G V^T,
//      dS = P o (dP - rowsum(dP o P)), dQ = dS K c^-1/2, dK = dS^T Q c^-1/2,
// for q, k, v, g and the outputs of shape (b, n, c), contiguous, bf16 or fp32.
// Every product keeps fp32 fidelity and the softmax is fp32, as on the TPU: the
// softmax is the exact two-pass one of the TPU kernel (row max, exp, row sum,
// divide; no online rescale), only the outputs are rounded to the input type,
// and P and dS are never rounded once to bf16 (the FMA instance keeps them
// fp32, the Hopper instance splits each into three bf16 terms).
//
// Bound: B4 needs 4 b n^2 c operations (two n x n x c products) and moves 4 b n
// c elements; B5 needs 10 b n^2 c and moves 7 b n c. At the 128^2 BaseVAE's
// shape (b 64, n 256, c 1024, bf16) that is 1.7e10 and 4.3e10 operations
// against 134 and 235 MB.
//
// Two instances; the bf16 launchers pick one by (n, c) alone, with no
// try-and-fall-back (medvae_attention_bf16_instance says which):
//  * bf16 with c % 64 == 0 and n <= 256 (every shape of the main path): the
//    Hopper instance, wgmma on TMA-fed tiles (its own comment below). Q K^T
//    and G V^T have two bf16 operands, so the tensor cores form them exactly
//    with fp32 sums. The products with the fp32 P or dS keep fp32 fidelity by
//    the three-term split P = t0 + t1 + t2 (t_i bf16): three wgmmas into one
//    fp32 accumulator, each against the exact bf16 V, G, K or Q. 3xTF32 would
//    also take three products, at half the bf16 rate; the bf16 terms are A
//    fragments straight from the fp32 accumulator's registers, where TF32
//    would need 32-bit fragments. Counted that way B4 does 8 and B5 22 b n^2
//    c operations at the bf16 rate: 0.035 and 0.096 ms at the main shape,
//    against 0.040 and 0.070 ms of bytes.
//  * every other shape, and fp32: the first design, every product a
//    register-blocked fp32 FMA tile at the fp32 rate (67 TFLOP/s), loads
//    synchronous. B4 0.6 ms and B5 2.5 ms at the main shape.
//
// The FMA instance:
//  * the (n, n) matrices never leave shared memory, every product is an fp32
//    FMA tile (4 rows x 8 columns a thread, operands read from shared memory
//    as float4, global loads 16 bytes wide where c allows);
//  * B4: one block per (BM = 32 query rows, batch element). Pass 1 forms the
//    block's scaled logits against all n keys, streaming Q and K through shared
//    memory in 16-channel chunks, and keeps them transposed, W[key][row], for the
//    whole sequence (n x 36 floats: 37 KB at n = 256, 124 KB at n = 863). Pass 2
//    takes the softmax of each row in place. Pass 3 streams V in 16-key chunks
//    and forms O, 256 channels at a time, so c is unbounded.
//  * B5, two kernels, no atomics, so a call is bitwise repeatable:
//    (a) per BM query rows (32 where two (n, 36) fp32 buffers fit in shared
//        memory, n <= 736, else 16): P and dP for the rows against all keys in
//        shared memory, delta_i = sum_j dP o P, dS in place of dP, then dQ; it
//        writes each row's max, sum and delta to a (3, b, n) fp32 scratch;
//    (b) per BM keys: P^T and dP^T of the keys against all queries,
//        recomputed with the same arithmetic as (a), so P is bitwise the same,
//        dS^T from the saved rows, then dV and dK over all queries.
//  * Any n up to what shared memory holds (n <= 1,328: B5's two (n, 20) fp32
//    buffers and tiles in 227 KB) and any c:
//    ragged tails of rows, keys and channels are zero-filled on load, masked in
//    the softmax and not stored.
//
// C interface (bound with ctypes; each launcher returns 0, a cudaError_t of its
// own calls, or one of hopper.cuh's kErr* codes, and names the failure in
// medvae_last_failure(); `scratch` is a buffer of
// medvae_attention_bwd_scratch_bytes the caller allocates):
//   int medvae_attention_max_tokens()   the largest n the launchers take
//   int medvae_attention_bf16_instance(n, c)   1: Hopper instance, 0: FMA
//   long long medvae_attention_bwd_scratch_bytes(b, n, c, is_bf16)
//   int medvae_attention_fwd_bf16(q, k, v, o, b, n, c, scale, stream)
//   int medvae_attention_fwd_f32 (q, k, v, o, b, n, c, scale, stream)
//   int medvae_attention_bwd_bf16(q, k, v, g, dq, dk, dv, scratch, b, n, c, scale, stream)
//   int medvae_attention_bwd_f32 (q, k, v, g, dq, dk, dv, scratch, b, n, c, scale, stream)
//   int medvae_attention_{fwd,bwd}_bf16_fma(...)   the FMA instance at any shape
//   int medvae_attention_wgmma_selftest(x, y, z, s, o_k, o_t, o_r, stream)
//   const char* medvae_last_failure()   the last failure on this thread, in words

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // descriptors, mbarriers, TMA, the wgmma products

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 16;        // contraction chunk: channels in pass 1, keys in pass 3
constexpr int BN = 256;       // columns a pass forms: keys in pass 1, channels in pass 3
constexpr int LDT = BN + 4;   // row stride of the B tile
constexpr int kMaxSmem = 232448;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Threads of a block of BM rows: BM / 4 warps, each warp owning 4 rows, each
// lane 8 columns (lane * 4 + {0..3} and 128 + lane * 4 + {0..3}).
template <int BM> __host__ __device__ constexpr int threads() { return BM / 4 * 32; }
// row stride of the (n_pad, BM) transposed buffers: float4-aligned
template <int BM> __host__ __device__ constexpr int ldw() { return BM + 4; }

__host__ __device__ inline int pad16(int n) { return (n + BK - 1) / BK * BK; }

// x[0..V) = src[r][col .. col + V) widened to fp32 (V = 16 bytes of T), zero
// where r >= n or a column >= c: one 16-byte load when `vec` (c a multiple of V,
// so a run is wholly inside the row or wholly past it), else V scalar loads.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ src, int r, int col, int n, int c,
                                         bool vec, float* x) {
  constexpr int V = 16 / sizeof(T);
  const T* p = src + (size_t)r * c + col;
  if (vec && r < n && col < c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      x[0] = __uint_as_float(raw.x);
      x[1] = __uint_as_float(raw.y);
      x[2] = __uint_as_float(raw.z);
      x[3] = __uint_as_float(raw.w);
    } else {
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[2 * u] = __uint_as_float(w[u] << 16);
        x[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < V; ++u) x[u] = (r < n && col + u < c) ? to_f(p[u]) : 0.f;
}

template <int BM>
size_t smem_bytes(int n, int buffers) {
  return ((size_t)BK * ldw<BM>() + (size_t)BK * LDT + (size_t)buffers * pad16(n) * ldw<BM>()) *
         sizeof(float);
}

// out[j][i] = scale * sum_t A[row0 + i][t] * B[j][t] for the block's BM rows i of A
// and all n rows j of B; out is (n_pad, ldw) in shared memory. Each element is
// one thread's fmaf chain over t = 0, 1, ..., c - 1, so the same pair of rows
// gives the same bits whichever of the two is A.
template <int BM, typename T>
__device__ void scores(const T* __restrict__ A, const T* __restrict__ B, int n, int c, int row0,
                       float scale, float* out, float* tA, float* tB) {
  constexpr int NT = threads<BM>();
  constexpr int LDW = ldw<BM>();
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0;
  for (int j0 = 0; j0 < n; j0 += BN) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int k0 = 0; k0 < c; k0 += BK) {
      __syncthreads();  // the tiles' previous readers are done
      for (int e = tid; e < BM * (BK / V); e += NT) {
        const int i = e / (BK / V), t0 = e % (BK / V) * V;
        float x[V];
        load_run(A, row0 + i, k0 + t0, n, c, vec, x);
#pragma unroll
        for (int u = 0; u < V; ++u) tA[(t0 + u) * LDW + i] = x[u];
      }
      for (int e = tid; e < BN * (BK / V); e += NT) {
        const int j = e / (BK / V), t0 = e % (BK / V) * V;
        float x[V];
        load_run(B, j0 + j, k0 + t0, n, c, vec, x);
#pragma unroll
        for (int u = 0; u < V; ++u) tB[(t0 + u) * LDT + j] = x[u];
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < BK; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(tA + t * LDW + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(tB + t * LDT + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(tB + t * LDT + 128 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + (q >> 2) * 128 + tx * 4 + (q & 3);
      if (j < n) {
        *reinterpret_cast<float4*>(out + (size_t)j * LDW + ty * 4) =
            make_float4(acc[0][q] * scale, acc[1][q] * scale, acc[2][q] * scale,
                        acc[3][q] * scale);
      }
    }
  }
  __syncthreads();
}

// out[row0 + i][col] = scale * sum_j W[j][i] * B[j][col] for the block's BM rows
// and all c columns, W (n_pad, ldw) in shared memory with zeros past row n.
template <int BM, typename T>
__device__ void weighted_sum(const float* W, const T* __restrict__ B, int n, int c, int row0,
                             float scale, T* __restrict__ out, float* tB) {
  constexpr int NT = threads<BM>();
  constexpr int LDW = ldw<BM>();
  const int tid = threadIdx.x;
  const int ty = tid >> 5;
  const int tx = tid & 31;
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0;
  for (int c0 = 0; c0 < c; c0 += BN) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int j0 = 0; j0 < n; j0 += BK) {
      __syncthreads();
      for (int e = tid; e < BK * (BN / V); e += NT) {
        const int jj = e / (BN / V), cc = e % (BN / V) * V;
        float x[V];
        load_run(B, j0 + jj, c0 + cc, n, c, vec, x);
#pragma unroll
        for (int u = 0; u < V; u += 4) {
          *reinterpret_cast<float4*>(tB + jj * LDT + cc + u) =
              make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < BK; ++jj) {
        const float4 a = *reinterpret_cast<const float4*>(W + (size_t)(j0 + jj) * LDW + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(tB + jj * LDT + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(tB + jj * LDT + 128 + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + ty * 4 + r;
      if (row >= n) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = c0 + (q >> 2) * 128 + tx * 4 + (q & 3);
        if (col < c) out[(size_t)row * c + col] = from_f<T>(acc[r][q] * scale);
      }
    }
  }
}

// The softmax of each of the block's rows i over the n logits W[.][i], in place,
// as the TPU kernel takes it: subtract the row max, exp, divide by the row sum.
// Rows n..n_pad of W are zeroed. With `stats`, row max and sum go to
// stats[0][row0 + i] and stats[1][row0 + i] (b-th batch slice already applied).
template <int BM>
__device__ void softmax_rows(float* W, int n, int row0, float* stats_m, float* stats_l) {
  constexpr int LDW = ldw<BM>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = pad16(n);
  for (int i = warp; i < BM; i += BM / 4) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, W[j * LDW + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(W[j * LDW + i] - m);
      W[j * LDW + i] = p;
      l += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    for (int j = lane; j < np; j += 32) W[j * LDW + i] = j < n ? W[j * LDW + i] / l : 0.f;
    if (stats_m != nullptr && lane == 0 && row0 + i < n) {
      stats_m[row0 + i] = m;
      stats_l[row0 + i] = l;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- B4 ---- //

template <typename T>
__global__ void __launch_bounds__(threads<32>())
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int n, int c, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 32;
  float* tA = smem;
  float* tB = tA + BK * ldw<BM>();
  float* W = tB + BK * LDT;
  const size_t base = (size_t)blockIdx.y * n * c;
  const int row0 = blockIdx.x * BM;
  scores<BM>(q + base, k + base, n, c, row0, scale, W, tA, tB);
  softmax_rows<BM>(W, n, row0, nullptr, nullptr);
  weighted_sum<BM>(W, v + base, n, c, row0, 1.0f, o + base, tB);
}

// ---------------------------------------------------------------- B5 ---- //

// (a) per BM query rows: dQ, and each row's max, sum and delta.
template <int BM, typename T>
__global__ void __launch_bounds__(threads<BM>())
attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                          float* __restrict__ stats, int b, int n, int c, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDW = ldw<BM>();
  float* tA = smem;
  float* tB = tA + BK * LDW;
  float* P = tB + BK * LDT;
  float* D = P + (size_t)pad16(n) * LDW;
  const size_t base = (size_t)blockIdx.y * n * c;
  float* st_m = stats + (size_t)blockIdx.y * n;
  float* st_l = st_m + (size_t)b * n;
  float* st_d = st_l + (size_t)b * n;
  const int row0 = blockIdx.x * BM;
  scores<BM>(q + base, k + base, n, c, row0, scale, P, tA, tB);
  softmax_rows<BM>(P, n, row0, st_m, st_l);
  scores<BM>(g + base, v + base, n, c, row0, 1.0f, D, tA, tB);  // dP[j][i]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = pad16(n);
  for (int i = warp; i < BM; i += BM / 4) {
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) delta = fmaf(D[j * LDW + i], P[j * LDW + i], delta);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
    for (int j = lane; j < np; j += 32) {
      D[j * LDW + i] = j < n ? P[j * LDW + i] * (D[j * LDW + i] - delta) : 0.f;
    }
    if (lane == 0 && row0 + i < n) st_d[row0 + i] = delta;
  }
  __syncthreads();
  weighted_sum<BM>(D, k + base, n, c, row0, scale, dq + base, tB);
}

// (b) per BM keys: dK and dV over all queries, from the rows' saved statistics.
template <int BM, typename T>
__global__ void __launch_bounds__(threads<BM>())
attention_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dk,
                          T* __restrict__ dv, const float* __restrict__ stats, int b, int n, int c,
                          float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDW = ldw<BM>();
  float* tA = smem;
  float* tB = tA + BK * LDW;
  float* P = tB + BK * LDT;  // P[query][key]
  float* D = P + (size_t)pad16(n) * LDW;
  const size_t base = (size_t)blockIdx.y * n * c;
  const float* st_m = stats + (size_t)blockIdx.y * n;
  const float* st_l = st_m + (size_t)b * n;
  const float* st_d = st_l + (size_t)b * n;
  const int row0 = blockIdx.x * BM;
  const int np = pad16(n);
  scores<BM>(k + base, q + base, n, c, row0, scale, P, tA, tB);
  for (int e = threadIdx.x; e < np * BM; e += threads<BM>()) {
    const int j = e / BM, i = e % BM;
    P[j * LDW + i] = j < n ? expf(P[j * LDW + i] - st_m[j]) / st_l[j] : 0.f;
  }
  scores<BM>(v + base, g + base, n, c, row0, 1.0f, D, tA, tB);  // dP[query][key]
  for (int e = threadIdx.x; e < np * BM; e += threads<BM>()) {
    const int j = e / BM, i = e % BM;
    D[j * LDW + i] = j < n ? P[j * LDW + i] * (D[j * LDW + i] - st_d[j]) : 0.f;
  }
  __syncthreads();
  weighted_sum<BM>(P, g + base, n, c, row0, 1.0f, dv + base, tB);
  weighted_sum<BM>(D, q + base, n, c, row0, scale, dk + base, tB);
}

bool bad_shape(int b, int n, int c) {
  return b < 1 || b > 65535 || n < 1 || c < 1 || smem_bytes<16>(n, 2) > (size_t)kMaxSmem ||
         smem_bytes<32>(n, 1) > (size_t)kMaxSmem;
}

int max_tokens() {
  int n = 0;
  while (!bad_shape(1, n + 1, 1)) ++n;
  return n;
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int b, int n, int c,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<32>(n, 1);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return fail((int)err, "attention_fwd_kernel: cudaFuncSetAttribute: CUDA error %d", (int)err);
  attention_fwd_kernel<T><<<dim3((n + 31) / 32, b), threads<32>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, c, scale);
  return launch_status("attention_fwd_kernel");
}

template <int BM, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, void* stats, int b, int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(n, 2);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_kernel<BM, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attention_bwd_cols_kernel<BM, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  if (err != cudaSuccess) return fail((int)err, "attention_bwd kernels: cudaFuncSetAttribute: CUDA error %d", (int)err);
  const dim3 grid((n + BM - 1) / BM, b);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  float* st = static_cast<float*>(stats);
  attention_bwd_rows_kernel<BM, T><<<grid, threads<BM>(), smem, stream>>>(
      tq, tk, tv, tg, static_cast<T*>(dq), st, b, n, c, scale);
  if (int status = launch_status("attention_bwd_rows_kernel")) return status;
  attention_bwd_cols_kernel<BM, T><<<grid, threads<BM>(), smem, stream>>>(
      tq, tk, tv, tg, static_cast<T*>(dk), static_cast<T*>(dv), st, b, n, c, scale);
  return launch_status("attention_bwd_cols_kernel");
}

// B5 with 32-row blocks where their two (n, 36) buffers fit (n <= 736), else 16
template <typename T>
int launch_bwd_any(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                   void* dv, void* stats, int b, int n, int c, float scale, cudaStream_t stream) {
  if (smem_bytes<32>(n, 2) <= (size_t)kMaxSmem) {
    return launch_bwd<32, T>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale, stream);
  }
  return launch_bwd<16, T>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale, stream);
}

// ------------------------------------------------------------------------ //
// The Hopper instance: wgmma on TMA-fed tiles (bf16, c % 64 == 0, n <= 256) //
// ------------------------------------------------------------------------ //
//
// Both passes run a persistent grid, one block an SM, whose blocks walk
// their tiles with the ring running on from tile to tile, so that the next
// tile's loads overlap this tile's stores.
//
// Pass (a), a tile per (64 query rows, batch element), 384 threads: a
// producer warpgroup whose one thread issues every TMA load into a ring of
// three stages, and two consumer warpgroups; consumer w owns keys
// [128 w, 128 w + 128) of every row. Each stage holds one 64-channel chunk:
// a 64-row box of Q (or G) and a 256-row box of K (or V), rows at or past n
// zero-filled by the 3-D tensor maps.
//  * S = Q K^T: wgmma m64n128k16, both operands K-major in shared memory,
//    contracted over c chunk by chunk (64 fp32 registers a thread).
//  * The softmax of the TPU kernel on the accumulator layout: logits scaled
//    by c^-1/2, keys at or past n masked to -inf, the row max, exp, the row
//    sum, and P = p / l. A row's max and sum are combined across the two
//    consumers through shared memory, in a fixed order.
//  * B4 then forms O = P V in 64-channel chunks: P's three bf16 terms (split3
//    in hopper.cuh) are A fragments in registers (the m64n128 accumulator's
//    layout is the A fragment's), each consumer runs 3 x 8 wgmma m64n64k16 of
//    its 128 keys against V read as a transposed (MN-major) operand, and the
//    two partial tiles are added (consumer 0's + consumer 1's) through a
//    double-buffered shared tile. It writes nothing else.
//  * B5 instead writes P's three terms to a scratch, forms dP = G V^T the
//    way it formed S, delta_i = sum_j dP o P (combined like the row sum), dS
//    = P o (dP - delta), and writes dS's three terms.
// The scratch is (6, b, n, nkp) bf16, nkp = n rounded up to 64: planes 0-2
// hold P = t0 + t1 + t2 and planes 3-5 dS, each row's keys contiguous and
// zero past n. Six bytes an element against fp32's four, but each plane is a
// bf16 operand that TMA loads straight into wgmma's layout.
//
// Pass (b), a tile per (product, 64 output rows, 128 or 256 output columns,
// batch element), the same three warpgroups and a three-stage ring,
// contracts a 64-token chunk a stage: three 64 x 64 boxes of the scratch and
// the B operand's boxes of 64 tokens x 64 channels (MN-major):
//    dQ = dS K c^-1/2    A = dS, rows of the scratch read K-major;
//    dK = dS^T Q c^-1/2  A = dS^T: the same boxes read MN-major (transposed A);
//    dV = P^T G          A = P^T, likewise.
// Each consumer owns 64 or 128 of the columns and runs three wgmma
// m64n64k16 a k16 slice, one per term, into one fp32 accumulator.
// No atomics: every sum runs in a fixed order, so a call repeats bit for bit,
// and B4 and B5 form P with the same code, so their P is the same function of
// (q, k) bit for bit.

constexpr int kHRows = 64;                      // rows a block forms
constexpr int kHKeys = 256;                     // keys a row is formed against: n <= 256
constexpr int kHThreads = 384;                  // two consumer warpgroups and a producer
constexpr int kHStages = 3;
constexpr uint32_t kBox64 = 64 * 128;           // a 64-row, 64-channel bf16 box
constexpr uint32_t kBox256 = kHKeys * 128;      // a 256-row box
constexpr uint32_t kRowsStage = kBox64 + kBox256;
constexpr uint32_t kOExchange = 2 * 2 * 64 * 64 * 4;  // 2 buffers x 2 consumers of 64 x 64 fp32
constexpr uint32_t kReduce = 3 * 2 * 64 * 4;          // row max, sum, delta of both consumers

constexpr size_t rows_smem_bytes(bool fwd) {
  return 1024 + kHStages * kRowsStage + (fwd ? kOExchange : 0) + kReduce + 2 * kHStages * 8;
}

template <int NBW>
__host__ __device__ constexpr uint32_t cols_stage_bytes() { return 3 * kBox64 + 2 * NBW * kBox64; }

template <int NBW>
constexpr size_t cols_smem_bytes() { return 1024 + kHStages * cols_stage_bytes<NBW>() + 2 * kHStages * 8; }

using HRing = Ring<kHStages>;  // the ring of hopper.cuh

// pass (a)'s one chunked product: d(64 x 128 keys of consumer wg) = X Y^T over
// nch 64-channel stages starting at ring position *it.
__device__ __forceinline__ void rows_product(float* d, const HRing& ring, uint32_t stages, int nch,
                                             int wg, int* it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int ch = 0; ch < nch; ++ch, ++*it) {
    const int s = *it % kHStages;
    mbar_wait(ring.full(s), (*it / kHStages) & 1);
    const uint32_t x = stages + s * kRowsStage;
    const uint32_t y = x + kBox64 + wg * (128 * 128);
    fence_regs<64>(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_m64n128_ss(d, sw128_desc(x + 32 * k), sw128_desc(y + 32 * k));
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(ring.empty(s));
  }
  fence_regs<64>(d);
}

// Write the three bf16 terms of an m64n128 fp32 tile (rows r0 and r0 + 8 of
// the block, keys 128 wg + 8 j + 2 t4) to planes p0..p0+2 of the scratch.
__device__ __forceinline__ void store_terms(bf16* scratch, const float* x, int p0, int b, int batch,
                                            int n, int nkp, int row0, int key0) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int key = key0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      uint32_t t[3];
      split3(x[4 * j + 2 * h], x[4 * j + 2 * h + 1], t);
      if (row < n && key < nkp) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          *reinterpret_cast<uint32_t*>(scratch + (((size_t)(p0 + i) * b + batch) * n + row) * nkp + key) = t[i];
        }
      }
    }
  }
}

template <bool kFwd>
__global__ void __launch_bounds__(kHThreads, 1)
attention_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_g,
                            const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ out,
                            int b, int n, int c, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stages = (raw + 1023u) & ~1023u;
  const uint32_t ox = stages + kHStages * kRowsStage;
  const uint32_t red = ox + (kFwd ? kOExchange : 0);
  const HRing ring{red + kReduce};
  float* oxs = reinterpret_cast<float*>(smem_raw + (ox - raw));
  float* red_m = reinterpret_cast<float*>(smem_raw + (red - raw));
  float* red_l = red_m + 128;
  float* red_d = red_l + 128;
  const int nch = c / 64;
  const int row_tiles = (n + kHRows - 1) / kHRows;
  const int tiles = row_tiles * b;  // tile t: rows (t % row_tiles) * 64.., batch t / row_tiles
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t % row_tiles * kHRows;
        const int batch = t / row_tiles;
        auto issue = [&](const CUtensorMap* x, const CUtensorMap* y, int ch) {
          const int s = it % kHStages;
          mbar_wait(ring.empty(s), ((it / kHStages) & 1) ^ 1);
          const uint32_t dst = stages + s * kRowsStage;
          mbar_expect_tx(ring.full(s), (x != nullptr ? kBox64 : 0) + kBox256);
          if (x != nullptr) tma_load_3d(dst, x, ring.full(s), ch * 64, m0, batch);
          tma_load_3d(dst + kBox64, y, ring.full(s), ch * 64, 0, batch);
          ++it;
        };
        for (int ch = 0; ch < nch; ++ch) issue(&tm_q, &tm_k, ch);
        for (int ch = 0; ch < nch; ++ch) issue(kFwd ? nullptr : &tm_g, &tm_v, ch);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of the block
  const int key0 = wg * 128 + 2 * t4;           // and keys key0 + 8 j + {0, 1}
  int it = 0;
  // tiles need no barrier of their own: each shared buffer a tile writes is
  // rewritten only after a consumers_sync that both consumers reach after
  // their last read of it
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t % row_tiles * kHRows;
    const int batch = t / row_tiles;
    float s[64];
    rows_product(s, ring, stages, nch, wg, &it);
    // the softmax: row max, exp, row sum, divide
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = key0 + 8 * j + (e & 1) < n ? s[4 * j + e] * scale : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t4 == 0) {
      red_m[wg * 64 + r0] = mx0;
      red_m[wg * 64 + r0 + 8] = mx1;
    }
    consumers_sync();
    const float m_0 = fmaxf(red_m[r0], red_m[64 + r0]);
    const float m_1 = fmaxf(red_m[r0 + 8], red_m[64 + r0 + 8]);
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = expf(s[4 * j] - m_0);
      s[4 * j + 1] = expf(s[4 * j + 1] - m_0);
      s[4 * j + 2] = expf(s[4 * j + 2] - m_1);
      s[4 * j + 3] = expf(s[4 * j + 3] - m_1);
      l0 += s[4 * j] + s[4 * j + 1];
      l1 += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (t4 == 0) {
      red_l[wg * 64 + r0] = l0;
      red_l[wg * 64 + r0 + 8] = l1;
    }
    consumers_sync();
    l0 = red_l[r0] + red_l[64 + r0];
    l1 = red_l[r0 + 8] + red_l[64 + r0 + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] /= l0;
      s[4 * j + 1] /= l0;
      s[4 * j + 2] /= l1;
      s[4 * j + 3] /= l1;
    }
    const size_t row_base = (size_t)batch * n;

    if constexpr (kFwd) {
      // P's three terms as A fragments: slice kk covers keys 16 kk..16 kk + 15
      uint32_t pa[8][3][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t t[3];
          split3(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1], t);
#pragma unroll
          for (int i = 0; i < 3; ++i) pa[kk][i][h] = t[i];
        }
      for (int ch = 0; ch < nch; ++ch, ++it) {
        const int st = it % kHStages;
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        mbar_wait(ring.full(st), (it / kHStages) & 1);
        const uint32_t vb = stages + st * kRowsStage + kBox64 + wg * (128 * 128);
        fence_regs<32>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < 3; ++i) wgmma_m64n64_rs(acc, pa[kk][i], sw128_desc(vb + kk * 2048));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(acc);
        mbar_arrive(ring.empty(st));
        // consumer 0's keys + consumer 1's keys; thread t of either consumer
        // holds the same (row, channel) positions
        float* part = oxs + (ch & 1) * 2 * 4096;
#pragma unroll
        for (int i = 0; i < 32; ++i) part[wg * 4096 + i * 128 + tid] = acc[i];
        consumers_sync();
#pragma unroll
        for (int j = wg; j < 8; j += 2) {
          const int col = ch * 64 + 8 * j + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + r0 + 8 * h;
            const int e = (4 * j + 2 * h) * 128 + tid;
            if (row < n) {
              *reinterpret_cast<__nv_bfloat162*>(out + (row_base + row) * c + col) =
                  __floats2bfloat162_rn(part[e] + part[4096 + e], part[e + 128] + part[4096 + e + 128]);
            }
          }
        }
      }
    } else {
      const int nkp = pad64(n);
      store_terms(out, s, 0, b, batch, n, nkp, m0 + r0, key0);
      float d[64];
      rows_product(d, ring, stages, nch, wg, &it);  // dP = G V^T
      float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dl0 = fmaf(d[4 * j], s[4 * j], dl0);
        dl0 = fmaf(d[4 * j + 1], s[4 * j + 1], dl0);
        dl1 = fmaf(d[4 * j + 2], s[4 * j + 2], dl1);
        dl1 = fmaf(d[4 * j + 3], s[4 * j + 3], dl1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
      }
      if (t4 == 0) {
        red_d[wg * 64 + r0] = dl0;
        red_d[wg * 64 + r0 + 8] = dl1;
      }
      consumers_sync();
      dl0 = red_d[r0] + red_d[64 + r0];
      dl1 = red_d[r0 + 8] + red_d[64 + r0 + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        d[4 * j] = s[4 * j] * (d[4 * j] - dl0);
        d[4 * j + 1] = s[4 * j + 1] * (d[4 * j + 1] - dl0);
        d[4 * j + 2] = s[4 * j + 2] * (d[4 * j + 2] - dl1);
        d[4 * j + 3] = s[4 * j + 3] * (d[4 * j + 3] - dl1);
      }
      store_terms(out, d, 3, b, batch, n, nkp, m0 + r0, key0);
    }
  }
}

// pass (b)'s main loop: acc[x] = sum over the 64-token chunks of the three
// A terms (K-major when TA = 0, transposed when TA = 1) times the B box at
// byte offset boff[x] of each stage, from ring position *it on.
template <int NBW, int TA>
__device__ __forceinline__ void cols_mainloop(float (*acc)[32], const HRing& ring, uint32_t stages,
                                              uint32_t stage_bytes, int chunks, const uint32_t* boff,
                                              int* it) {
#pragma unroll
  for (int x = 0; x < NBW; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[x][i] = 0.f;
  for (int ch = 0; ch < chunks; ++ch, ++*it) {
    const int s = *it % kHStages;
    mbar_wait(ring.full(s), (*it / kHStages) & 1);
    const uint32_t a = stages + s * stage_bytes;
#pragma unroll
    for (int x = 0; x < NBW; ++x) fence_regs<32>(acc[x]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < NBW; ++x) {
        const uint64_t db = sw128_desc(a + boff[x] + kk * 2048);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          wgmma_m64n64_ss_t<TA>(acc[x], sw128_desc(a + i * kBox64 + (TA ? kk * 2048 : kk * 32)), db);
      }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(ring.empty(s));
  }
#pragma unroll
  for (int x = 0; x < NBW; ++x) fence_regs<32>(acc[x]);
}

// pass (b)'s tiles: tile t is (batch, 64-row tile, product, column block),
// the column block varying fastest, so that neighbouring blocks share the
// scratch rows and the B operand in L2. Products: 0 dQ, 1 dK, 2 dV.
struct ColsTile {
  int batch, m0, product, box0, nb;
  __device__ ColsTile(int t, int n, int nbox, int nbw) {
    const int col_blocks = (nbox + 2 * nbw - 1) / (2 * nbw);
    const int cb = t % col_blocks;
    t /= col_blocks;
    product = t % 3;
    t /= 3;
    const int row_tiles = (n + kHRows - 1) / kHRows;
    m0 = t % row_tiles * kHRows;
    batch = t / row_tiles;
    box0 = cb * 2 * nbw;
    nb = min(2 * nbw, nbox - box0);  // boxes of the tile's columns
  }
};

// pass (b): block i takes tiles i, i + gridDim.x, ...; the ring runs on
// across them, so the producer loads the next tile while the consumers
// store this one.
template <int NBW>
__global__ void __launch_bounds__(kHThreads, 1)
attention_cols_wgmma_kernel(const __grid_constant__ CUtensorMap tm_s,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_g, bf16* __restrict__ dq,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int b, int n, int c,
                            int tiles, float scale) {
  constexpr uint32_t STAGE = cols_stage_bytes<NBW>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stages = (raw + 1023u) & ~1023u;
  const HRing ring{stages + kHStages * STAGE};
  const int nbox = c / 64;
  const int chunks = pad64(n) / 64;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  int it = 0;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const ColsTile tile(t, n, nbox, NBW);
        const CUtensorMap* bmap = tile.product == 0 ? &tm_k : tile.product == 1 ? &tm_q : &tm_g;
        const int plane0 = tile.product == 2 ? 0 : 3;
        for (int ch = 0; ch < chunks; ++ch, ++it) {
          const int s = it % kHStages;
          mbar_wait(ring.empty(s), ((it / kHStages) & 1) ^ 1);
          const uint32_t dst = stages + s * STAGE;
          mbar_expect_tx(ring.full(s), (3 + tile.nb) * kBox64);
          const int t0 = ch * 64;
          for (int i = 0; i < 3; ++i) {
            const int z = (plane0 + i) * b + tile.batch;
            if (tile.product == 0) tma_load_3d(dst + i * kBox64, &tm_s, ring.full(s), t0, tile.m0, z);
            else tma_load_3d(dst + i * kBox64, &tm_s, ring.full(s), tile.m0, t0, z);
          }
          for (int x = 0; x < tile.nb; ++x)
            tma_load_3d(dst + (3 + x) * kBox64, bmap, ring.full(s), (tile.box0 + x) * 64, t0, tile.batch);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const ColsTile tile(t, n, nbox, NBW);
    // a consumer whose boxes run past c (c % 128 == 64 with NBW = 1) repeats
    // the tile's last box and stores nothing of it, so that every consumer
    // issues the same wgmmas
    uint32_t boff[NBW];
#pragma unroll
    for (int x = 0; x < NBW; ++x) boff[x] = (3 + min(wg * NBW + x, tile.nb - 1)) * kBox64;
    float acc[NBW][32];
    if (tile.product == 0) {
      cols_mainloop<NBW, 0>(acc, ring, stages, STAGE, chunks, boff, &it);
    } else {
      cols_mainloop<NBW, 1>(acc, ring, stages, STAGE, chunks, boff, &it);
    }
    bf16* out = tile.product == 0 ? dq : tile.product == 1 ? dk : dv;
    const float f = tile.product == 2 ? 1.f : scale;
    const size_t row_base = (size_t)tile.batch * n;
#pragma unroll
    for (int x = 0; x < NBW; ++x) {
      if (wg * NBW + x >= tile.nb) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (tile.box0 + wg * NBW + x) * 64 + 8 * j + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = tile.m0 + r0 + 8 * h;
          if (row < n) {
            *reinterpret_cast<__nv_bfloat162*>(out + (row_base + row) * c + col) =
                __floats2bfloat162_rn(acc[x][4 * j + 2 * h] * f, acc[x][4 * j + 2 * h + 1] * f);
          }
        }
      }
    }
  }
}

// The self-test of the operand forms above, one warpgroup, one tile each:
// x (64 x 64), y (128 x 64) and z (64 x 64) bf16 arrive by TMA;
//   s   = x y^T          m64n128k16, both K-major (pass (a)'s S and dP),
//   o_k = x z            A K-major, B MN-major (pass (b)'s dQ),
//   o_t = x^T z          A MN-major: transposed (pass (b)'s dK, dV),
//   o_r = s[:, :64] z    s's three bf16 terms as A from registers (B4's P V),
// all fp32 out.
__global__ void __launch_bounds__(128, 1)
attention_selftest_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_y,
                          const __grid_constant__ CUtensorMap tm_z, float* s_out, float* ok_out,
                          float* ot_out, float* or_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sx = (raw + 1023u) & ~1023u;
  const uint32_t sy = sx + kBox64;
  const uint32_t sz = sy + 2 * kBox64;
  const uint32_t bar = sz + kBox64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4 * kBox64);
    tma_load_3d(sx, &tm_x, bar, 0, 0, 0);
    tma_load_3d(sy, &tm_y, bar, 0, 0, 0);
    tma_load_3d(sz, &tm_z, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const int lane = tid & 31, t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  float s[64], ok[32], ot[32], orr[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) ok[i] = ot[i] = orr[i] = 0.f;
  fence_regs<64>(s);
  fence_regs<32>(ok);
  fence_regs<32>(ot);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n128_ss(s, sw128_desc(sx + 32 * kk), sw128_desc(sy + 32 * kk));
    wgmma_m64n64_ss_t<0>(ok, sw128_desc(sx + 32 * kk), sw128_desc(sz + kk * 2048));
    wgmma_m64n64_ss_t<1>(ot, sw128_desc(sx + kk * 2048), sw128_desc(sz + kk * 2048));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<64>(s);
  fence_regs<32>(ok);
  fence_regs<32>(ot);
  uint32_t pa[4][3][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t t[3];
      split3(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1], t);
#pragma unroll
      for (int i = 0; i < 3; ++i) pa[kk][i][h] = t[i];
    }
  fence_regs<32>(orr);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 3; ++i) wgmma_m64n64_rs(orr, pa[kk][i], sw128_desc(sz + kk * 2048));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(orr);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1);
      const int col = 8 * j + 2 * t4 + (e & 1);
      s_out[r * 128 + col] = s[4 * j + e];
      if (j < 8) {
        ok_out[r * 64 + col] = ok[4 * j + e];
        ot_out[r * 64 + col] = ot[4 * j + e];
        or_out[r * 64 + col] = orr[4 * j + e];
      }
    }
}

// The Hopper instance takes every bf16 (b, n, c) with c a multiple of 64 and
// n <= 256 (kHKeys), any b the grid allows.
bool takes_wgmma(int b, int n, int c) {
  return b >= 1 && b <= 65535 && n >= 1 && n <= kHKeys && c >= 64 && c % 64 == 0;
}

template <bool kFwd>
int launch_rows(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tg,
                const CUtensorMap& tv, void* out, int b, int n, int c, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = rows_smem_bytes(kFwd);
  cudaError_t err = cudaFuncSetAttribute(attention_rows_wgmma_kernel<kFwd>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return fail((int)err, "attention_rows_wgmma_kernel: cudaFuncSetAttribute: CUDA error %d", (int)err);
  int blocks = 0;
  err = grid_blocks((long long)b * ((n + kHRows - 1) / kHRows), &blocks);
  if (err != cudaSuccess) return fail((int)err, "attention_rows_wgmma_kernel: grid size: CUDA error %d", (int)err);
  attention_rows_wgmma_kernel<kFwd><<<blocks, kHThreads, smem, stream>>>(
      tq, tk, tg, tv, static_cast<bf16*>(out), b, n, c, scale);
  return launch_status(kFwd ? "attention_rows_wgmma_kernel<fwd>" : "attention_rows_wgmma_kernel<bwd>");
}

int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, int b, int n, int c,
                     float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = 0;
  if ((err = encode_map_named(&tq, q, b, n, c, kHRows, "q")) ||
      (err = encode_map_named(&tk, k, b, n, c, kHKeys, "k")) ||
      (err = encode_map_named(&tv, v, b, n, c, kHKeys, "v"))) {
    return err;
  }
  return launch_rows<true>(tq, tk, tq, tv, o, b, n, c, scale, stream);
}

template <int NBW>
int launch_cols(const CUtensorMap& ts, const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tg, void* dq, void* dk, void* dv, int b, int n, int c,
                float scale, cudaStream_t stream) {
  constexpr size_t smem = cols_smem_bytes<NBW>();
  cudaError_t err = cudaFuncSetAttribute(attention_cols_wgmma_kernel<NBW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return fail((int)err, "attention_cols_wgmma_kernel: cudaFuncSetAttribute: CUDA error %d", (int)err);
  const long long tiles = (long long)b * ((n + kHRows - 1) / kHRows) * 3 *
                          ((c / 64 + 2 * NBW - 1) / (2 * NBW));
  if (tiles > INT_MAX) return fail((int)cudaErrorInvalidValue, "attention_cols_wgmma_kernel: %lld tiles", tiles);
  int blocks = 0;
  err = grid_blocks(tiles, &blocks);
  if (err != cudaSuccess) return fail((int)err, "attention_cols_wgmma_kernel: grid size: CUDA error %d", (int)err);
  attention_cols_wgmma_kernel<NBW><<<blocks, kHThreads, smem, stream>>>(
      ts, tq, tk, tg, static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, n,
      c, (int)tiles, scale);
  return launch_status("attention_cols_wgmma_kernel");
}

int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* g, void* dq,
                     void* dk, void* dv, void* scratch, int b, int n, int c, float scale,
                     cudaStream_t stream) {
  CUtensorMap tq, tk, tg, tv, tk64, ts;
  int err = 0;
  if ((err = encode_map_named(&tq, q, b, n, c, kHRows, "q")) ||
      (err = encode_map_named(&tk, k, b, n, c, kHKeys, "k")) ||
      (err = encode_map_named(&tg, g, b, n, c, kHRows, "g")) ||
      (err = encode_map_named(&tv, v, b, n, c, kHKeys, "v")) ||
      (err = encode_map_named(&tk64, k, b, n, c, kHRows, "k (64-row boxes)")) ||
      (err = encode_map_named(&ts, scratch, 6 * b, n, pad64(n), kHRows, "scratch"))) {
    return err;
  }
  err = launch_rows<false>(tq, tk, tg, tv, scratch, b, n, c, scale, stream);
  if (err != 0) return err;
  return c % 256 == 0 ? launch_cols<2>(ts, tq, tk64, tg, dq, dk, dv, b, n, c, scale, stream)
                      : launch_cols<1>(ts, tq, tk64, tg, dq, dk, dv, b, n, c, scale, stream);
}

}  // namespace

extern "C" int medvae_attention_max_tokens() { return max_tokens(); }

// 1 when the bf16 launchers take the Hopper instance for (n, c), 0 when they
// take the FMA one (any b the grid allows).
extern "C" int medvae_attention_bf16_instance(int n, int c) { return takes_wgmma(1, n, c) ? 1 : 0; }

// Bytes of the scratch medvae_attention_bwd_* wants for (b, n, c): the
// Hopper instance's (6, b, n, nkp) bf16 planes of P and dS, or the FMA
// instance's (3, b, n) fp32 row max, sum and delta.
extern "C" long long medvae_attention_bwd_scratch_bytes(int b, int n, int c, int is_bf16) {
  if (is_bf16 && takes_wgmma(b, n, c)) return 6LL * b * n * pad64(n) * 2;
  return 3LL * b * n * 4;
}

extern "C" int medvae_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                         int b, int n, int c, float scale, void* stream) {
  if (int stale = check_no_pending_error("medvae_attention_fwd_bf16")) return stale;
  if (int err = bind_context(q, "medvae_attention_fwd_bf16")) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_wgmma(b, n, c)) return launch_fwd_wgmma(q, k, v, o, b, n, c, scale, s);
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_fwd<bf16>(q, k, v, o, b, n, c, scale, s);
}

extern "C" int medvae_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        int b, int n, int c, float scale, void* stream) {
  if (int stale = check_no_pending_error("medvae_attention_fwd_f32")) return stale;
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_fwd<float>(q, k, v, o, b, n, c, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int medvae_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv, void* scratch,
                                         int b, int n, int c, float scale, void* stream) {
  if (int stale = check_no_pending_error("medvae_attention_bwd_bf16")) return stale;
  if (int err = bind_context(q, "medvae_attention_bwd_bf16")) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (takes_wgmma(b, n, c)) return launch_bwd_wgmma(q, k, v, g, dq, dk, dv, scratch, b, n, c, scale, s);
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_bwd_any<bf16>(q, k, v, g, dq, dk, dv, scratch, b, n, c, scale, s);
}

extern "C" int medvae_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* g, void* dq, void* dk, void* dv, void* stats,
                                        int b, int n, int c, float scale, void* stream) {
  if (int stale = check_no_pending_error("medvae_attention_bwd_f32")) return stale;
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_bwd_any<float>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale,
                           static_cast<cudaStream_t>(stream));
}

// The FMA instance on bf16 whatever the shape, kept callable so that
// chip_smoke.py times it beside the Hopper instance in one run. The port's
// wrappers never call these.
extern "C" int medvae_attention_fwd_bf16_fma(const void* q, const void* k, const void* v, void* o,
                                             int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_fwd<bf16>(q, k, v, o, b, n, c, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int medvae_attention_bwd_bf16_fma(const void* q, const void* k, const void* v,
                                             const void* g, void* dq, void* dk, void* dv,
                                             void* stats, int b, int n, int c, float scale,
                                             void* stream) {
  if (bad_shape(b, n, c)) return fail((int)cudaErrorInvalidValue, "shape (%d, %d, %d) out of the kernels' range", b, n, c);
  return launch_bwd_any<bf16>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale,
                          static_cast<cudaStream_t>(stream));
}

// The self-test of the Hopper instance's operand forms: x (64, 64), y
// (128, 64), z (64, 64) bf16 in; s (64, 128), o_k, o_t, o_r (64, 64) fp32 out
// (see attention_selftest_kernel).
extern "C" int medvae_attention_wgmma_selftest(const void* x, const void* y, const void* z, void* s,
                                               void* o_k, void* o_t, void* o_r, void* stream) {
  CUtensorMap tx, ty, tz;
  if (int err = bind_context(x, "medvae_attention_wgmma_selftest")) return err;
  if (!encode_map(&tx, x, 1, 64, 64, 64) || !encode_map(&ty, y, 1, 128, 64, 128) ||
      !encode_map(&tz, z, 1, 64, 64, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  attention_selftest_kernel<<<1, 128, 1024 + 4 * kBox64 + 8, static_cast<cudaStream_t>(stream)>>>(
      tx, ty, tz, static_cast<float*>(s), static_cast<float*>(o_k), static_cast<float*>(o_t),
      static_cast<float*>(o_r));
  return (int)cudaGetLastError();
}
