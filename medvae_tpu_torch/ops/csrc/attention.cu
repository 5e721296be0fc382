// Whole-sequence single-head attention for Hopper (sm_90a): forward B4 and
// backward B5.
//
// Replaces the Pallas TPU kernels of medvae_tpu/ops/attention.py:
//   B4 _attention_fwd_kernel: O = softmax(Q K^T c^-1/2) V,
//   B5 _attention_bwd_kernel: recompute P, then dV = P^T G, dP = G V^T,
//      dS = P o (dP - rowsum(dP o P)), dQ = dS K c^-1/2, dK = dS^T Q c^-1/2,
// for q, k, v, g and the outputs of shape (b, n, c), contiguous, bf16 or fp32.
// Every product and the softmax are fp32, as on the TPU: the inputs are widened
// to fp32 as they are loaded, the softmax is the exact two-pass one of the TPU
// kernel (row max, exp, row sum, divide; no online rescale), and only the
// outputs are rounded to the input type. P is never rounded to bf16.
//
// Bound: B4 does 4 b n^2 c operations (two n x n x c products) and moves 4 b n c
// elements; B5 needs 10 b n^2 c and moves 7 b n c. At the 128^2 BaseVAE's shape
// (b 64, n 256, c 1024) that is 1.7e10 and 4.3e10 operations against 134 and
// 235 MB in bf16, so both are bound by operations, not by memory. For bf16
// inputs Q K^T (and G V^T in B5) have two bf16 operands and could run on the
// tensor cores (989 TFLOP/s); the products with the fp32 P or dS need the fp32
// rate (67 TFLOP/s): 0.14 ms for B4 and 0.40 ms for B5. What the design does: the
// (n, n) matrices never leave shared memory, every product is a register-blocked
// fp32 FMA tile (4 rows x 8 columns a thread, operands read from shared memory as
// float4, global loads 16 bytes wide where c allows), and the backward recomputes S and dP once per side rather than per
// channel chunk. It does not use the tensor cores (P V must stay fp32; Q K^T in
// bf16 could) and loads synchronously: those are the next design.
//
// Design:
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
// C interface (bound with ctypes; each launcher returns cudaGetLastError() after
// its launches; `stats` is a (3, b, n) fp32 scratch the caller allocates):
//   int medvae_attention_max_tokens()   the largest n the launchers take
//   int medvae_attention_fwd_bf16(q, k, v, o, b, n, c, scale, stream)
//   int medvae_attention_fwd_f32 (q, k, v, o, b, n, c, scale, stream)
//   int medvae_attention_bwd_bf16(q, k, v, g, dq, dk, dv, stats, b, n, c, scale, stream)
//   int medvae_attention_bwd_f32 (q, k, v, g, dq, dk, dv, stats, b, n, c, scale, stream)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T><<<dim3((n + 31) / 32, b), threads<32>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, c, scale);
  return (int)cudaGetLastError();
}

template <int BM, typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, void* stats, int b, int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(n, 2);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_rows_kernel<BM, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_cols_kernel<BM, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM, b);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  float* st = static_cast<float*>(stats);
  attention_bwd_rows_kernel<BM, T><<<grid, threads<BM>(), smem, stream>>>(
      tq, tk, tv, tg, static_cast<T*>(dq), st, b, n, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_cols_kernel<BM, T><<<grid, threads<BM>(), smem, stream>>>(
      tq, tk, tv, tg, static_cast<T*>(dk), static_cast<T*>(dv), st, b, n, c, scale);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" int medvae_attention_max_tokens() { return max_tokens(); }

extern "C" int medvae_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                         int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  return launch_fwd<bf16>(q, k, v, o, b, n, c, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int medvae_attention_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  return launch_fwd<float>(q, k, v, o, b, n, c, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int medvae_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv, void* stats,
                                         int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  return launch_bwd_any<bf16>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int medvae_attention_bwd_f32(const void* q, const void* k, const void* v,
                                        const void* g, void* dq, void* dk, void* dv, void* stats,
                                        int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  return launch_bwd_any<float>(q, k, v, g, dq, dk, dv, stats, b, n, c, scale,
                           static_cast<cudaStream_t>(stream));
}
