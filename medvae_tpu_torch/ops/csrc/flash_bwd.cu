// Single-head flash-attention backward for Hopper (sm_90a): kernels B2 and B3.
//
// Replace the Pallas TPU kernels of medvae_tpu/ops/flash_attention.py:
//   B2 _flash_dkv_kernel:  dK, dV of O = softmax(Q K^T c^-1/2) V
//   B3 _flash_dq_kernel:   dQ
// for q, k, v, dO of shape (b, n, c), contiguous, from the forward's (b, n) fp32
// row logsumexp lse (flash_fwd.cu, lse output) and delta = rowsum(dO * O)
// (computed outside, as the JAX package does). The arithmetic is the TPU
// kernels': fp32 logits S = Q K^T * scale, P = exp(S - lse), dP = dO V^T,
// dS = P (dP - delta) scale, all fp32; P and dS are cast to the input type
// before the products that take them (dV = P^T dO, dK = dS^T Q, dQ = dS K), which
// accumulate in fp32; outputs come back in the input type.
//
// Bound: B2 does four products of n x n x c per batch element (S, dP, dV, dK),
// 8 b n^2 c operations; B3 three (S, dP, dQ), 6 b n^2 c. At the flagship shape
// (b 32, n 3136, c 512) that is 1.3e12 and 9.7e11 operations against 6 and 5
// (b, n, c) bf16 tensors moved (about 0.6 GB), far above the H100's ~295
// operations per byte: both are bound by tensor-core throughput. What this
// design does about it: every product runs on the tensor cores and no (n, n)
// tile leaves the SM; it does not yet keep the tensor cores fed (synchronous
// loads, one block per SM, S and dP recomputed by both kernels, fragments
// gathered with plain shared-memory loads). wgmma with TMA-fed tiles is the
// next design.
//
// Design (simple first). The head dim c (512 on the flagship, up to 1024) is
// far larger than stock FlashAttention's <= 256, so the fp32 accumulators do
// not fit one warp: as in flash_fwd.cu, warp w owns columns [64w, 64w + 64) of
// the accumulators in registers, c / 64 warps a block.
//  * Tiles of T = 32 query rows and 32 key rows for c <= 512, 16 above. At
//    c = 512 the two fp32 accumulators of B2 (T x c each) take 128 registers a
//    thread over 8 warps, and the four c-wide bf16 tiles (Q, dO, K, V) 133 KB
//    of shared memory: inside the 227 KB a block may use (64-row tiles would
//    need 266 KB and the whole register file).
//  * B2: one block per (key tile, batch); K and V stay resident and the loop
//    runs over query tiles. B3: one block per (query tile, batch); Q, dO, lse
//    and delta stay resident and the loop runs over key tiles.
//  * Each (16 x 8) tile of S and dP is computed by one warp over all of c
//    (mma.sync m16n8k16, bf16 in, fp32 accumulate), turned into P and dS in
//    registers, and stored to shared memory in bf16: transposed in B2, so that
//    P^T and dS^T are row-major A operands of the dV and dK products, and as is
//    in B3.
//  * The fp32 instance uses CUDA-core FMAs in full fp32 (no TF32), as the JAX
//    fp32 dot does: tiles of 16 rows (8 above c = 512), one logit per thread,
//    each thread owning c T / 256 accumulator elements. It is the parity path.
//  * Any n: K, V, Q and dO tiles are zero-filled past n, keys past n are
//    masked to P = 0, query rows past n read lse = +inf (so P = 0) and
//    delta = 0, and rows past n are not stored.
//
// C interface (bound with ctypes; returns cudaGetLastError() after the launch):
//   int medvae_flash_dkv_bf16(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, stream)
//   int medvae_flash_dkv_f32 (q, k, v, g, lse, delta, dk, dv, b, n, c, scale, stream)
//   int medvae_flash_dq_bf16 (q, k, v, g, lse, delta, dq, b, n, c, scale, stream)
//   int medvae_flash_dq_f32  (q, k, v, g, lse, delta, dq, b, n, c, scale, stream)
// where g is dO.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Copy rows [row0, row0 + rows) of a (n, c) matrix into shared memory with row
// stride ld, 16 bytes per thread per step; rows at or past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* __restrict__ src,
                                          int row0, int rows, int n, int c) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = c / VEC;
  for (int i = threadIdx.x; i < rows * cv; i += blockDim.x) {
    const int r = i / cv;
    const int j = (i - r * cv) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * c + j);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + j) = val;
  }
}

// lse and delta of rows [row0, row0 + rows); rows at or past n get lse = +inf
// (P = 0 there) and delta = 0.
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int row0,
                                               int rows, int n) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const bool in = row0 + r < n;
    lse_s[r] = in ? lse[row0 + r] : INFINITY;
    delta_s[r] = in ? delta[row0 + r] : 0.f;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D += A B for one m16n8k16 tile: A row-major 16x16, B column-major 16x8,
// bf16 operands, fp32 accumulator (PTX ISA fragment layouts).
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D += A B where A (16 x 16) is row-major at a with row stride lda and B
// (16 x 8) is row-major at b with row stride ldb, i.e. B[k][j] = b[k * ldb + j].
__device__ __forceinline__ void mma_rows(float* d, const bf16* a, int lda, const bf16* b,
                                         int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const bf16* pa = a + g * lda + t4 * 2;
  const bf16* pb = b + (t4 * 2) * ldb + g;
  mma_bf16(d, ld32(pa), ld32(pa + 8 * lda), ld32(pa + 8), ld32(pa + 8 * lda + 8),
           pack2(pb[0], pb[ldb]), pack2(pb[8 * ldb], pb[9 * ldb]));
}

// For the (16 x 8) tile (mt, nt) of the block of query rows held in Qs / Gs
// (Q and dO) against the key rows held in Ks / Vs, whose first key is k0:
// S = Q K^T * scale and dP = dO V^T over all of c on the tensor cores, then
// p = exp(S - lse) and ds = p (dP - delta) scale in fp32, with keys at or past
// n masked to p = 0. Element e of p and ds is row mt*16 + g + 8 (e >> 1),
// column nt*8 + t4*2 + (e & 1) of the block (the mma accumulator layout).
__device__ __forceinline__ void p_ds_tile(const bf16* Qs, const bf16* Gs, const bf16* Ks,
                                          const bf16* Vs, int ld, int c,
                                          const float* lse_s, const float* delta_s, int mt,
                                          int nt, int k0, int n, float scale, float* p,
                                          float* ds) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* qa = Qs + (mt * 16 + g) * ld + t4 * 2;
  const bf16* ga = Gs + (mt * 16 + g) * ld + t4 * 2;
  const bf16* kb = Ks + (nt * 8 + g) * ld + t4 * 2;
  const bf16* vb = Vs + (nt * 8 + g) * ld + t4 * 2;
  for (int kk = 0; kk < c; kk += 16) {
    mma_bf16(s, ld32(qa + kk), ld32(qa + 8 * ld + kk), ld32(qa + kk + 8),
             ld32(qa + 8 * ld + kk + 8), ld32(kb + kk), ld32(kb + kk + 8));
    mma_bf16(dp, ld32(ga + kk), ld32(ga + 8 * ld + kk), ld32(ga + kk + 8),
             ld32(ga + 8 * ld + kk + 8), ld32(vb + kk), ld32(vb + kk + 8));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = mt * 16 + g + 8 * (e >> 1);
    const int j = nt * 8 + t4 * 2 + (e & 1);
    const float sv = s[e] * scale;
    const float pv = k0 + j < n ? expf(sv - lse_s[r]) : 0.f;
    p[e] = pv;
    ds[e] = pv * (dp[e] - delta_s[r]) * scale;
  }
}

template <int T>
constexpr int bf16_threads() { return T == 32 ? 256 : 512; }

template <int T>
size_t bf16_smem_bytes(int c) {
  const size_t ld = c + 8;
  return 4 * T * ld * sizeof(bf16) + 2 * T * (T + 8) * sizeof(bf16) + 2 * T * sizeof(float);
}

// Store rows [row0, row0 + rows) of the warp's accumulator columns, cast to bf16.
template <int MT>
__device__ __forceinline__ void store_acc(bf16* out, const float (&acc)[MT][8][4], int row0,
                                          int n, int c, int col0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = row0 + mt * 16 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = col0 + nt * 8 + t4 * 2;
      if (r0 < n) {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * c + col) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (r1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * c + col) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

// B2: dK, dV for one tile of T keys of one batch element.
template <int T>
__global__ void __launch_bounds__(bf16_threads<T>(), 1)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int c,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = T / 16;  // 16-row mma tiles in T rows
  constexpr int NT = T / 8;   // 8-column mma tiles in T columns
  constexpr int LDT = T + 8;  // row stride of the transposed P and dS tiles
  const int ld = c + 8;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T * ld;
  bf16* Qs = Vs + T * ld;
  bf16* Gs = Qs + T * ld;
  bf16* PT = Gs + T * ld;    // PT[key][query] = P[query][key]
  bf16* dST = PT + T * LDT;  // dST[key][query] = dS[query][key]
  float* lse_s = reinterpret_cast<float*>(dST + T * LDT);
  float* delta_s = lse_s + T;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  g += base;
  dk += base;
  dv += base;
  lse += (size_t)blockIdx.y * n;
  delta += (size_t)blockIdx.y * n;
  const int k0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int col0 = warp * 64;  // this warp's 64 columns of dK and dV

  load_tile(Ks, ld, k, k0, T, n, c);
  load_tile(Vs, ld, v, k0, T, n, c);

  float dk_acc[MT][8][4];
  float dv_acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk_acc[mt][nt][e] = 0.f;
        dv_acc[mt][nt][e] = 0.f;
      }

  for (int q0 = 0; q0 < n; q0 += T) {
    __syncthreads();  // the previous step is done with Qs, Gs, PT and dST
    load_tile(Qs, ld, q, q0, T, n, c);
    load_tile(Gs, ld, g, q0, T, n, c);
    load_row_stats(lse_s, delta_s, lse, delta, q0, T, n);
    __syncthreads();

    for (int t = warp; t < MT * NT; t += nw) {
      const int mt = t / NT;
      const int nt = t % NT;
      float p[4], ds[4];
      p_ds_tile(Qs, Gs, Ks, Vs, ld, c, lse_s, delta_s, mt, nt, k0, n, scale, p, ds);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + gr + 8 * (e >> 1);  // query
        const int j = nt * 8 + t4 * 2 + (e & 1);    // key
        PT[j * LDT + i] = __float2bfloat16(p[e]);
        dST[j * LDT + i] = __float2bfloat16(ds[e]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q on this warp's columns, contracted over
    // the T queries of the step.
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_rows(dv_acc[mt][nt], PT + mt * 16 * LDT + kk, LDT,
                   Gs + kk * ld + col0 + nt * 8, ld);
          mma_rows(dk_acc[mt][nt], dST + mt * 16 * LDT + kk, LDT,
                   Qs + kk * ld + col0 + nt * 8, ld);
        }
      }
    }
  }

  store_acc<MT>(dk, dk_acc, k0, n, c, col0);
  store_acc<MT>(dv, dv_acc, k0, n, c, col0);
}

// B3: dQ for one tile of T queries of one batch element.
template <int T>
__global__ void __launch_bounds__(bf16_threads<T>(), 1)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, int n, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = T / 16;
  constexpr int NT = T / 8;
  constexpr int LDT = T + 8;  // row stride of the dS tile
  const int ld = c + 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + T * ld;
  bf16* Ks = Gs + T * ld;
  bf16* Vs = Ks + T * ld;
  bf16* dS = Vs + T * ld;  // dS[query][key]
  float* lse_s = reinterpret_cast<float*>(dS + 2 * T * LDT);
  float* delta_s = lse_s + T;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  g += base;
  dq += base;
  lse += (size_t)blockIdx.y * n;
  delta += (size_t)blockIdx.y * n;
  const int q0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int t4 = lane & 3;
  const int col0 = warp * 64;  // this warp's 64 columns of dQ

  load_tile(Qs, ld, q, q0, T, n, c);
  load_tile(Gs, ld, g, q0, T, n, c);
  load_row_stats(lse_s, delta_s, lse, delta, q0, T, n);

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < n; k0 += T) {
    __syncthreads();  // the previous step is done with Ks, Vs and dS
    load_tile(Ks, ld, k, k0, T, n, c);
    load_tile(Vs, ld, v, k0, T, n, c);
    __syncthreads();

    for (int t = warp; t < MT * NT; t += nw) {
      const int mt = t / NT;
      const int nt = t % NT;
      float p[4], ds[4];
      p_ds_tile(Qs, Gs, Ks, Vs, ld, c, lse_s, delta_s, mt, nt, k0, n, scale, p, ds);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + gr + 8 * (e >> 1);
        const int j = nt * 8 + t4 * 2 + (e & 1);
        dS[i * LDT + j] = __float2bfloat16(ds[e]);
      }
    }
    __syncthreads();

    // dQ += dS K on this warp's columns, contracted over the T keys of the step.
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_rows(acc[mt][nt], dS + mt * 16 * LDT + kk, LDT, Ks + kk * ld + col0 + nt * 8,
                   ld);
        }
      }
    }
  }

  store_acc<MT>(dq, acc, q0, n, c, col0);
}

// ---------------------------------------------------------------- fp32 ---- //

constexpr int kF32Threads = 256;
constexpr int kF32MaxPer = 32;  // accumulator elements a thread owns: T c / 256

template <int T>
size_t f32_smem_bytes(int c) {
  const size_t ld = c + 4;
  return (4 * T * ld + 2 * T * (T + 1) + 2 * T) * sizeof(float);
}

// s = q . k and dp = g . v over c in fp32 FMAs; returns p and ds as the bf16
// tiles do.
__device__ __forceinline__ void p_ds_f32(const float* qa, const float* ga, const float* kb,
                                         const float* vb, int c, float scale, float lse,
                                         float delta, bool key_in, float& p, float& ds) {
  float s = 0.f, dp = 0.f;
  const float4* q4 = reinterpret_cast<const float4*>(qa);
  const float4* g4 = reinterpret_cast<const float4*>(ga);
  const float4* k4 = reinterpret_cast<const float4*>(kb);
  const float4* v4 = reinterpret_cast<const float4*>(vb);
  for (int i = 0; i < c / 4; ++i) {
    const float4 a = q4[i], b = k4[i], x = g4[i], y = v4[i];
    s = fmaf(a.x, b.x, s);
    s = fmaf(a.y, b.y, s);
    s = fmaf(a.z, b.z, s);
    s = fmaf(a.w, b.w, s);
    dp = fmaf(x.x, y.x, dp);
    dp = fmaf(x.y, y.y, dp);
    dp = fmaf(x.z, y.z, dp);
    dp = fmaf(x.w, y.w, dp);
  }
  const float sv = s * scale;
  p = key_in ? expf(sv - lse) : 0.f;
  ds = p * (dp - delta) * scale;
}

template <int T>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int c,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDS = T + 1;
  const int ld = c + 4;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + T * ld;
  float* Qs = Vs + T * ld;
  float* Gs = Qs + T * ld;
  float* Ps = Gs + T * ld;  // Ps[query][key]
  float* dSs = Ps + T * LDS;
  float* lse_s = dSs + T * LDS;
  float* delta_s = lse_s + T;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  g += base;
  dk += base;
  dv += base;
  lse += (size_t)blockIdx.y * n;
  delta += (size_t)blockIdx.y * n;
  const int k0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int per = T * c / kF32Threads;

  load_tile(Ks, ld, k, k0, T, n, c);
  load_tile(Vs, ld, v, k0, T, n, c);
  float acc_k[kF32MaxPer], acc_v[kF32MaxPer];
#pragma unroll
  for (int i = 0; i < kF32MaxPer; ++i) {
    acc_k[i] = 0.f;
    acc_v[i] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += T) {
    __syncthreads();
    load_tile(Qs, ld, q, q0, T, n, c);
    load_tile(Gs, ld, g, q0, T, n, c);
    load_row_stats(lse_s, delta_s, lse, delta, q0, T, n);
    __syncthreads();
    for (int e = tid; e < T * T; e += kF32Threads) {
      const int i = e / T;  // query
      const int j = e % T;  // key
      float p, ds;
      p_ds_f32(Qs + i * ld, Gs + i * ld, Ks + j * ld, Vs + j * ld, c, scale, lse_s[i],
               delta_s[i], k0 + j < n, p, ds);
      Ps[i * LDS + j] = p;
      dSs[i * LDS + j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kF32MaxPer; ++ii) {
      if (ii < per) {
        const int e = tid + kF32Threads * ii;
        const int r = e / c;  // key
        const int col = e - r * c;
        float a_k = acc_k[ii], a_v = acc_v[ii];
#pragma unroll
        for (int i = 0; i < T; ++i) {
          a_v = fmaf(Ps[i * LDS + r], Gs[i * ld + col], a_v);
          a_k = fmaf(dSs[i * LDS + r], Qs[i * ld + col], a_k);
        }
        acc_k[ii] = a_k;
        acc_v[ii] = a_v;
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < kF32MaxPer; ++ii) {
    if (ii < per) {
      const int e = tid + kF32Threads * ii;
      const int r = e / c;
      const int col = e - r * c;
      if (k0 + r < n) {
        dk[(size_t)(k0 + r) * c + col] = acc_k[ii];
        dv[(size_t)(k0 + r) * c + col] = acc_v[ii];
      }
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int n, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDS = T + 1;
  const int ld = c + 4;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + T * ld;
  float* Ks = Gs + T * ld;
  float* Vs = Ks + T * ld;
  float* dSs = Vs + T * ld;  // dSs[query][key]
  float* lse_s = dSs + 2 * T * LDS;
  float* delta_s = lse_s + T;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  g += base;
  dq += base;
  lse += (size_t)blockIdx.y * n;
  delta += (size_t)blockIdx.y * n;
  const int q0 = blockIdx.x * T;
  const int tid = threadIdx.x;
  const int per = T * c / kF32Threads;

  load_tile(Qs, ld, q, q0, T, n, c);
  load_tile(Gs, ld, g, q0, T, n, c);
  load_row_stats(lse_s, delta_s, lse, delta, q0, T, n);
  float acc[kF32MaxPer];
#pragma unroll
  for (int i = 0; i < kF32MaxPer; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < n; k0 += T) {
    __syncthreads();
    load_tile(Ks, ld, k, k0, T, n, c);
    load_tile(Vs, ld, v, k0, T, n, c);
    __syncthreads();
    for (int e = tid; e < T * T; e += kF32Threads) {
      const int i = e / T;
      const int j = e % T;
      float p, ds;
      p_ds_f32(Qs + i * ld, Gs + i * ld, Ks + j * ld, Vs + j * ld, c, scale, lse_s[i],
               delta_s[i], k0 + j < n, p, ds);
      dSs[i * LDS + j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < kF32MaxPer; ++ii) {
      if (ii < per) {
        const int e = tid + kF32Threads * ii;
        const int r = e / c;  // query
        const int col = e - r * c;
        float a = acc[ii];
#pragma unroll
        for (int j = 0; j < T; ++j) a = fmaf(dSs[r * LDS + j], Ks[j * ld + col], a);
        acc[ii] = a;
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < kF32MaxPer; ++ii) {
    if (ii < per) {
      const int e = tid + kF32Threads * ii;
      const int r = e / c;
      const int col = e - r * c;
      if (q0 + r < n) dq[(size_t)(q0 + r) * c + col] = acc[ii];
    }
  }
}

// ------------------------------------------------------------- launch ---- //

bool bad_shape(int b, int n, int c) {
  return b < 1 || b > 65535 || n < 1 || c < 64 || c > 1024 || c % 64 != 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int T>
int dkv_bf16(const void* q, const void* k, const void* v, const void* g, const void* lse,
             const void* delta, void* dk, void* dv, int b, int n, int c, float scale,
             cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<T>(c);
  cudaError_t err = allow_smem(flash_dkv_bf16_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_bf16_kernel<T><<<dim3((n + T - 1) / T, b), (c / 64) * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, c,
      scale);
  return (int)cudaGetLastError();
}

template <int T>
int dq_bf16(const void* q, const void* k, const void* v, const void* g, const void* lse,
            const void* delta, void* dq, int b, int n, int c, float scale,
            cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<T>(c);
  cudaError_t err = allow_smem(flash_dq_bf16_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_bf16_kernel<T><<<dim3((n + T - 1) / T, b), (c / 64) * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), n, c, scale);
  return (int)cudaGetLastError();
}

template <int T>
int dkv_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
            const void* delta, void* dk, void* dv, int b, int n, int c, float scale,
            cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<T>(c);
  cudaError_t err = allow_smem(flash_dkv_f32_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_f32_kernel<T><<<dim3((n + T - 1) / T, b), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), n, c, scale);
  return (int)cudaGetLastError();
}

template <int T>
int dq_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
           const void* delta, void* dq, int b, int n, int c, float scale,
           cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<T>(c);
  cudaError_t err = allow_smem(flash_dq_f32_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_f32_kernel<T><<<dim3((n + T - 1) / T, b), kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), n, c, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int medvae_flash_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* g, const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int n, int c, float scale,
                                     void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c <= 512 ? dkv_bf16<32>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s)
                  : dkv_bf16<16>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s);
}

extern "C" int medvae_flash_dkv_f32(const void* q, const void* k, const void* v,
                                    const void* g, const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int n, int c, float scale,
                                    void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c <= 512 ? dkv_f32<16>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s)
                  : dkv_f32<8>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s);
}

extern "C" int medvae_flash_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* g, const void* lse, const void* delta,
                                    void* dq, int b, int n, int c, float scale,
                                    void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c <= 512 ? dq_bf16<32>(q, k, v, g, lse, delta, dq, b, n, c, scale, s)
                  : dq_bf16<16>(q, k, v, g, lse, delta, dq, b, n, c, scale, s);
}

extern "C" int medvae_flash_dq_f32(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   void* dq, int b, int n, int c, float scale,
                                   void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return c <= 512 ? dq_f32<16>(q, k, v, g, lse, delta, dq, b, n, c, scale, s)
                  : dq_f32<8>(q, k, v, g, lse, delta, dq, b, n, c, scale, s);
}
