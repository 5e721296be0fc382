// Single-head flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel medvae_tpu/ops/flash_attention.py:
// _flash_fwd_kernel. It computes
//   O = softmax(Q K^T c^-1/2) V     for q, k, v, o of shape (b, n, c), contiguous,
// with fp32 logits, a running row max and row sum in fp32, P cast to the input
// type before P V, an fp32 O accumulator, and O / l cast to the output type at
// the end: the TPU kernel's arithmetic, step for step. When `lse` is not null
// (the training forward, want_lse=True there) it also writes the (b, n) fp32
// row logsumexp m + log l of the scaled logits, which the backward kernels of
// flash_bwd.cu read; serving passes null and stores nothing more.
//
// Bound: 4 b n^2 c operations (two products of n x n x c per batch element)
// against 4 b n c elements moved, i.e. n/2 operations per byte in bf16. At the
// flagship shape (b 32, n 3136, c 512) that is 6.4e11 operations over 411 MB,
// far above the H100's ~295 operations per byte, so the kernel is bound by
// tensor-core throughput, not by memory.
//
// Three instances; medvae_flash_fwd_bf16 picks one by c alone, with no
// try-and-fall-back:
//  * bf16, c % 128 == 0 and c <= 512 (every shape of the main path): the
//    Hopper instance, wgmma on TMA-fed, double-buffered K/V tiles with P
//    kept in registers (flash_fwd_wgmma_kernel, its own comment below).
//  * bf16, any other c (multiples of 64 up to 1024; the 784 x 1024 blocks):
//    the first design, mma.sync m16n8k16 with synchronous loads. c = 1024
//    does not fit the wgmma instance's split of O over two warpgroups (128
//    fp32 registers a thread at c = 512 already), and its shapes are off the
//    main path.
//  * fp32: CUDA-core FMAs in full fp32 (no TF32), as the JAX fp32 dot does;
//    the parity path, not the serving path.
//
// The mma.sync instance (simple first):
//  * One block per (TILE query rows, batch element). The whole Q tile and one
//    TILE-row K and V tile live in padded shared memory (rows padded by 16
//    bytes so that fragment loads are bank-conflict free).
//  * The fp32 O tile (TILE x c) cannot sit in one warp's registers. Its
//    channel dim is split across warps instead: warp w owns columns
//    [64w, 64w + 64) of O in registers, c / 64 warps per block. TILE = 64
//    rows for c <= 512 (128 fp32 registers a thread, 8 warps) and 32 rows
//    above (64 registers a thread, up to 16 warps), which keeps the tiles
//    inside the 227 KB of shared memory a block may use.
//  * Loads are synchronous, one block fits an SM, and fragments are gathered
//    with plain shared-memory loads: it reached 48 TFLOP/s on an H100 at
//    the flagship shape, which is why the main path left it.
//  * Any n: the ragged last K tile is masked to -inf before the softmax, the
//    ragged last Q tile is zero-filled and not stored.
//
// C interface (bound with ctypes; each launch returns cudaGetLastError() after
// the launch; lse may be null):
//   int medvae_flash_fwd_bf16(q, k, v, o, lse, b, n, c, scale, stream)
//   int medvae_flash_fwd_f32 (q, k, v, o, lse, b, n, c, scale, stream)
//   int medvae_flash_fwd_bf16_instance(c)   1: wgmma instance, 0: mma.sync
//   int medvae_flash_wgmma_selftest(q, k, v, s, o, o_staged, stream)

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // descriptors, mbarriers, TMA, the wgmma products

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

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// One online-softmax step over a (TILE x TILE) fp32 logits tile S whose first
// column is key kv0: updates the running max m and sum l of every row, writes
// alpha = exp(m_old - m_new) for the O rescale, and P = exp(S - m_new) in the
// input type. Keys at or past n are masked out.
template <int TILE, typename T>
__device__ __forceinline__ void softmax_step(const float* S, int lds, T* P, int ldp,
                                             float* m_s, float* l_s, float* a_s,
                                             int kv0, int n) {
  constexpr int PER = (TILE + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < TILE; r += nw) {
    float s[PER];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = lane + 32 * i;
      s[i] = (j < TILE && kv0 + j < n) ? S[r * lds + j] : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = lane + 32 * i;
      if (j < TILE) {
        const float p = expf(s[i] - m_new);
        P[r * ldp + j] = from_float<T>(p);
        sum += p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      a_s[r] = alpha;
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
    }
  }
}

// lse[r] = m + log l for the first `rows` rows of the tile, when lse is not
// null. Reads the final m_s / l_s, which the last softmax step wrote before a
// __syncthreads.
template <int TILE>
__device__ __forceinline__ void store_lse(float* lse, const float* m_s, const float* l_s,
                                          size_t row0, int rows) {
  if (lse == nullptr) return;
  for (int r = threadIdx.x; r < TILE && r < rows; r += blockDim.x) {
    lse[row0 + r] = m_s[r] + logf(l_s[r]);
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

template <int TILE>
constexpr int bf16_threads() { return TILE == 64 ? 256 : 512; }

template <int TILE>
size_t bf16_smem_bytes(int c) {
  const size_t ld = c + 8;
  return 3 * TILE * ld * sizeof(bf16) + TILE * (TILE + 4) * sizeof(float) +
         TILE * (TILE + 8) * sizeof(bf16) + 3 * TILE * sizeof(float);
}

template <int TILE>
__global__ void __launch_bounds__(bf16_threads<TILE>(), 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int n, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = TILE / 16;  // 16-row mma tiles in a TILE-row block
  constexpr int LDS = TILE + 4;  // fp32 logits row stride
  constexpr int LDP = TILE + 8;  // bf16 P row stride
  const int ld = c + 8;          // bf16 Q/K/V row stride
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * ld;
  bf16* Vs = Ks + TILE * ld;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * ld);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + TILE * LDS);
  float* m_s = reinterpret_cast<float*>(Ps + TILE * LDP);
  float* l_s = m_s + TILE;
  float* a_s = l_s + TILE;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  o += base;
  const int q0 = blockIdx.x * TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread in group
  const int col0 = warp * 64;  // this warp's 64 columns of O

  load_tile(Qs, ld, q, q0, TILE, n, c);
  for (int r = threadIdx.x; r < TILE; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += TILE) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    load_tile(Ks, ld, k, kv0, TILE, n, c);
    load_tile(Vs, ld, v, kv0, TILE, n, c);
    __syncthreads();

    // S = Q K^T * scale, one m16n8 tile at a time, contracted over all of c.
    for (int t = warp; t < MT * (TILE / 8); t += nw) {
      const int mt = t / (TILE / 8);
      const int nt = t % (TILE / 8);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* qa = Qs + (mt * 16 + g) * ld + t4 * 2;
      const bf16* kb = Ks + (nt * 8 + g) * ld + t4 * 2;
      for (int kk = 0; kk < c; kk += 16) {
        mma_bf16(d, ld32(qa + kk), ld32(qa + 8 * ld + kk), ld32(qa + kk + 8),
                 ld32(qa + 8 * ld + kk + 8), ld32(kb + kk), ld32(kb + kk + 8));
      }
      float* sp = Ss + (mt * 16 + g) * LDS + nt * 8 + t4 * 2;
      sp[0] = d[0] * scale;
      sp[1] = d[1] * scale;
      sp[8 * LDS] = d[2] * scale;
      sp[8 * LDS + 1] = d[3] * scale;
    }
    __syncthreads();
    softmax_step<TILE>(Ss, LDS, Ps, LDP, m_s, l_s, a_s, kv0, n);
    __syncthreads();

    // O = alpha * O + P V on this warp's columns.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float al0 = a_s[mt * 16 + g];
      const float al1 = a_s[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[mt][nt][0] *= al0;
        acc[mt][nt][1] *= al0;
        acc[mt][nt][2] *= al1;
        acc[mt][nt][3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      uint32_t bfr[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* vb = Vs + (kk + t4 * 2) * ld + col0 + nt * 8 + g;
        bfr[nt][0] = pack2(vb[0], vb[ld]);
        bfr[nt][1] = pack2(vb[8 * ld], vb[9 * ld]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* pa = Ps + (mt * 16 + g) * LDP + kk + t4 * 2;
        const uint32_t a0 = ld32(pa);
        const uint32_t a1 = ld32(pa + 8 * LDP);
        const uint32_t a2 = ld32(pa + 8);
        const uint32_t a3 = ld32(pa + 8 * LDP + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, bfr[nt][0], bfr[nt][1]);
        }
      }
    }
  }

  // O / l, cast, store the rows that exist.
  store_lse<TILE>(lse, m_s, l_s, (size_t)blockIdx.y * n + q0, n - q0);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = mt * 16 + g;
    const int r1 = r0 + 8;
    const float l0 = l_s[r0];
    const float l1 = l_s[r1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = col0 + nt * 8 + t4 * 2;
      if (q0 + r0 < n) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(q0 + r0) * c + col) =
            __floats2bfloat162_rn(acc[mt][nt][0] / l0, acc[mt][nt][1] / l0);
      }
      if (q0 + r1 < n) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(q0 + r1) * c + col) =
            __floats2bfloat162_rn(acc[mt][nt][2] / l1, acc[mt][nt][3] / l1);
      }
    }
  }
}

// fp32 instance: 16 query rows and 16 keys a step, 256 threads. Thread t owns
// the O elements e = t + 256 i (i < c / 16) of the 16 x c tile in registers.
constexpr int kF32Tile = 16;
constexpr int kF32Threads = 256;
constexpr int kF32MaxPer = 1024 / 16;

size_t f32_smem_bytes(int c) {
  const size_t ld = c + 4;
  return (3 * kF32Tile * ld + 2 * kF32Tile * (kF32Tile + 1) + 3 * kF32Tile) * sizeof(float);
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int n, int c, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TILE = kF32Tile;
  constexpr int LDS = TILE + 1;
  const int ld = c + 4;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + TILE * ld;
  float* Vs = Ks + TILE * ld;
  float* Ss = Vs + TILE * ld;
  float* Ps = Ss + TILE * LDS;
  float* m_s = Ps + TILE * LDS;
  float* l_s = m_s + TILE;
  float* a_s = l_s + TILE;

  const size_t base = (size_t)blockIdx.y * n * c;
  q += base;
  k += base;
  v += base;
  o += base;
  const int q0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int per = c / 16;  // O elements a thread owns

  load_tile(Qs, ld, q, q0, TILE, n, c);
  if (tid < TILE) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kF32MaxPer];
#pragma unroll
  for (int i = 0; i < kF32MaxPer; ++i) acc[i] = 0.f;

  for (int kv0 = 0; kv0 < n; kv0 += TILE) {
    __syncthreads();
    load_tile(Ks, ld, k, kv0, TILE, n, c);
    load_tile(Vs, ld, v, kv0, TILE, n, c);
    __syncthreads();
    {  // one logit per thread: row tid / 16, key tid % 16
      const int r = tid / TILE;
      const int j = tid % TILE;
      const float4* qa = reinterpret_cast<const float4*>(Qs + r * ld);
      const float4* kb = reinterpret_cast<const float4*>(Ks + j * ld);
      float s = 0.f;
      for (int i = 0; i < c / 4; ++i) {
        const float4 a = qa[i];
        const float4 b = kb[i];
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
      Ss[r * LDS + j] = s * scale;
    }
    __syncthreads();
    softmax_step<TILE>(Ss, LDS, Ps, LDS, m_s, l_s, a_s, kv0, n);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32MaxPer; ++i) {
      if (i < per) {
        const int e = tid + kF32Threads * i;
        const int r = e / c;
        const int col = e - r * c;
        float a = acc[i] * a_s[r];
#pragma unroll
        for (int j = 0; j < TILE; ++j) a = fmaf(Ps[r * LDS + j], Vs[j * ld + col], a);
        acc[i] = a;
      }
    }
  }
  store_lse<TILE>(lse, m_s, l_s, (size_t)blockIdx.y * n + q0, n - q0);
#pragma unroll
  for (int i = 0; i < kF32MaxPer; ++i) {
    if (i < per) {
      const int e = tid + kF32Threads * i;
      const int r = e / c;
      const int col = e - r * c;
      if (q0 + r < n) o[(size_t)(q0 + r) * c + col] = acc[i] / l_s[r];
    }
  }
}

// ------------------------------------------------------------------------ //
// The Hopper instance: wgmma on TMA-fed, double-buffered K/V tiles.        //
// ------------------------------------------------------------------------ //
//
// Takes bf16 with c % 128 == 0 and c <= 512: every shape of the main path
// (c = 512 at 3136 tokens) and every c up to 512 that uses_flash admits.
//
// Block: 64 query rows of one batch element; three warpgroups. Warpgroup 2
// is the producer: one thread issues every TMA load (Q once, then K and V
// tiles of 32 keys into a ring of two stages each) and setmaxnreg gives its
// registers to the consumers. Warpgroups 0 and 1 are the consumers.
//
// Head dim c = 512 is twice what stock FlashAttention takes: a 64 x 512 fp32
// O would need 256 registers a thread in one warpgroup. So O's columns are
// split: consumer w owns rows 0-63 x columns [w c/2, (w+1) c/2) of O (128
// fp32 registers a thread at c = 512), and contracts Q K^T over the same
// channel half. The two partial 64 x 32 logits tiles are exchanged through
// shared memory under a named barrier and summed; IEEE addition commutes, so
// both consumers hold the same S bit for bit and run the same online softmax
// on their own copy, with no further exchange.
//
// Products: S = Q K^T is wgmma m64n32k16 with both operands in shared memory
// (K-major); O += P V is wgmma m64n64k16 with P as the A operand straight
// from registers (the fp32 S accumulator's layout is the bf16 A fragment's,
// so P is converted in place and never touches shared memory) and V as a
// transposed (MN-major) B operand, read in place.
//
// Shared memory: Q 64 KB, K and V 2 x 2 x 32 KB, the S exchange 2 x 16 KB
// (double-buffered by iteration, so one barrier a tile suffices) at c = 512:
// 224 KB of the 227 KB a block may use. Every tile is TMA's 128-byte swizzle
// of boxes 64 channels (128 bytes) wide: a 512-channel row is 8 boxes, each
// box a stack of 1024-byte atoms of 8 rows. The 3-D tensor maps over
// (c, n, b) zero-fill rows at or past n within a batch element; keys at or
// past n are still masked to -inf.

constexpr int kWgRows = 64;   // query rows a block
constexpr int kWgKeys = 32;   // keys a stage
constexpr int kWgThreads = 384;
constexpr uint32_t kQBox = kWgRows * 128;   // bytes of a 64-row, 64-channel box
constexpr uint32_t kKVBox = kWgKeys * 128;  // bytes of a 32-row box
constexpr uint32_t kXBytes = 2 * 2 * 16 * 128 * 4;  // S exchange: 2 buffers x 2 consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int C>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                       float* __restrict__ lse, int n, float scale_log2) {
  constexpr int NBOX = C / 64;  // 64-channel boxes in a row
  constexpr int NB = NBOX / 2;  // boxes a consumer owns
  constexpr uint32_t Q_BYTES = NBOX * kQBox;
  constexpr uint32_t KV_BYTES = NBOX * kKVBox;  // one stage of K (or V)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + 2 * KV_BYTES;
  const uint32_t sx = sv + 2 * KV_BYTES;
  const uint32_t bars = sx + kXBytes;
  float* xs = reinterpret_cast<float*>(smem_raw + (sx - raw));
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 + 8 * s; };
  auto v_full = [&](int s) { return bars + 24 + 8 * s; };
  auto k_empty = [&](int s) { return bars + 40 + 8 * s; };
  auto v_empty = [&](int s) { return bars + 56 + 8 * s; };

  const int tiles = (n + kWgKeys - 1) / kWgKeys;
  const int q0 = blockIdx.x * kWgRows;
  const int batch = blockIdx.y;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 256);
      mbar_init(v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int b = 0; b < NBOX; ++b) tma_load_3d(sq + b * kQBox, &tm_q, q_full, b * 64, q0, batch);
      for (int it = 0; it < tiles; ++it) {
        const int s = it & 1;
        const uint32_t free_parity = ((it >> 1) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), KV_BYTES);  // full boxes, also where the tail is zero-filled
        for (int b = 0; b < NBOX; ++b)
          tma_load_3d(sk + s * KV_BYTES + b * kKVBox, &tm_k, k_full(s), b * 64, it * kWgKeys, batch);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int b = 0; b < NBOX; ++b)
          tma_load_3d(sv + s * KV_BYTES + b * kKVBox, &tm_v, v_full(s), b * 64, it * kWgKeys, batch);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t4 = lane & 3;
    float acc[NB][32];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

    mbar_wait(q_full, 0);
    for (int it = 0; it < tiles; ++it) {
      const int s = it & 1;
      const uint32_t parity = (it >> 1) & 1;
      // S (partial) = Q K^T over this consumer's channel half
      float sc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      mbar_wait(k_full(s), parity);
      fence_regs<16>(sc);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint32_t qa = sq + (wg * NB + b) * kQBox;
        const uint32_t kb = sk + s * KV_BYTES + (wg * NB + b) * kKVBox;
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_m64n32_ss(sc, sw128_desc(qa + 32 * k), sw128_desc(kb + 32 * k));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<16>(sc);
      mbar_arrive(k_empty(s));

      // exchange the partial tiles; thread t of either consumer holds the
      // same (row, key) positions, so each writes its registers in order
      float* mine = xs + ((it & 1) * 2 + wg) * 2048;
      const float* theirs = xs + ((it & 1) * 2 + (wg ^ 1)) * 2048;
#pragma unroll
      for (int i = 0; i < 16; ++i) mine[i * 128 + tid] = sc[i];
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] += theirs[i * 128 + tid];

      // online softmax in the log2 domain, on the accumulator layout: this
      // thread holds keys 8j + 2 t4 + {0, 1} (j < 4) of rows g and g + 8
      const int key0 = it * kWgKeys + 2 * t4;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = key0 + 8 * j + (e & 1) < n;
          sc[4 * j + e] = valid ? sc[4 * j + e] * scale_log2 : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - mn0);
      const float alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = alpha0 * l0 + sum0;  // this thread's share of the row sum
      l1 = alpha1 * l1 + sum1;
      uint32_t pa[2][4];
      p_fragments(sc, 0, pa[0]);
      p_fragments(sc, 1, pa[1]);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[b][4 * j] *= alpha0;
          acc[b][4 * j + 1] *= alpha0;
          acc[b][4 * j + 2] *= alpha1;
          acc[b][4 * j + 3] *= alpha1;
        }

      // O += P V on this consumer's columns
      mbar_wait(v_full(s), parity);
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs<32>(acc[b]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int b = 0; b < NB; ++b)
          wgmma_m64n64_rs(acc[b], pa[kk],
                          sw128_desc(sv + s * KV_BYTES + (wg * NB + b) * kKVBox + kk * 16 * 128));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int b = 0; b < NB; ++b) fence_regs<32>(acc[b]);
      mbar_arrive(v_empty(s));
    }

    // O / l, cast, store the rows that exist; lse = m ln 2 + ln l
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int r0 = q0 + warp * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    const size_t row_base = (size_t)batch * n;
    if (lse != nullptr && wg == 0 && t4 == 0) {
      if (r0 < n) lse[row_base + r0] = m0 * kLn2 + logf(l0);
      if (r1 < n) lse[row_base + r1] = m1 * kLn2 + logf(l1);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (wg * NB + b) * 64 + 8 * j + 2 * t4;
        if (r0 < n)
          *reinterpret_cast<__nv_bfloat162*>(o + (row_base + r0) * C + col) =
              __floats2bfloat162_rn(acc[b][4 * j] / l0, acc[b][4 * j + 1] / l0);
        if (r1 < n)
          *reinterpret_cast<__nv_bfloat162*>(o + (row_base + r1) * C + col) =
              __floats2bfloat162_rn(acc[b][4 * j + 2] / l1, acc[b][4 * j + 3] / l1);
      }
  }
}

template <int C>
constexpr size_t wgmma_smem_bytes() {
  // 1024 bytes of slack to align the tiles, the tiles, the exchange, 9 barriers
  return 1024 + (C / 64) * (kQBox + 4 * kKVBox) + kXBytes + 9 * 8;
}

template <int C>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int b, int n,
                 float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, b, n, C, kWgRows) || !encode_map(&tk, k, b, n, C, kWgKeys) ||
      !encode_map(&tv, v, b, n, C, kWgKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = wgmma_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWgRows - 1) / kWgRows, b);
  flash_fwd_wgmma_kernel<C><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, n, scale * kLog2e);
  return (int)cudaGetLastError();
}

bool takes_wgmma(int c) { return c % 128 == 0 && c <= 512; }

// The descriptor and fragment self-test: one warpgroup, one tile of each
// product as the Hopper instance forms it. q (64 x 128), k and v (32 x 128)
// bf16 arrive by TMA; s = q k^T (64 x 32 fp32), o = bf16(s) v with bf16(s)
// from registers (64 x 128 fp32), and o_staged = the same product with
// bf16(s) staged through shared memory as a K-major swizzled operand.
__global__ void __launch_bounds__(128, 1)
wgmma_selftest_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, float* s_out, float* o_out,
                      float* o_staged_out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;
  const uint32_t sk = sq + 2 * kQBox;
  const uint32_t sv = sk + 2 * kKVBox;
  const uint32_t sp = sv + 2 * kKVBox;  // 64 rows x 64 keys (32 used), swizzled
  const uint32_t bar = sp + kQBox;
  unsigned char* gp = smem_raw + (sp - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kQBox + 4 * kKVBox);
    for (int b = 0; b < 2; ++b) {
      tma_load_3d(sq + b * kQBox, &tm_q, bar, b * 64, 0, 0);
      tma_load_3d(sk + b * kKVBox, &tm_k, bar, b * 64, 0, 0);
      tma_load_3d(sv + b * kKVBox, &tm_v, bar, b * 64, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);

  float sc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = 0.f;
  fence_regs<16>(sc);
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n32_ss(sc, sw128_desc(sq + b * kQBox + 32 * k), sw128_desc(sk + b * kKVBox + 32 * k));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<16>(sc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1);
      const int col = 8 * j + 2 * t4 + (e & 1);
      s_out[r * 32 + col] = sc[4 * j + e];
      // bf16(s) into the staged operand, 128-byte swizzle by hand
      const uint32_t off = r * 128 + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) * 2));
      *reinterpret_cast<bf16*>(gp + off) = __float2bfloat16(sc[4 * j + e]);
    }

  uint32_t pa[2][4];
  p_fragments(sc, 0, pa[0]);
  p_fragments(sc, 1, pa[1]);
  float acc[2][32], acc2[2][32];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = acc2[b][i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, for wgmma
  __syncthreads();
  fence_regs<32>(acc[0]);
  fence_regs<32>(acc[1]);
  fence_regs<32>(acc2[0]);
  fence_regs<32>(acc2[1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint64_t vd = sw128_desc(sv + b * kKVBox + kk * 16 * 128);
      wgmma_m64n64_rs(acc[b], pa[kk], vd);
      wgmma_m64n64_ss_tb(acc2[b], sw128_desc(sp + 32 * kk), vd);
    }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(acc[0]);
  fence_regs<32>(acc[1]);
  fence_regs<32>(acc2[0]);
  fence_regs<32>(acc2[1]);
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (r0 + 8 * (e >> 1)) * 128 + b * 64 + 8 * j + 2 * t4 + (e & 1);
        o_out[idx] = acc[b][4 * j + e];
        o_staged_out[idx] = acc2[b][4 * j + e];
      }
}

bool bad_shape(int b, int n, int c) {
  return b < 1 || b > 65535 || n < 1 || c < 64 || c > 1024 || c % 64 != 0;
}

template <int TILE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                int n, int c, float scale, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes<TILE>(c);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<TILE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TILE - 1) / TILE, b);
  const dim3 block((c / 64) * 32);
  flash_fwd_bf16_kernel<TILE><<<grid, block, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, n, c, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int medvae_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int n, int c, float scale,
                                     void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  if (int err = bind_context(q, "medvae_flash_fwd_bf16")) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (takes_wgmma(c) ? c : 0) {  // the instance is chosen by c alone
    case 128: return launch_wgmma<128>(q, k, v, o, l, b, n, scale, s);
    case 256: return launch_wgmma<256>(q, k, v, o, l, b, n, scale, s);
    case 384: return launch_wgmma<384>(q, k, v, o, l, b, n, scale, s);
    case 512: return launch_wgmma<512>(q, k, v, o, l, b, n, scale, s);
    default:
      return c <= 512 ? launch_bf16<64>(q, k, v, o, l, b, n, c, scale, s)
                      : launch_bf16<32>(q, k, v, o, l, b, n, c, scale, s);
  }
}

// 1 when medvae_flash_fwd_bf16 takes the wgmma instance for head dim c, 0
// when it takes the mma.sync one.
extern "C" int medvae_flash_fwd_bf16_instance(int c) { return takes_wgmma(c) ? 1 : 0; }

// The self-test of the wgmma instance's descriptors and P fragments:
// q (64, 128), k and v (32, 128) bf16 in; s (64, 32), o and o_staged
// (64, 128) fp32 out (see wgmma_selftest_kernel).
extern "C" int medvae_flash_wgmma_selftest(const void* q, const void* k, const void* v, void* s,
                                           void* o, void* o_staged, void* stream) {
  CUtensorMap tq, tk, tv;
  if (int err = bind_context(q, "medvae_flash_wgmma_selftest")) return err;
  if (!encode_map(&tq, q, 1, kWgRows, 128, kWgRows) || !encode_map(&tk, k, 1, kWgKeys, 128, kWgKeys) ||
      !encode_map(&tv, v, 1, kWgKeys, 128, kWgKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 1024 + 3 * kQBox + 4 * kKVBox + 8;
  wgmma_selftest_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<float*>(s), static_cast<float*>(o), static_cast<float*>(o_staged));
  return (int)cudaGetLastError();
}

extern "C" int medvae_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int b, int n, int c, float scale,
                                    void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes(c);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kF32Tile - 1) / kF32Tile, b);
  flash_fwd_f32_kernel<<<grid, kF32Threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), n, c,
      scale);
  return (int)cudaGetLastError();
}
