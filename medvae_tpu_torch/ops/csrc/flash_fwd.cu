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
// What this design does about that bound: both products run on the tensor
// cores, and the (n, n) logits never leave the SM. It does not yet keep the
// tensor cores fed: loads are synchronous, one block fits an SM, and fragments
// are gathered with plain shared-memory loads. wgmma with TMA-fed,
// double-buffered K/V tiles and warp specialisation are the next design.
//
// Design (simple first):
//  * One block per (TILE query rows, batch element). The whole Q tile and one
//    TILE-row K and V tile live in padded shared memory (rows padded by 16
//    bytes so that fragment loads are bank-conflict free).
//  * The head dim c (512 here, up to 1024) is far larger than stock
//    FlashAttention's <= 256, so the fp32 O tile (TILE x c) cannot sit in one
//    warp's registers. Its channel dim is split across warps instead: warp w
//    owns columns [64w, 64w + 64) of O in registers, c / 64 warps per block.
//    TILE = 64 rows for c <= 512 (128 fp32 registers a thread, 8 warps) and 32
//    rows above (64 registers a thread, up to 16 warps), which keeps the tiles
//    inside the 227 KB of shared memory a block may use.
//  * bf16 products run on the tensor cores with mma.sync m16n8k16 (fp32
//    accumulate). The fp32 instance uses CUDA-core FMAs in full fp32 (no TF32),
//    as the JAX fp32 dot does; it is the parity path, not the serving path.
//  * Any n: the ragged last K tile is masked to -inf before the softmax, the
//    ragged last Q tile is zero-filled and not stored.
//
// C interface (bound with ctypes; returns cudaGetLastError() after the launch;
// lse may be null):
//   int medvae_flash_fwd_bf16(q, k, v, o, lse, b, n, c, scale, stream)
//   int medvae_flash_fwd_f32 (q, k, v, o, lse, b, n, c, scale, stream)

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return c <= 512 ? launch_bf16<64>(q, k, v, o, l, b, n, c, scale, s)
                  : launch_bf16<32>(q, k, v, o, l, b, n, c, scale, s);
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
