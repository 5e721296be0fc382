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
// Bound: the function needs five products of n x n x c per batch element (S,
// dP, dV, dK, dQ), 10 b n^2 c operations, against 7 (b, n, c) bf16 tensors
// and 2 (b, n) fp32 rows moved. At the flagship shape (b 32, n 3136, c 512)
// that is 1.6e12 operations over 0.72 GB, far above the H100's ~295
// operations per byte: tensor-core throughput bounds it (1.63 ms at 989
// TFLOP/s).
//
// Two instances; the Python wrapper picks one by dtype, with no
// try-and-fall-back:
//  * bf16 (every c the wrapper takes: multiples of 64 up to 1024): the Hopper
//    instance (medvae_flash_bwd_bf16, its own comment below). S and dP are
//    formed once into bf16 P and dS planes (10 b n^2 c operations, where a
//    key-tile kernel for dK/dV beside a query-tile kernel for dQ forms them
//    twice: 14), then dQ, dK and dV are wgmma products over them on TMA-fed
//    tiles.
//  * fp32: CUDA-core FMAs in full fp32 (no TF32), as the JAX fp32 dot does;
//    the parity path. B2 (dK, dV) holds a tile of 16 keys (8 above c = 512)
//    and loops over query tiles, B3 (dQ) holds a tile of queries and loops
//    over key tiles, each forming S and dP for its tile: one logit per thread,
//    each thread owning c T / 256 accumulator elements. Any n: K, V, Q and dO
//    tiles are zero-filled past n, keys past n are masked to P = 0, query rows
//    past n read lse = +inf (so P = 0) and delta = 0, and rows past n are not
//    stored.
//
// C interface (bound with ctypes; each returns cudaGetLastError() after its
// launches):
//   int medvae_flash_bwd_bf16(q, k, v, g, lse, delta, dq, dk, dv, planes, b, n, c, scale, stream)
//   int medvae_flash_bwd_f32 (q, k, v, g, lse, delta, dq, dk, dv, planes, b, n, c, scale, stream)
//   int medvae_flash_bwd_selftest(x, z, o256, o256t, o128, o128t, st, stream)
// where g is dO and planes the Hopper instance's (2, b, pad64(n), pad64(n))
// bf16 scratch (not read by the fp32 instance).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // descriptors, mbarriers, the ring, TMA, the wgmma products

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

// ---------------------------------------------------------------- fp32 ---- //

constexpr int kF32Threads = 256;
constexpr int kF32MaxPer = 32;  // accumulator elements a thread owns: T c / 256

template <int T>
size_t f32_smem_bytes(int c) {
  const size_t ld = c + 4;
  return (4 * T * ld + 2 * T * (T + 1) + 2 * T) * sizeof(float);
}

// s = q . k and dp = g . v over c in fp32 FMAs; returns p = exp(s scale -
// lse) (0 for a key past n) and ds = p (dp - delta) scale.
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

// ------------------------------------------------------------------------ //
// The Hopper instance: S and dP formed once into bf16 P and dS planes, then  //
// dQ, dK and dV as wgmma products over them (bf16, c % 64 == 0, c <= 1024).  //
// ------------------------------------------------------------------------ //
//
// The TPU kernels cast P and dS to the input type before every product that
// takes them, so two bf16 (b, np, np) planes (np = n rounded up to 64) hold
// exactly the operands those products multiply. The (2, b, np, np) scratch
// is the caller's: plane 0 is P, plane 1 dS, rows are queries and columns
// keys. Pass (a) writes every element of it, zeros outside n x n.
//
// Both passes run a persistent grid, one block of 384 threads an SM: a
// producer warpgroup whose one thread issues every TMA load into a ring of
// kBStages stages (setmaxnreg gives its registers to the others), and two
// consumer warpgroups, each of which keeps one group of wgmmas in flight
// (it releases a stage when the next one's products are issued). The ring
// runs on from tile to tile, so the next tile's loads overlap this one's
// epilogue. No atomics: every sum runs in a fixed order, so a call repeats
// bit for bit.
//
// Pass (a), a tile per (batch element, 128 query rows, 128 keys); consumer w
// owns query rows [64 w, 64 w + 64) of it against all 128 keys. A stage is
// one 64-channel chunk: the two consumers' 64-row boxes of Q (then dO) and a
// 128-row box of K (then V).
//  * S = Q K^T and dP = dO V^T: wgmma m64n128k16, both operands K-major, over
//    all of c (64 fp32 registers a thread each). Each consumer contracts the
//    full c for its own rows, so no exchange is needed.
//  * P = exp(S scale - lse), keys at or past n masked to 0; dS = P (dP -
//    delta) scale, in fp32 as the TPU kernels form them. Rows at or past n
//    read lse = +inf and delta = 0 (P = dS = 0 there). The exp is exp2f of
//    the argument times log2(e), as B1 takes it: it rounds apart from expf
//    by ~1e-6 relative, far below the bf16 cast that follows, and took a
//    call at the flagship shape from 3.19 to 2.91 ms on an H100 80GB HBM3 at
//    700 W (scripts/flash_bwd_variants.py, its `expf` variant).
//  * P and dS are cast to bf16 into the consumer's four swizzled 64 x 64
//    staging boxes and leave by TMA stores (whole 128-byte lines), which clip
//    at the planes' edge.
//
// Pass (b), a tile per (batch element, product, 128 output rows, NW output
// columns), NW = 256 where c % 256 == 0, else 128 where c % 128 == 0, else
// 64; consumer w owns output
// rows [64 w, 64 w + 64) over all NW columns (128 fp32 registers a thread at
// NW = 256). A stage is one 64-token chunk of the contraction over np: the
// two consumers' 64 x 64 boxes of a plane and NW / 64 boxes (64 tokens x 64
// channels) of the B operand. One wgmma m64nNWk16 a k16 slice:
//    dQ = dS K     A = dS rows, K-major; B = K, MN-major;
//    dK = dS^T Q   A = the dS boxes at (keys, queries) read MN-major
//                  (transposed A); B = Q, MN-major;
//    dV = P^T dO   likewise over the P plane; B = dO.
// B spans NW / 64 boxes side by side, kBox bytes apart (the descriptor's LBO).
// Rows and tokens past n are zero in both operands, so the padded chunk adds
// nothing; rows past n are not stored.
//
// Shared memory: pass (a) 4 x 32 KB of ring and 64 KB of staging, pass (b)
// 4 x 48 KB of ring at NW = 256.

constexpr int kBThreads = 384;
constexpr int kBStages = 4;
constexpr uint32_t kBox = 64 * 128;                    // a 64-row, 64-column bf16 box
constexpr int kPTile = 128;                            // pass (a): query rows and keys a tile
constexpr uint32_t kPStage = 2 * kBox + kPTile * 128;  // two 64-row boxes, one 128-row box
constexpr uint32_t kPStaging = 2 * 4 * kBox;           // per consumer: P and dS, two boxes each
constexpr int kGRows = 128;                            // pass (b): output rows a tile
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t planes_smem_bytes() { return 1024 + kBStages * kPStage + kPStaging + 2 * kBStages * 8; }

template <int NW>
__host__ __device__ constexpr uint32_t grads_stage_bytes() { return (2 + NW / 64) * kBox; }

template <int NW>
constexpr size_t grads_smem_bytes() { return 1024 + kBStages * grads_stage_bytes<NW>() + 2 * kBStages * 8; }

using BRing = Ring<kBStages>;

// Release the stage whose products were the group issued before the last
// one, once that group is done; returns the last group's stage.
__device__ __forceinline__ int retire_previous(const BRing& ring, int prev, int s) {
  if (prev >= 0) {
    wgmma_wait<1>();
    mbar_arrive(ring.empty(prev));
  }
  return s;
}

// Pass (a)'s product: d (this consumer's 64 rows x 128 keys) = X Y^T over nch
// 64-channel stages from ring position *it on.
__device__ __forceinline__ void planes_product(float* d, const BRing& ring, uint32_t stages, int nch,
                                               int wg, int* it) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  int prev = -1;
  for (int ch = 0; ch < nch; ++ch, ++*it) {
    const int s = *it % kBStages;
    mbar_wait(ring.full(s), (*it / kBStages) & 1);
    const uint32_t x = stages + s * kPStage + wg * kBox;
    const uint32_t y = stages + s * kPStage + 2 * kBox;
    fence_regs<64>(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_m64n128_ss(d, sw128_desc(x + 32 * k), sw128_desc(y + 32 * k));
    wgmma_commit();
    prev = retire_previous(ring, prev, s);
  }
  wgmma_wait<0>();
  mbar_arrive(ring.empty(prev));
  fence_regs<64>(d);
}

__global__ void __launch_bounds__(kBThreads, 1)
flash_planes_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_planes, const float* __restrict__ lse,
                    const float* __restrict__ delta, int b, int n, int nch, int tiles, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stages = (raw + 1023u) & ~1023u;
  const uint32_t staging = stages + kBStages * kPStage;
  const BRing ring{staging + kPStaging};
  const int np = pad64(n);
  const int row_tiles = (np + kPTile - 1) / kPTile;
  const int key_tiles = row_tiles;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int key0 = t % key_tiles * kPTile;
        const int m0 = t / key_tiles % row_tiles * kPTile;
        const int batch = t / key_tiles / row_tiles;
        // consumer 1's rows start past the planes only in a last tile of 64
        // rows; it then reads consumer 0's rows again and stores nothing
        const int m1 = m0 + 64 < np ? m0 + 64 : m0;
        auto issue = [&](const CUtensorMap* x, const CUtensorMap* y, int ch) {
          const int s = it % kBStages;
          mbar_wait(ring.empty(s), ((it / kBStages) & 1) ^ 1);
          const uint32_t dst = stages + s * kPStage;
          mbar_expect_tx(ring.full(s), kPStage);  // full boxes, also where zero-filled past n
          tma_load_3d(dst, x, ring.full(s), ch * 64, m0, batch);
          tma_load_3d(dst + kBox, x, ring.full(s), ch * 64, m1, batch);
          tma_load_3d(dst + 2 * kBox, y, ring.full(s), ch * 64, key0, batch);
          ++it;
        };
        for (int ch = 0; ch < nch; ++ch) issue(&tm_q, &tm_k, ch);
        for (int ch = 0; ch < nch; ++ch) issue(&tm_g, &tm_v, ch);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8 of its 64
  const uint32_t mine = staging + wg * (kPStaging / 2);  // P boxes 0, 1, then dS boxes 0, 1
  unsigned char* box = smem_raw + (mine - raw);
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int key0 = t % key_tiles * kPTile;
    const int m0 = t / key_tiles % row_tiles * kPTile + wg * 64;  // this consumer's first row
    const int batch = t / key_tiles / row_tiles;
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      row_lse[h] = row < n ? lse[(size_t)batch * n + row] : INFINITY;
      row_delta[h] = row < n ? delta[(size_t)batch * n + row] : 0.f;
    }
    float s[64];
    planes_product(s, ring, stages, nch, wg, &it);  // S = Q K^T
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_in = key0 + 8 * j + 2 * t4 + (e & 1) < n;
        s[4 * j + e] = key_in ? exp2f((s[4 * j + e] * scale - row_lse[e >> 1]) * kLog2e) : 0.f;
      }
    float d[64];
    planes_product(d, ring, stages, nch, wg, &it);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[4 * j + e] = s[4 * j + e] * (d[4 * j + e] - row_delta[e >> 1]) * scale;

    // the staging boxes are free once this consumer's last stores have read them
    if (tid == 0) tma_store_wait_read();
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 8 * j + 2 * t4;  // of the tile's 128
        unsigned char* pb = box + (key >> 6) * kBox;
        put_swizzled_pair(pb, r0 + 8 * h, key & 63, s[4 * j + 2 * h], s[4 * j + 2 * h + 1]);
        put_swizzled_pair(pb + 2 * kBox, r0 + 8 * h, key & 63, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    fence_async_shared();
    warpgroup_sync(wg);
    if (tid == 0 && m0 < np) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (key0 + 64 * x >= np) continue;
        tma_store_3d(&tm_planes, mine + x * kBox, key0 + 64 * x, m0, batch);
        tma_store_3d(&tm_planes, mine + (2 + x) * kBox, key0 + 64 * x, m0, b + batch);
      }
      tma_store_commit();
    }
  }
  if (tid == 0) tma_store_wait_all();
}

// Pass (b)'s main loop: acc (this consumer's 64 rows x NW columns) = the sum
// over the 64-token chunks of A (K-major when TA = 0, transposed when TA = 1)
// times the chunk's B boxes, from ring position *it on.
template <int NW, int TA>
__device__ __forceinline__ void grads_mainloop(float* acc, const BRing& ring, uint32_t stages, int chunks,
                                               int wg, int* it) {
  constexpr uint32_t STAGE = grads_stage_bytes<NW>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int ch = 0; ch < chunks; ++ch, ++*it) {
    const int s = *it % kBStages;
    mbar_wait(ring.full(s), (*it / kBStages) & 1);
    const uint32_t a = stages + s * STAGE + wg * kBox;
    const uint32_t bb = stages + s * STAGE + 2 * kBox;
    fence_regs<NW / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(TA ? a + kk * 2048 : a + kk * 32);
      const uint64_t db = sw128_desc(bb + kk * 2048, kBox);
      if constexpr (NW == 256) {
        wgmma_m64n256_ss_t<TA>(acc, da, db);
      } else if constexpr (NW == 128) {
        wgmma_m64n128_ss_t<TA>(acc, da, db);
      } else {
        wgmma_m64n64_ss_t<TA>(acc, da, db);  // one box: the LBO is not read
      }
    }
    wgmma_commit();
    prev = retire_previous(ring, prev, s);
  }
  wgmma_wait<0>();
  mbar_arrive(ring.empty(prev));
  fence_regs<NW / 2>(acc);
}

// Pass (b)'s tile t: the column block varies fastest, then the row tile, the
// product (0 dQ, 1 dK, 2 dV) and the batch element, so that the blocks in
// flight share a batch element's plane rows and B operand in L2.
struct GradsTile {
  int batch, product, m0, col0;
  __device__ GradsTile(int t, int np, int c, int nw) {
    const int col_blocks = c / nw;
    const int row_tiles = (np + kGRows - 1) / kGRows;
    col0 = t % col_blocks * nw;
    t /= col_blocks;
    m0 = t % row_tiles * kGRows;
    t /= row_tiles;
    product = t % 3;
    batch = t / 3;
  }
};

template <int NW>
__global__ void __launch_bounds__(kBThreads, 1)
flash_grads_kernel(const __grid_constant__ CUtensorMap tm_planes, const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_g,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int b, int n, int c,
                   int tiles) {
  constexpr uint32_t STAGE = grads_stage_bytes<NW>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stages = (raw + 1023u) & ~1023u;
  const BRing ring{stages + kBStages * STAGE};
  const int np = pad64(n);
  const int chunks = np / 64;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  int it = 0;
  if (wg == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const GradsTile tile(t, np, c, NW);
        const CUtensorMap* bmap = tile.product == 0 ? &tm_k : tile.product == 1 ? &tm_q : &tm_g;
        const int z = (tile.product == 2 ? 0 : b) + tile.batch;  // the P or the dS plane
        // as in pass (a), consumer 1 reads consumer 0's rows again where its
        // own start past the planes
        const int m1 = tile.m0 + 64 < np ? tile.m0 + 64 : tile.m0;
        for (int ch = 0; ch < chunks; ++ch, ++it) {
          const int s = it % kBStages;
          mbar_wait(ring.empty(s), ((it / kBStages) & 1) ^ 1);
          const uint32_t dst = stages + s * STAGE;
          mbar_expect_tx(ring.full(s), STAGE);
          const int t0 = ch * 64;
          if (tile.product == 0) {  // dS rows m0.., tokens (keys) t0..
            tma_load_3d(dst, &tm_planes, ring.full(s), t0, tile.m0, z);
            tma_load_3d(dst + kBox, &tm_planes, ring.full(s), t0, m1, z);
          } else {  // the plane's tokens (queries) t0.. x keys m0..
            tma_load_3d(dst, &tm_planes, ring.full(s), tile.m0, t0, z);
            tma_load_3d(dst + kBox, &tm_planes, ring.full(s), m1, t0, z);
          }
          for (int x = 0; x < NW / 64; ++x)
            tma_load_3d(dst + (2 + x) * kBox, bmap, ring.full(s), tile.col0 + 64 * x, t0, tile.batch);
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
    const GradsTile tile(t, np, c, NW);
    float acc[NW / 2];
    if (tile.product == 0) {
      grads_mainloop<NW, 0>(acc, ring, stages, chunks, wg, &it);
    } else {
      grads_mainloop<NW, 1>(acc, ring, stages, chunks, wg, &it);
    }
    bf16* out = tile.product == 0 ? dq : tile.product == 1 ? dk : dv;
    const size_t row_base = (size_t)tile.batch * n;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      const int col = tile.col0 + 8 * j + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile.m0 + wg * 64 + r0 + 8 * h;
        if (row < n) {
          *reinterpret_cast<__nv_bfloat162*>(out + (row_base + row) * c + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// The fp32 m64nN accumulator of a warpgroup to a row-major (64, N) array.
template <int N>
__device__ __forceinline__ void store_tile(float* dst, const float* acc, int r0, int t4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(r0 + 8 * (e >> 1)) * N + 8 * j + 2 * t4 + (e & 1)] = acc[4 * j + e];
}

// The self-test of the operand forms and the store path above, one
// warpgroup: x (64 x 64) and z (64 x 256) bf16 arrive by TMA;
//   o256 = x z, o256t = x^T z    m64n256k16, B MN-major over four boxes,
//   o128 = x z[:, :128], o128t = x^T z[:, :128]    m64n128k16, two boxes,
// A K-major, then MN-major (transposed), all fp32 out; and st (64 x 128 bf16)
// = bf16(o128), staged in two swizzled boxes and written by TMA stores.
__global__ void __launch_bounds__(128, 1)
flash_bwd_selftest_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_z,
                          const __grid_constant__ CUtensorMap tm_st, float* o256, float* o256t,
                          float* o128, float* o128t) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sx = (raw + 1023u) & ~1023u;
  const uint32_t sz = sx + kBox;
  const uint32_t sst = sz + 4 * kBox;
  const uint32_t bar = sst + 2 * kBox;
  unsigned char* st_box = smem_raw + (sst - raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 5 * kBox);
    tma_load_3d(sx, &tm_x, bar, 0, 0, 0);
    for (int x = 0; x < 4; ++x) tma_load_3d(sz + x * kBox, &tm_z, bar, 64 * x, 0, 0);
  }
  mbar_wait(bar, 0);
  const int lane = tid & 31, t4 = lane & 3;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  {
    float acc[128];
#pragma unroll
    for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      fence_regs<128>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = sw128_desc(sz + kk * 2048, kBox);
        if (ta) wgmma_m64n256_ss_t<1>(acc, sw128_desc(sx + kk * 2048), db);
        else wgmma_m64n256_ss_t<0>(acc, sw128_desc(sx + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<128>(acc);
      store_tile<256>(ta ? o256t : o256, acc, r0, t4);
    }
  }
  float acc[64];
#pragma unroll
  for (int ta = 0; ta < 2; ++ta) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sw128_desc(sz + kk * 2048, kBox);
      if (ta) wgmma_m64n128_ss_t<1>(acc, sw128_desc(sx + kk * 2048), db);
      else wgmma_m64n128_ss_t<0>(acc, sw128_desc(sx + kk * 32), db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(acc);
    store_tile<128>(ta ? o128t : o128, acc, r0, t4);
    if (ta == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = 8 * j + 2 * t4;
          put_swizzled_pair(st_box + (col >> 6) * kBox, r0 + 8 * h, col & 63, acc[4 * j + 2 * h],
                            acc[4 * j + 2 * h + 1]);
        }
      fence_async_shared();
      __syncthreads();
      if (tid == 0) {
        for (int x = 0; x < 2; ++x) tma_store_3d(&tm_st, sst + x * kBox, 64 * x, 0, 0);
        tma_store_commit();
        tma_store_wait_all();
      }
    }
  }
}

template <int NW>
int launch_grads(const CUtensorMap& tp, const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tg,
                 void* dq, void* dk, void* dv, int b, int n, int c, cudaStream_t stream) {
  constexpr size_t smem = grads_smem_bytes<NW>();
  cudaError_t err = cudaFuncSetAttribute(flash_grads_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)b * 3 * ((pad64(n) + kGRows - 1) / kGRows) * (c / NW);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  err = grid_blocks(tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  flash_grads_kernel<NW><<<blocks, kBThreads, smem, stream>>>(tp, tq, tk, tg, static_cast<bf16*>(dq),
                                                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                             b, n, c, (int)tiles);
  return (int)cudaGetLastError();
}

int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* g, const float* lse,
                     const float* delta, void* dq, void* dk, void* dv, void* planes, int b, int n, int c,
                     float scale, cudaStream_t stream) {
  const int np = pad64(n);
  CUtensorMap tq, tg, tk, tv, tk64, tp;
  if (!encode_map(&tq, q, b, n, c, 64) || !encode_map(&tg, g, b, n, c, 64) ||
      !encode_map(&tk, k, b, n, c, kPTile) || !encode_map(&tv, v, b, n, c, kPTile) ||
      !encode_map(&tk64, k, b, n, c, 64) || !encode_map(&tp, planes, 2 * b, np, np, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = planes_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(flash_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (np + kPTile - 1) / kPTile;
  const long long tiles = (long long)b * row_tiles * row_tiles;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  err = grid_blocks(tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  flash_planes_kernel<<<blocks, kBThreads, smem, stream>>>(tq, tk, tg, tv, tp, lse, delta, b, n, c / 64,
                                                          (int)tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (c % 256 == 0) return launch_grads<256>(tp, tq, tk64, tg, dq, dk, dv, b, n, c, stream);
  if (c % 128 == 0) return launch_grads<128>(tp, tq, tk64, tg, dq, dk, dv, b, n, c, stream);
  return launch_grads<64>(tp, tq, tk64, tg, dq, dk, dv, b, n, c, stream);
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

// The FMA instance (fp32): dk, dv (kernel B2), then dq (kernel B3); planes
// is not read.
extern "C" int medvae_flash_bwd_f32(const void* q, const void* k, const void* v, const void* g,
                                    const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                    void* planes, int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = c <= 512 ? dkv_f32<16>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s)
                           : dkv_f32<8>(q, k, v, g, lse, delta, dk, dv, b, n, c, scale, s);
  if (err != 0) return err;
  return c <= 512 ? dq_f32<16>(q, k, v, g, lse, delta, dq, b, n, c, scale, s)
                  : dq_f32<8>(q, k, v, g, lse, delta, dq, b, n, c, scale, s);
}

// The Hopper instance (bf16): dq, dk, dv from q, k, v, g, lse, delta, with
// `planes` a (2, b, pad64(n), pad64(n)) bf16 scratch the caller allocates
// (pass (a) writes all of it). Two launches, pass (a) then pass (b), on
// `stream`.
extern "C" int medvae_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* g,
                                     const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                     void* planes, int b, int n, int c, float scale, void* stream) {
  if (bad_shape(b, n, c)) return (int)cudaErrorInvalidValue;
  if (int err = bind_context(q, "medvae_flash_bwd_bf16")) return err;
  return launch_bwd_wgmma(q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta), dq,
                          dk, dv, planes, b, n, c, scale, static_cast<cudaStream_t>(stream));
}

// The self-test of the Hopper instance's operand forms and TMA stores: x
// (64, 64) and z (64, 256) bf16 in; o256, o256t (64, 256) and o128, o128t
// (64, 128) fp32 and st (64, 128) bf16 out (see flash_bwd_selftest_kernel).
extern "C" int medvae_flash_bwd_selftest(const void* x, const void* z, void* o256, void* o256t, void* o128,
                                         void* o128t, void* st, void* stream) {
  CUtensorMap tx, tz, tst;
  if (int err = bind_context(x, "medvae_flash_bwd_selftest")) return err;
  if (!encode_map(&tx, x, 1, 64, 64, 64) || !encode_map(&tz, z, 1, 64, 256, 64) ||
      !encode_map(&tst, st, 1, 64, 128, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = 1024 + 7 * kBox + 8;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_selftest_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_selftest_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tx, tz, tst, static_cast<float*>(o256), static_cast<float*>(o256t), static_cast<float*>(o128),
      static_cast<float*>(o128t));
  return (int)cudaGetLastError();
}
