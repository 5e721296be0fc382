// Hopper (sm_90a) building blocks shared by the port's wgmma kernels
// (flash_fwd.cu's B1 instance, flash_bwd.cu's B2/B3 instance, attention.cu's
// B4/B5 instance): shared-memory descriptors of 128-byte-swizzled tiles,
// mbarriers and a ring of them, TMA loads and stores through 3-D tensor maps,
// and the wgmma products the kernels issue. Every tile is a stack of TMA boxes
// 64 bf16 values (128 bytes) wide, so every operand is a run of 1024-byte,
// 8-row swizzle atoms.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned atom base, plus a k offset inside the 128-byte row for
// K-major operands). Every tile here is a stack of 8-row, 1024-byte atoms,
// so the stride between 8-row groups (SBO) is 1024 bytes. The other stride
// (LBO) is read only by an MN-major operand wider than one 64-value atom: it
// is the byte distance between its 64-column boxes (B2/B3's B operands of
// 128 and 256 columns). A K-major k16 step stays inside one 128-byte row and
// every other MN-major operand (B1's V; B4/B5's V, K, Q, G and the
// transposed P and dS; B2/B3's transposed P and dS) is one atom wide, so
// there it is left at 1024 bytes and never read.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait that lasts seconds traps, so a pipeline fault ends the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 28)) __trap();
  }
}

// One TMA box of a 3-D (c, n, b) map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(row), "r"(batch)
      : "memory");
}

// One TMA box of a 3-D (c, n, b) map from shared memory to device memory, in
// the issuing thread's bulk group; parts of the box past the map's bounds are
// not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int row,
                                             int batch) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(row), "r"(batch)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The issuing thread's committed stores have read their shared memory (it may
// be written again).
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// The issuing thread's committed stores are complete.
__device__ __forceinline__ void tma_store_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Make this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// moves no access to them across the issue or the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 pair (lo, hi) at (row, col), col even, of a 64 x 64 bf16 box laid
// out as TMA's 128-byte swizzle lays it (1024-byte aligned box): the 16-byte
// chunk col / 8 of row `row` sits at chunk (col / 8) ^ (row % 8).
__device__ __forceinline__ void put_swizzled_pair(unsigned char* box, int row, int col, float lo,
                                                  float hi) {
  const uint32_t off = row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) * 2));
  *reinterpret_cast<uint32_t*>(box + off) = pack_bf16(lo, hi);
}

// The bf16 A fragments of P for the k16 slice kk of a 32-key tile, from the
// fp32 m64n32 accumulator s: the accumulator's (row, column) pairs are the A
// fragment's (row, k) pairs, so this is a cast, not a shuffle.
__device__ __forceinline__ void p_fragments(const float* s, int kk, uint32_t* a) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// D(64 x 32, fp32) += A(64 x 16, smem) B(16 x 32, smem), both K-major.
__device__ __forceinline__ void wgmma_m64n32_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}
// D(64 x 64, fp32) += A(64 x 16, registers) B(16 x 64, smem, MN-major: tnspB).
__device__ __forceinline__ void wgmma_m64n64_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, smem, K-major) B(16 x 64, smem, MN-major)
// (the self-test's staged-P product).
__device__ __forceinline__ void wgmma_m64n64_ss_tb(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The launchers' own failure codes, beside cudaError_t's (all below 1000):
// the entry point of cuTensorMapEncodeTiled was not resolved, the encoder
// refused a map, or an error was pending on this thread before the launch.
// The words of the last failure on the calling thread are in
// medvae_last_failure() (below).
constexpr int kErrEntryPoint = 1001;
constexpr int kErrEncode = 1002;
constexpr int kErrStale = 1003;

thread_local char g_failure[384];

template <typename... A>
int fail(int code, const char* fmt, A... args) {
  snprintf(g_failure, sizeof(g_failure), fmt, args...);
  return code;
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no link against libcuda. The resolution's own outcome is kept, so a
// failure names it.
struct TensorMapEncoder {
  PFN_cuTensorMapEncodeTiled_v12000 fn;
  cudaError_t err;
  cudaDriverEntryPointQueryResult found;
};

const TensorMapEncoder& tensor_map_encoder() {
  static const TensorMapEncoder resolved = [] {  // resolved once, thread-safely
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    TensorMapEncoder out{nullptr, err, found};
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      out.fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
    return out;
  }();
  return resolved;
}

// At the entry of a launcher that encodes maps: when no context is current
// on the calling thread, make the primary context of the device that holds
// `ptr` current (cudaSetDevice initializes and binds it since CUDA 12); a
// thread with a current context keeps it, and its device.
// cuTensorMapEncodeTiled is a driver call and needs a current context, where
// a runtime call binds one implicitly: on a thread whose first CUDA work is a
// launcher of this library (autograd's device thread running B5 when the
// backward reached it through no PyTorch op that touched the runtime there;
// PyTorch's device guard skips cudaSetDevice when the device is already the
// thread's), the encoder returned CUDA_ERROR_INVALID_CONTEXT (201).
int bind_context(const void* ptr, const char* launcher) {
  static const PFN_cuCtxGetCurrent_v4000 current = [] {  // resolved once, thread-safely
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuCtxGetCurrent", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuCtxGetCurrent", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<PFN_cuCtxGetCurrent_v4000>(p)
                                                : nullptr;
  }();
  CUcontext ctx = nullptr;
  if (current != nullptr && current(&ctx) == CUDA_SUCCESS && ctx != nullptr) return 0;
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err == cudaSuccess) err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) {
    return fail((int)err, "%s: binding the context of the operands' device: CUDA error %d (%s)",
                launcher, (int)err, cudaGetErrorString(err));
  }
  return 0;
}

// A 3-D map over a contiguous bf16 (b, n, c) tensor, innermost first, with
// boxes of 64 channels x `rows` rows x 1 batch element, 128-byte swizzle,
// and zero fill past n, in the calling thread's context (`bind_context`).
// Returns 0, kErrEntryPoint or kErrEncode; a failure names the map (`name`)
// in medvae_last_failure().
int encode_map_named(CUtensorMap* map, const void* ptr, int b, int n, int c, int rows,
                     const char* name) {
  const TensorMapEncoder& enc = tensor_map_encoder();
  if (enc.fn == nullptr) {
    return fail(kErrEntryPoint,
                "cuTensorMapEncodeTiled was not resolved (runtime error %d, query result %d) "
                "for map %s",
                (int)enc.err, (int)enc.found, name);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)n * c * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc.fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    return fail(kErrEncode,
                "cuTensorMapEncodeTiled refused map %s (CUresult %d): address %p, dims (%d, %d, "
                "%d), box rows %d",
                name, (int)r, ptr, c, n, b, rows);
  }
  return 0;
}

bool encode_map(CUtensorMap* map, const void* ptr, int b, int n, int c, int rows) {
  return encode_map_named(map, ptr, b, n, c, rows, "(unnamed)") == 0;
}

// At a launcher's entry: kErrStale, naming the error, when a runtime error of
// this library is already pending on this thread (it would otherwise come
// back from the launch's own cudaGetLastError()), else 0.
int check_no_pending_error(const char* launcher) {
  const cudaError_t pending = cudaGetLastError();
  if (pending == cudaSuccess) return 0;
  return fail(kErrStale, "%s: runtime error %d (%s) was pending before the launch", launcher,
              (int)pending, cudaGetErrorString(pending));
}

// After a launch: the launch's cudaError_t, named in medvae_last_failure().
int launch_status(const char* kernel) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) return 0;
  return fail((int)err, "%s: launch failed: CUDA error %d (%s)", kernel, (int)err,
              cudaGetErrorString(err));
}

// D(64 x 128, fp32) += A(64 x 16, smem) B(16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_m64n128_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, smem) B(16 x 64, smem, MN-major), with A
// K-major (TA = 0) or MN-major (TA = 1: A is read transposed).
template <int TA>
__device__ __forceinline__ void wgmma_m64n64_ss_t(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// The three bf16 terms of an fp32 pair (lo, hi), each packed as a bf16x2 A
// fragment register: x = t0 + t1 + t2 with t0 = bf16(x), t1 = bf16(x - t0),
// t2 = bf16(x - t0 - t1). Each subtraction is exact in fp32, and three 8-bit
// significands carry fp32's 24, so t0 + t1 + t2 is x to within fp32 rounding.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    t[i] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

// D(64 x 128, fp32) += A(64 x 16, smem) B(16 x 128, smem, MN-major: 2 boxes of 64
// columns side by side, `lbo` bytes apart in B's descriptor), with A K-major
// (TA = 0) or MN-major (TA = 1: A is read transposed).
template <int TA>
__device__ __forceinline__ void wgmma_m64n128_ss_t(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// D(64 x 256, fp32) += A(64 x 16, smem) B(16 x 256, smem, MN-major: 4 boxes of 64
// columns side by side, `lbo` bytes apart in B's descriptor), with A K-major
// (TA = 0) or MN-major (TA = 1: A is read transposed).
template <int TA>
__device__ __forceinline__ void wgmma_m64n256_ss_t(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// Synchronise the two consumer warpgroups (threads 0-255) on named barrier 1.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// Synchronise the 128 threads of consumer warpgroup wg (0 or 1) on named
// barrier 2 + wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__host__ __device__ constexpr int pad64(int n) { return (n + 63) / 64 * 64; }

// A ring of S stages: full[s] completes when its TMA bytes land, empty[s]
// when both consumer warpgroups (256 threads) are done with it.
template <int S>
struct Ring {
  uint32_t bars;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (S + s); }
  __device__ void init() const {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The blocks of a persistent grid over `tiles` tiles: one an SM, each walking
// its tiles (kernels loop t = blockIdx.x, blockIdx.x + gridDim.x, ...).
cudaError_t grid_blocks(long long tiles, int* blocks) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = (int)(tiles < sms ? tiles : sms);
  return err;
}

}  // namespace

// The words of the last failure of a launcher of this library on the calling
// thread (each library that includes this header has its own).
extern "C" const char* medvae_last_failure() { return g_failure; }
