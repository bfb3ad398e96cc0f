/*
 * Hopper (sm_90a) PTX helpers shared by the kernels that feed wgmma
 * from TMA through mbarrier rings: quantized_matmul.cu (B5) and
 * flash_attention.cu (B1, B2, B3).  Included by both sources, so each
 * library gets its own copy (anonymous namespace); ops/_build.py hashes
 * this header into every library's name, so an edit here rebuilds both.
 *
 * The tensor-map encoder is reached through the runtime
 * (cudaGetDriverEntryPoint), so nothing links libcuda.
 */

#pragma once

#include <cuda.h>   // CUtensorMap and its enums only
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transfers
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA loads (complete on an mbarrier)
// ---------------------------------------------------------------------------

// box at (c0, c1) of a rank-2 map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// box at (c0, c1, c2, c3) of a rank-4 map into shared memory
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on an mbarrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's earlier generic-proxy accesses to shared memory
// before its later async-proxy ones (a TMA or bulk write to the same place)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma's shared-memory operand, K-major: rows of 128 bytes under the
// 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)   // start address / 16
         | (uint64_t(1) << 16)                     // leading byte offset (unused here) / 16
         | (uint64_t(1024 >> 4) << 32)             // stride byte offset / 16
         | (uint64_t(1) << 62);                    // 128-byte swizzle
}

// wgmma's shared-memory operand, MN-major: each 128-byte row holds 64
// consecutive N (or M) elements of one k, under the 128-byte swizzle;
// 8-row groups of k 1024 bytes apart, blocks of 64 N elements `block`
// bytes apart
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p, uint32_t block) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4)   // start address / 16
         | (uint64_t(block >> 4) << 16)            // leading byte offset: the next 64 of N
         | (uint64_t(1024 >> 4) << 32)             // stride byte offset: the next 8 of K
         | (uint64_t(1) << 62);                    // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across it
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// operand lists of the wgmma accumulators
#define HP_D4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define HP_D16(C, i) HP_D4(C, i), HP_D4(C, i + 4), HP_D4(C, i + 8), HP_D4(C, i + 12)
#define HP_D32(C, i) HP_D16(C, i), HP_D16(C, i + 16)
#define HP_D64(C, i) HP_D32(C, i), HP_D32(C, i + 32)
#define HP_R32                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "         \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "    \
  "%31"
#define HP_R64                                                                     \
  HP_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "    \
  "%61, %62, %63"
#define HP_R128                                                                    \
  HP_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "     \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "    \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "   \
  "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, " \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"

// ---------------------------------------------------------------------------
// host side: the tensor-map encoder
// ---------------------------------------------------------------------------

// error codes of the C interfaces beyond cudaError_t
constexpr int kErrNoEncoder = 100000;       // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 200000;          // + the CUresult of the encoder

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The device a launch runs on, and whether `kernel`'s dynamic
// shared-memory limit (an attribute of the function on each device) is
// set there yet: set it once per device.  `done` is the kernel's own
// table, one flag a device.
constexpr int kMaxDevices = 64;

template <typename K>
inline cudaError_t smem_attr_per_device(K kernel, int bytes, bool (&done)[kMaxDevices],
                                        int* dev_out = nullptr) {
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r != cudaSuccess) return r;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (r != cudaSuccess) return r;
    done[dev] = true;
  }
  if (dev_out != nullptr) *dev_out = dev;
  return cudaSuccess;
}

// the SM count of device `dev`, read once per device
inline cudaError_t sm_count(int dev, int* out) {
  static int sms[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    const cudaError_t r = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (r != cudaSuccess) return r;
  }
  *out = sms[dev];
  return cudaSuccess;
}

}  // namespace
