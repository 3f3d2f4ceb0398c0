// Hopper (sm_90a) building blocks shared by the port's wgmma kernels
// (int8_gemm.cu, stem_gemm.cu): mbarriers with a wait that traps instead of
// hanging, 2-D TMA loads, wgmma's fences and its shared-memory descriptor of
// a K-major swizzled tile, the bf16 m64n128k16 product, and the encoding of
// 2-D tensor maps, its function looked up through the CUDA runtime (so a
// library needs no -lcuda). Each source that includes it is its own
// library, so everything here lives in an unnamed namespace.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr long long kHang = 1ll << 33;  // clock cycles (~4 s) before a wait traps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase with this parity has completed. A wait that
// lasts seconds means a broken pipeline: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kHang) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile whose rows are `sw`
// bytes (32, 64 or 128) with the `sw`-byte swizzle: 8-row groups 8 * sw bytes
// apart (SBO), LBO unused (1). Tiles start on 1024-byte boundaries (base
// offset 0); a k-step inside a row advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, int sw) {
  const uint64_t layout = sw == 128 ? 1 : sw == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sw / 2) << 32) | (layout << 62);
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

// Keeps the compiler from moving reads of an accumulator above the wait.
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D[64, 128] (+)= A[64, 16] * B[16, 128] in bf16 with float32 sums, A and B
// in shared memory; A K-major, B K-major (kTransB = 0: B's rows are N) or
// MN-major (kTransB = 1: B's rows are K, N contiguous); `acc` = 0
// overwrites D.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], uint64_t a,
                                                      uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc), "n"(kTransB)
      : "memory");
}

// D[64, N] (+)= A[64, K-step] * B[N, K-step]^T, A and B in shared memory,
// both K-major; `acc` = 0 overwrites D.
template <int N>
__device__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                int acc) {
  wgmma_m64n128k16_bf16<0>(d, a, b, acc);
}

// -- host side: tensor maps ------------------------------------------------------

// cuTensorMapEncode*, looked up through the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

template <typename F>
F driver_fn(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t rc =
      cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t rc = cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q);
#endif
  return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<F>(fn)
                                                               : nullptr;
}

constexpr int kEncodeFailed = 10000;  // + the CUresult of a failed encode

CUtensorMapSwizzle swizzle_of(int width) {
  return width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : width == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A row-major byte matrix [rows, row_bytes] cut into boxes of `width` bytes
// by box_rows rows, swizzled as wide as the box. Rows past the end load as
// zeros and are not written by a store.
int encode_2d(CUtensorMap* map, const void* p, int64_t rows, int64_t row_bytes, int width,
              int box_rows) {
  static const EncodeTiled encode = driver_fn<EncodeTiled>("cuTensorMapEncodeTiled");
  if (encode == nullptr) return kEncodeFailed;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(width),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle_of(width), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

}  // namespace
