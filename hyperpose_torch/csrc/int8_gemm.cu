// The int8 convolution of the int8 engines, for Hopper (sm_90a): a one-pass
// quantize and one implicit-GEMM kernel on wgmma, fed by TMA, with the
// dequantize + bias epilogue fused; and the plain GEMM of the TPU probe in
// s8 -> s32 and bf16 -> f32 on the same mainloop.
//
// Replaces the Pallas TPU kernel scripts/probe_int8_pallas.py make_matmul
// (a tiled matmul in both types, accumulating in s32 / f32), which the JAX
// package's int8 convs (hyperpose_tpu/quant.py _quantized_conv) leave to
// XLA's int8 conv. Three entry points:
//
//   hp_int8_quantize: NCHW x (any strides, f32 or bf16) -> int8 NHWC
//     [B, H, W, Cp], Cp a multiple of 32 and >= C, channels >= C zero, no
//     spatial padding. q = clamp(rint(x * inv_s), +-127) in float32, the
//     order of hyperpose_tpu/quant.py:139-141. One read and one write per
//     element: 16 channels a thread with 16-byte loads where the input is
//     channels-last and aligned, else 4 a thread through the strides.
//   hp_int8_conv: C[(b, y, x), n] = sum over (dy, dx, c) of
//     Xq[b, y*sh + dy*dh - ph, x*sw + dx*dw - pw, c] * W[n, dy, dx, c], then
//     out = cast(float(C) * dq[n] + bias[n]) (each step rounded alone, the
//     order of hyperpose_tpu/quant.py:154-157), written once as [M, cout] in
//     the activation dtype. W is [Np, kh, kw, Cp] int8, Np = cout rounded up
//     to 8, zero where padded.
//   hp_int8_gemm: C[m, n] = sum_k A[m, k] * Bt[n, k] in s8 -> s32 or
//     bf16 -> f32, A [M, K] and Bt [N, K] row-major; the raw sums are stored.
//
// Design. A block is two consumer warpgroups that each own 64 rows of a
// 128-row M tile and all BN columns, and one producer warp (one thread
// issues every TMA load): 288 threads and at most 97 KB of shared memory, so
// two blocks share an SM. The grid is persistent (two blocks per SM walk
// the tiles), and the ring of stages runs on from one tile to the next, so
// the producer loads a tile while the consumers store the last one.
//
// Operands. K is cut into chunks of `width` bytes, 128 where the row allows
// it, else 64 or 32; a ring stage holds 128 bytes of K (four wgmma k-steps
// of 32 bytes: 32 s8 or 16 bf16 values) as 128 / width TMA boxes of A (128
// rows) and of B (BN rows), swizzled as wide as the box: the layout wgmma
// reads K-major (int8 has no transposed form), a k-step inside a row
// advancing the descriptor by 32 bytes. TMA issues a box row by row, so a
// 32-byte row costs about what a 128-byte one does: wide boxes move bytes
// several times faster. For the conv a chunk is one filter tap and
// `width` channels (Int8Conv2d pads cin to a multiple of the widest box
// that costs at most 15% more channels, and folds the taps of a conv on at
// most 16 channels into the channels), and A comes by TMA's im2col mode:
// the box walks 128 consecutive output pixels of the flattened (b, y, x)
// at the conv's stride from the tile's first pixel, offset by the tap, and
// the hardware fills every pixel outside the image with zeros. That
// replaces the padded buffer and the explicit im2col of the plain path.
// Each stage's loads complete on an mbarrier ("full"); each consumer
// warpgroup signals an "empty" mbarrier once its wgmmas of the stage have
// read it, keeping one wgmma group in flight. The epilogue runs in
// registers: s32 -> f32, * dq[n], + bias[n], the cast, stores masked to the
// real rows and columns. Where N is a multiple of 8, each lane quad
// transposes its 8-column blocks with shuffles so that every lane stores
// 16-byte words (whole 32-byte sectors across the quad); otherwise (cout
// 19, 38: rows not 16-byte aligned, so no TMA store either) 4- and 8-byte
// pieces.
//
// Tiles. BN is the smallest wgmma width that covers cout among 24, 32, 48,
// 64 (s8 wgmma has no n40), else 128; where 128 leaves fewer tiles than two
// waves of 132 SMs (the probe's M = 4096 and N = 256: 64 tiles), BN drops
// to 64, which doubles the tiles. The M tile stays 128 rows (two
// warpgroups).
//
// Bound. The conv reads its int8 input (channels padded) once, the weights
// once and writes its output once in the activation dtype; the 40 convs of
// the flagship at 368x432, batch 8 move about 1.06 GB with a bf16 output
// (0.32 ms at 3.35 TB/s) against 539 G operations (0.272 ms at 1,979
// TOP/s): bytes and operations are close, so the design keeps the tensor
// cores fed from shared memory and touches device memory once per operand.
// The probe's GEMM, (4096, 1792) @ (1792, 256), is bound by bytes: 0.0036
// ms (s8) and 0.0059 ms (bf16).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kBM = 128;           // output rows per tile: two warpgroups of 64
constexpr int kStageK = 128;       // bytes of K per ring stage: 4 wgmma k-steps of 32
constexpr int kThreads = 288;      // warpgroups 0 and 1 consume, warp 8 produces
constexpr int kBlocksPerSM = 2;
constexpr int kAStage = kBM * kStageK;  // 16 KB

template <int BN>
__host__ __device__ constexpr int stages() {  // at most 96 KB of ring: two blocks fit an SM
  return BN <= 64 ? 4 : 3;
}

template <int BN>
constexpr int smem_bytes() {
  return stages<BN>() * (kAStage + BN * kStageK) + 2 * stages<BN>() * 8 + 1024;
}

// One im2col box: 128 pixels of 32 channels from (c, w, h, n), the filter
// tap at offsets (ow, oh).
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h, int n,
                                           uint16_t ow, uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(ow), "h"(oh)
      : "memory");
}

// D[64, N] (+)= A[64, K-step] * B[N, K-step]^T, A and B in shared memory,
// both K-major; `acc` = 0 overwrites D.
template <int N>
__device__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_s8<24>(int (&d)[12], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int (&d)[24], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<24>(float (&d)[12], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}
template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc)
      : "memory");
}


// -- the quantize pass ---------------------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t quantize1(float v, float inv_s) {
  const int q = __float2int_rn(fminf(fmaxf(rintf(__fmul_rn(v, inv_s)), -127.0f), 127.0f));
  return static_cast<uint32_t>(q) & 0xffu;
}

// One thread per (pixel, 4 output channels): four int8 values, one 4-byte
// store. Consecutive threads take consecutive channels of a pixel, so a
// channels-last input is read in order.
template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(
    const T* __restrict__ x, uint32_t* __restrict__ out, int64_t n_groups, int C,
    int groups, int H, int W, int64_t sb, int64_t sc, int64_t sh, int64_t sw,
    float inv_s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  const int64_t p = i / groups;
  const int c0 = static_cast<int>(i - p * groups) * 4;
  const int w = static_cast<int>(p % W);
  const int64_t t = p / W;
  const int h = static_cast<int>(t % H);
  const T* src = x + (t / H) * sb + h * sh + w * sw;
  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + k;
    if (c < C) packed |= quantize1(widen(src[c * sc]), inv_s) << (8 * k);
  }
  out[i] = packed;
}

// The conv whose filter taps a folding quantize lays out along the channels.
struct Fold {
  int ho, wo, kh, kw, sh, sw, ph, pw, dh, dw;
};

// The quantize of a conv with few input channels, folded: output pixel
// (b, yo, xo) gets the K = kh * kw * C values its filter reads, in (dy, dx,
// c) order (zero outside the image and from K up to Cp), so the conv runs
// as 1x1 over Cp channels. One thread per (output pixel, 16 values): it
// walks (dy, dx, c) from its first value and stores 16 bytes.
template <typename T>
__global__ void __launch_bounds__(256) quantize_fold_kernel(
    const T* __restrict__ x, uint4* __restrict__ out, int64_t n_groups, int C, int groups,
    int H, int W, int64_t sb, int64_t sc, int64_t sh, int64_t sw, Fold f, float inv_s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  const int64_t p = i / groups;
  const int k0 = static_cast<int>(i - p * groups) * 16, k_end = f.kh * f.kw * C;
  const int xo = static_cast<int>(p % f.wo);
  const int64_t t = p / f.wo;
  const int yo = static_cast<int>(t % f.ho);
  const T* img = x + (t / f.ho) * sb;
  int tap = k0 / C, c = k0 - tap * C;
  int dy = tap / f.kw, dx = tap - dy * f.kw;
  uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k0 + k >= k_end) break;
    const int y = yo * f.sh + dy * f.dh - f.ph, xx = xo * f.sw + dx * f.dw - f.pw;
    if (y >= 0 && y < H && xx >= 0 && xx < W) {
      word[k / 4] |= quantize1(widen(img[c * sc + y * sh + xx * sw]), inv_s) << (8 * (k % 4));
    }
    if (++c == C) {
      c = 0;
      if (++dx == f.kw) {
        dx = 0;
        ++dy;
      }
    }
  }
  out[i] = make_uint4(word[0], word[1], word[2], word[3]);
}

// 16 channels of a 16-byte-aligned run, widened to float32.
__device__ __forceinline__ void load16(const float* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&word[k]);
      v[8 * i + 2 * k] = __low2float(b);
      v[8 * i + 2 * k + 1] = __high2float(b);
    }
  }
}

// The same pass for a channels-last input whose pixels start on 16-byte
// boundaries and whose C is a multiple of 16: one thread per (pixel, 16
// output channels), 16-byte loads and one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(256) quantize16_kernel(
    const T* __restrict__ x, uint4* __restrict__ out, int64_t n_groups, int C, int groups,
    int H, int W, int64_t sb, int64_t sh, int64_t sw, float inv_s) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_groups) return;
  const int64_t p = i / groups;
  const int c0 = static_cast<int>(i - p * groups) * 16;
  uint32_t word[4] = {0, 0, 0, 0};
  if (c0 < C) {
    const int w = static_cast<int>(p % W);
    const int64_t t = p / W;
    const int h = static_cast<int>(t % H);
    float v[16];
    load16(x + (t / H) * sb + h * sh + w * sw + c0, v);
#pragma unroll
    for (int k = 0; k < 16; ++k) word[k / 4] |= quantize1(v[k], inv_s) << (8 * (k % 4));
  }
  out[i] = make_uint4(word[0], word[1], word[2], word[3]);
}

// -- the implicit-GEMM mainloop ------------------------------------------------

struct ConvGeometry {  // the conv's shape; unused by the plain GEMM
  int ho, wo, kw, slices, sh, sw, ph, pw, dh, dw;
};

// How K is cut: `chunks` boxes of `width` bytes (32, 64 or 128; for the conv
// one filter tap and one slice of `width` channels each), kStageK / width of
// them per ring stage.
struct KSplit {
  int chunks, width;
};

struct Epilogue {
  void* out;          // [M, N]: s32 / f32 sums (GEMM) or the conv's output
  const float* dq;    // conv: [N] s_w * s_in
  const float* bias;  // conv: [N] or null
  int64_t M;
  int N;
  int out_bf16;       // conv: 1 -> bf16 output, 0 -> f32
};

__device__ __forceinline__ void store2(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
}
__device__ __forceinline__ void store1(int* p, int v) { *p = v; }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Columns n, n + 1 of row m, each where it lies inside [M, N]; a pair is one
// store when N is even (n is, so the pair is aligned).
template <typename T, typename V>
__device__ __forceinline__ void store_pair(T* out, const Epilogue& e, int64_t m, int n,
                                           V v0, V v1) {
  if (m >= e.M || n >= e.N) return;
  T* p = out + m * e.N + n;
  if (n + 1 >= e.N) {
    store1(p, v0);
  } else if ((e.N & 1) == 0) {
    store2(p, v0, v1);
  } else {
    store1(p, v0);
    store1(p + 1, v1);
  }
}

// The conv's epilogue of one sum: s32 -> f32, * dq[n], + bias[n], each
// rounded alone (no FMA).
__device__ __forceinline__ float dequantize(int acc, int n, const Epilogue& e) {
  if (n >= e.N) return 0.0f;
  const float v = __fmul_rn(__int2float_rn(acc), e.dq[n]);
  return e.bias != nullptr ? __fadd_rn(v, e.bias[n]) : v;
}

// One butterfly step of a 4 x 4 transpose across the 4 lanes of a quad:
// the lane exchanges with lane ^ bit the two elements whose index differs
// from its own lane index in that bit. Two steps (bit 1, then 2) leave in
// element i of lane q what element q of lane i held.
template <int kBit, typename V>
__device__ __forceinline__ void quad_step(V (&p)[4], int lane) {
  const bool hi = (lane & kBit) != 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    constexpr int kStride = kBit == 1 ? 2 : 1;
    const int lo = k * kStride, up = lo + kBit;
    const V got = __shfl_xor_sync(0xffffffffu, hi ? p[lo] : p[up], kBit);
    if (hi) {
      p[lo] = got;
    } else {
      p[up] = got;
    }
  }
}

// Eight consecutive values (a[i], b[i] at columns 2i, 2i + 1) as 16 bytes
// (bf16) or 2 x 16 bytes.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&a)[4],
                                       const float (&b)[4]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v =
        __halves2bfloat162(__float2bfloat16_rn(a[i]), __float2bfloat16_rn(b[i]));
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&a)[4], const float (&b)[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(a[0], b[0], a[1], b[1]);
  reinterpret_cast<float4*>(p)[1] = make_float4(a[2], b[2], a[3], b[3]);
}
__device__ __forceinline__ void store8(int* p, const int (&a)[4], const int (&b)[4]) {
  reinterpret_cast<int4*>(p)[0] = make_int4(a[0], b[0], a[1], b[1]);
  reinterpret_cast<int4*>(p)[1] = make_int4(a[2], b[2], a[3], b[3]);
}

template <int BN, bool kBf16, bool kConv>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) igemm_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
    KSplit k, int n_tiles, int tiles, ConvGeometry g, Epilogue e) {
  using Acc = typename std::conditional<kBf16, float, int>::type;
  constexpr int kStages = stages<BN>();
  constexpr uint32_t kBStage = BN * kStageK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_smem = a_smem + kStages * kAStage;
  const uint32_t bars = b_smem + kStages * kBStage;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int per_stage = kStageK / k.width;
  const int n_iters = (k.chunks + per_stage - 1) / per_stage;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: block b takes tiles b, b + gridDim.x, ... (M-major, so the
  // blocks in flight share A rows in L2). The ring runs on across tiles, so
  // the producer loads a tile's first stages while the consumers store the
  // previous tile.
  if (threadIdx.x >= 256) {
    // Producer: one thread of warp 8 keeps the ring full.
    if (threadIdx.x != 256) return;
    int ring = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * kBM;
      const int n0 = (tile % n_tiles) * BN;
      int img = 0, y0 = 0, x0 = 0;
      if constexpr (kConv) {
        const int64_t per_img = static_cast<int64_t>(g.ho) * g.wo;
        img = static_cast<int>(m0 / per_img);
        const int r = static_cast<int>(m0 - img * per_img);
        y0 = (r / g.wo) * g.sh - g.ph;
        x0 = (r % g.wo) * g.sw - g.pw;
      }
      for (int it = 0; it < n_iters; ++it, ++ring) {
        const int s = ring % kStages;
        mbar_wait(empty(s), ((ring / kStages) & 1) ^ 1);
        // Every stage holds kStageK bytes of K, so the consumers' loop has
        // no branch: past the last chunk, B is loaded beyond K (TMA fills
        // zeros) and so is the GEMM's A; the conv's A slot is left as it is
        // (int8, so whatever it holds times B's zeros adds exactly 0).
        const int nk = min(per_stage, k.chunks - it * per_stage);
        mbar_expect_tx(full(s), per_stage * BN * k.width +
                                    (kConv ? nk : per_stage) * kBM * k.width);
        for (int u = 0; u < per_stage; ++u) {
          const int q = it * per_stage + u;
          const uint32_t da = a_smem + s * kAStage + u * kBM * k.width;
          const uint32_t db = b_smem + s * kBStage + u * BN * k.width;
          if constexpr (kConv) {
            if (u < nk) {
              const int tap = q / g.slices;
              const int dy = tap / g.kw, dx = tap - dy * g.kw;
              tma_im2col(da, &tma_a, full(s), (q - tap * g.slices) * k.width, x0, y0, img,
                         static_cast<uint16_t>(dx * g.dw), static_cast<uint16_t>(dy * g.dh));
            }
          } else {
            tma_2d(da, &tma_a, full(s), q * k.width, static_cast<int>(m0));
          }
          tma_2d(db, &tma_b, full(s), q * k.width, n0);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile.
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int steps_per_box = k.width / 32;
  int ring = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * kBM;
    const int n0 = (tile % n_tiles) * BN;
    Acc acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    for (int it = 0; it < n_iters; ++it, ++ring) {
      const int s = ring % kStages;
      mbar_wait(full(s), (ring / kStages) & 1);
      __syncwarp();  // the spin may leave the warp diverged; wgmma wants it whole
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kStageK / 32; ++j) {
        const int u = j / steps_per_box;
        const uint32_t off = (j - u * steps_per_box) * 32;
        const uint64_t da = desc_k_major(
            a_smem + s * kAStage + (u * kBM + c * 64) * k.width + off, k.width);
        const uint64_t db = desc_k_major(b_smem + s * kBStage + u * BN * k.width + off,
                                         k.width);
        if constexpr (kBf16) {
          wgmma_bf16<BN>(acc, da, db, 1);
        } else {
          wgmma_s8<BN>(acc, da, db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free its slot
      if (it > 0 && t == 0) mbar_arrive(empty((ring - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if (t == 0) mbar_arrive(empty((ring - 1) % kStages));

    // Accumulator 4j + 2h + {0, 1} of a thread: row 16 * warp + lane / 4 + 8h
    // of the warpgroup's 64, columns 8j + 2 * (lane % 4) + {0, 1}.
    const int64_t row = m0 + 64 * c + 16 * (t / 32) + lane / 4;
    if (BN % 32 == 0 && e.N % 8 == 0) {
      // Rows of 16-byte-aligned groups of 8 columns: transpose each group of
      // four 8-column blocks across the quad, so that lane q holds all 8
      // columns of block 4g + q, and store them as whole 16-byte words
      // (whole 32-byte sectors across the quad) instead of 4- and 8-byte
      // pieces.
      const int q = lane & 3;
#pragma unroll
      for (int g = 0; g < BN / 32; ++g) {
        const int n = n0 + 8 * (4 * g + q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t m = row + 8 * h;
          using V = typename std::conditional<kConv, float, Acc>::type;
          V a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * g + i;
            if constexpr (kConv) {
              a[i] = dequantize(acc[4 * j + 2 * h], n0 + 8 * j + 2 * q, e);
              b[i] = dequantize(acc[4 * j + 2 * h + 1], n0 + 8 * j + 2 * q + 1, e);
            } else {
              a[i] = acc[4 * j + 2 * h];
              b[i] = acc[4 * j + 2 * h + 1];
            }
          }
          quad_step<1>(a, lane);
          quad_step<1>(b, lane);
          quad_step<2>(a, lane);
          quad_step<2>(b, lane);
          if (m >= e.M || n >= e.N) continue;
          if constexpr (!kConv) {
            store8(static_cast<Acc*>(e.out) + m * e.N + n, a, b);
          } else if (e.out_bf16) {
            store8(static_cast<__nv_bfloat16*>(e.out) + m * e.N + n, a, b);
          } else {
            store8(static_cast<float*>(e.out) + m * e.N + n, a, b);
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = row + 8 * h;
        const Acc v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (!kConv) {
          store_pair(static_cast<Acc*>(e.out), e, m, n, v0, v1);
        } else if (e.out_bf16) {
          store_pair(static_cast<__nv_bfloat16*>(e.out), e, m, n, dequantize(v0, n, e),
                     dequantize(v1, n + 1, e));
        } else {
          store_pair(static_cast<float*>(e.out), e, m, n, dequantize(v0, n, e),
                     dequantize(v1, n + 1, e));
        }
      }
    }
  }
}

// -- host side -----------------------------------------------------------------

// cuTensorMapEncodeIm2col, looked up through the CUDA runtime.
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*,
                                  const int*, cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The widest box (128, 64 or 32 bytes) that divides a row of `bytes`.
int box_width(int64_t bytes) { return bytes % 128 == 0 ? 128 : bytes % 64 == 0 ? 64 : 32; }

template <int BN, bool kBf16, bool kConv>
int launch(const CUtensorMap& a, const CUtensorMap& b, KSplit k, const ConvGeometry& g,
           const Epilogue& e, cudaStream_t stream) {
  const int n_tiles = (e.N + BN - 1) / BN;
  const int64_t tiles = (e.M + kBM - 1) / kBM * n_tiles;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = igemm_kernel<BN, kBf16, kConv>;
  static int sms = 0;  // per instantiation; the process drives one model of card
  if (sms == 0) {
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) {
      rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes<BN>());
    }
    if (rc != cudaSuccess) {
      sms = 0;
      return static_cast<int>(rc);
    }
  }
  const int64_t blocks = std::min<int64_t>(tiles, static_cast<int64_t>(sms) * kBlocksPerSM);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem_bytes<BN>(), stream>>>(
      a, b, k, n_tiles, static_cast<int>(tiles), g, e);
  return static_cast<int>(cudaGetLastError());
}

// The wgmma width for N output columns: the smallest of 24, 32, 48, 64 that
// covers N (s8 wgmma has no n40), else 128, or 64 where 128 would leave
// fewer tiles than two waves of 132 SMs (the probe's M = 4096, N = 256).
int pick_bn(int64_t M, int N) {
  if (N <= 24) return 24;
  if (N <= 32) return 32;
  if (N <= 48) return 48;
  if (N <= 64) return 64;
  return (M + kBM - 1) / kBM * ((N + 127) / 128) < 132 * kBlocksPerSM ? 64 : 128;
}

template <bool kBf16, bool kConv>
int dispatch(int bn, const CUtensorMap& a, const CUtensorMap& b, KSplit k,
             const ConvGeometry& g, const Epilogue& e, cudaStream_t s) {
  switch (bn) {
    case 24: return launch<24, kBf16, kConv>(a, b, k, g, e, s);
    case 32: return launch<32, kBf16, kConv>(a, b, k, g, e, s);
    case 48: return launch<48, kBf16, kConv>(a, b, k, g, e, s);
    case 64: return launch<64, kBf16, kConv>(a, b, k, g, e, s);
    default: return launch<128, kBf16, kConv>(a, b, k, g, e, s);
  }
}

}  // namespace

// x: NCHW [B, C, H, W] with element strides (sb, sc, sh, sw), float32
// (bf16 == 0) or bfloat16; out: contiguous int8 [B, H, W, Cp], Cp a
// multiple of 32 and >= C. With a conv geometry other than 1x1, stride 1,
// no padding (kh, kw, strides, pads, dilations), the taps are folded: out
// is [B, Ho, Wo, Cp] with Cp >= kh * kw * C (see quantize_fold_kernel).
// Returns cudaGetLastError() after the launch.
extern "C" int hp_int8_quantize(const void* x, void* out, int B, int C, int H, int W,
                                int64_t sb, int64_t sc, int64_t sh, int64_t sw, int Cp,
                                int kh, int kw, int st_h, int st_w, int ph, int pw, int dh,
                                int dw, float inv_s, int bf16, void* stream) {
  if (B < 0 || C < 0 || H < 0 || W < 0 || Cp % 32 || kh <= 0 || kw <= 0 || st_h <= 0 ||
      st_w <= 0 || ph < 0 || pw < 0 || dh <= 0 || dw <= 0 ||
      Cp < static_cast<int64_t>(kh) * kw * C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh != 1 || kw != 1 || st_h != 1 || st_w != 1 || ph != 0 || pw != 0) {
    if (H + 2 * ph <= dh * (kh - 1) || W + 2 * pw <= dw * (kw - 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const Fold f{(H + 2 * ph - dh * (kh - 1) - 1) / st_h + 1,
                 (W + 2 * pw - dw * (kw - 1) - 1) / st_w + 1,
                 kh, kw, st_h, st_w, ph, pw, dh, dw};
    const int64_t n_groups = static_cast<int64_t>(B) * f.ho * f.wo * (Cp / 16);
    if (n_groups == 0) return static_cast<int>(cudaGetLastError());
    if (C == 0) return static_cast<int>(cudaMemsetAsync(out, 0, 16 * n_groups, s));
    const int64_t blocks = (n_groups + 255) / 256;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    uint4* o = static_cast<uint4*>(out);
    if (bf16) {
      quantize_fold_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), o, n_groups, C, Cp / 16, H, W, sb, sc, sh, sw,
          f, inv_s);
    } else {
      quantize_fold_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
          static_cast<const float*>(x), o, n_groups, C, Cp / 16, H, W, sb, sc, sh, sw, f,
          inv_s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t es = bf16 ? 2 : 4;
  const bool vec = sc == 1 && C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (sb * es) % 16 == 0 && (sh * es) % 16 == 0 && (sw * es) % 16 == 0;
  const int per = vec ? 16 : 4;  // output channels per thread
  const int64_t n_groups = static_cast<int64_t>(B) * H * W * (Cp / per);
  if (n_groups == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n_groups + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec && bf16) {
    quantize16_kernel<<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                           static_cast<uint4*>(out), n_groups, C, Cp / 16, H,
                                           W, sb, sh, sw, inv_s);
  } else if (vec) {
    quantize16_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                           static_cast<uint4*>(out), n_groups, C, Cp / 16, H,
                                           W, sb, sh, sw, inv_s);
  } else if (bf16) {
    quantize_kernel<<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                         static_cast<uint32_t*>(out), n_groups, C, Cp / 4, H,
                                         W, sb, sc, sh, sw, inv_s);
  } else {
    quantize_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(x),
                                         static_cast<uint32_t*>(out), n_groups, C, Cp / 4, H,
                                         W, sb, sc, sh, sw, inv_s);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq: contiguous int8 [B, H, W, Cp]; w: contiguous int8 [Np, kh, kw, Cp];
// dq, bias (or null): float32 [cout]; out: contiguous [M, cout], M = B * Ho
// * Wo, bfloat16 (out_bf16 != 0) or float32. Cp a multiple of 32, Np of 8,
// cout <= Np, pointers 16-byte aligned. Returns cudaGetLastError() after the
// launch, or 10000 + the CUresult of a tensor map that failed to encode.
extern "C" int hp_int8_conv(const void* xq, const void* w, const float* dq, const float* bias,
                            void* out, int B, int H, int W, int Cp, int Np, int kh, int kw,
                            int sh, int sw, int ph, int pw, int dh, int dw, int cout,
                            int out_bf16, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 32 || Np % 8 || cout <= 0 || cout > Np ||
      kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || sh > 8 || sw > 8 || ph < 0 || pw < 0 ||
      dh <= 0 || dw <= 0 || (kh - 1) * dh > 255 || (kw - 1) * dw > 255 || ph > 127 ||
      pw > 127) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H + 2 * ph <= dh * (kh - 1) || W + 2 * pw <= dw * (kw - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the filter outgrows the padded image
  }
  const int ho = (H + 2 * ph - dh * (kh - 1) - 1) / sh + 1;
  const int wo = (W + 2 * pw - dw * (kw - 1) - 1) / sw + 1;
  const int64_t M = static_cast<int64_t>(B) * ho * wo;
  if (M == 0) return static_cast<int>(cudaGetLastError());

  static const EncodeIm2col encode = driver_fn<EncodeIm2col>("cuTensorMapEncodeIm2col");
  if (encode == nullptr) return kEncodeFailed;
  CUtensorMap map_a, map_b;
  // A k-chunk is one filter tap and `width` channels; the im2col box is 128
  // output pixels of those channels. Dimensions innermost first (C, W, H,
  // N); the bounding box of the filter's first tap runs from -pad to the
  // last position whose last tap is still inside the padded image, walked
  // at the conv's stride.
  const int width = box_width(Cp);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Cp), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(Cp),
                                 static_cast<cuuint64_t>(Cp) * W,
                                 static_cast<cuuint64_t>(Cp) * W * H};
  const int lower[2] = {-pw, -ph};
  const int upper[2] = {pw - dw * (kw - 1), ph - dh * (kh - 1)};
  const cuuint32_t traversal[4] = {1, static_cast<cuuint32_t>(sw), static_cast<cuuint32_t>(sh), 1};
  CUresult r = encode(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(xq), dims,
                      strides, lower, upper, static_cast<cuuint32_t>(width), kBM, traversal,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(width),
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  const int bn = pick_bn(M, cout);
  const int k_bytes = kh * kw * Cp;
  const int rc = encode_2d(&map_b, w, Np, k_bytes, width, bn);
  if (rc != 0) return rc;
  const ConvGeometry g{ho, wo, kw, Cp / width, sh, sw, ph, pw, dh, dw};
  const Epilogue e{out, dq, bias, M, cout, out_bf16};
  return dispatch<false, true>(bn, map_a, map_b, KSplit{k_bytes / width, width}, g, e,
                               static_cast<cudaStream_t>(stream));
}

// a: [M, K], bt: [N, K], both row-major, contiguous and 16-byte aligned,
// int8 (bf16 == 0) or __nv_bfloat16 (bf16 != 0); c: contiguous [M, N],
// int32 or float. K must be a multiple of 32 (int8) or 16 (bf16). Returns
// cudaGetLastError() after the launch, or 10000 + the CUresult of a tensor
// map that failed to encode.
extern "C" int hp_int8_gemm(const void* a, const void* bt, void* c, int64_t M, int N, int K,
                            int bf16, void* stream) {
  const int64_t kb = static_cast<int64_t>(K) * (bf16 ? 2 : 1);
  if (M < 0 || N < 0 || K < 0 || kb % 32 || kb / 32 > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0 || K == 0) {
    if (M > 0 && N > 0) {  // an empty sum
      const cudaError_t rc = cudaMemsetAsync(c, 0, static_cast<size_t>(M) * N * 4,
                                             static_cast<cudaStream_t>(stream));
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bn = pick_bn(M, N), width = box_width(kb);
  CUtensorMap map_a, map_b;
  int rc = encode_2d(&map_a, a, M, kb, width, kBM);
  if (rc == 0) rc = encode_2d(&map_b, bt, N, kb, width, bn);
  if (rc != 0) return rc;
  const ConvGeometry g{};
  const Epilogue e{c, nullptr, nullptr, M, N, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KSplit k{static_cast<int>(kb / width), width};
  return bf16 ? dispatch<true, false>(bn, map_a, map_b, k, g, e, s)
              : dispatch<false, false>(bn, map_a, map_b, k, g, e, s);
}
