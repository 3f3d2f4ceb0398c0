// The int8 depthwise convolution of the int8 engines, for Hopper (sm_90a).
//
// What it computes is the JAX package's int8 conv (hyperpose_tpu/quant.py
// _quantized_conv) with feature_group_count = C: each channel convolved with
// its own taps, s8 x s8 summed in s32, then out = cast(float(sum) * dq[c] +
// bias[c]), each step rounded alone (the order of quant.py:154-157). Its
// input is the buffer the quantize pass of int8_gemm.cu writes.
//
//   hp_int8_dwconv: Xq int8 [B, H, W, Cp] (Cp a multiple of 32, channels >=
//     C zero), W int8 [kh * kw, Cp] (tap-major, channels contiguous, zero
//     beyond C), dq and bias float32 [C] -> out [B * Ho * Wo, C] in bf16 or
//     f32, rows (b, y, x), the layout of hp_int8_conv's output.
//
// Design (a simple, correct first form; PyTorch has no int8 depthwise conv
// on CUDA). A thread owns one output pixel and 16 channels: per filter tap
// one 16-byte load of the input (the 16 channels of one pixel), skipped
// where the tap falls in the zero border, and 16 s32 multiply-adds against
// the tap's 16 weights, which sit in shared memory. A block is 256 threads:
// `cg` channel groups (8, 4 or 2, the largest that divides Cp / 16) times
// 256 / cg pixels, so the threads of one pixel read one run of 16 * cg
// contiguous bytes; blockIdx.y walks the channel groups, so a block stages
// only its slice of the taps, dq and bias. The epilogue dequantizes in
// registers and stores 16-byte words where C is a multiple of 16 (and the
// output aligned), else one value at a time; a thread whose group lies
// wholly in the channel padding (C <= c < Cp) does nothing.
//
// Bound. The layer reads its int8 input once, writes its output once in the
// activation dtype and reads the taps, dq and bias once; its 2 * M * C * kh *
// kw integer operations run outside the tensor cores. At these widths the
// bytes bind (tests/torch_measures.py int8_dwconv_work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

struct Geometry {
  int H, W, Cp, C, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw;
};

__device__ __forceinline__ void mac16(int (&acc)[16], const uint4& x, const uint4& w) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int xv = static_cast<int8_t>(xs[i] >> (8 * b));
      const int wv = static_cast<int8_t>(ws[i] >> (8 * b));
      acc[4 * i + b] += xv * wv;
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
    const float* __restrict__ dq, const float* __restrict__ bias, void* __restrict__ out,
    int64_t n_pixels, Geometry g, int cg, bool vec_store) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nc = 16 * cg;                       // channels of this block
  const int taps = g.kh * g.kw;
  uint4* s_w = reinterpret_cast<uint4*>(smem);  // [taps][cg] 16-byte words
  float* s_dq = reinterpret_cast<float*>(smem + static_cast<size_t>(taps) * nc);
  float* s_bias = s_dq + nc;
  const int c0 = blockIdx.y * nc;
  for (int i = threadIdx.x; i < taps * cg; i += kThreads) {
    const int t = i / cg, j = i % cg;
    s_w[i] = *reinterpret_cast<const uint4*>(w + static_cast<int64_t>(t) * g.Cp + c0 + 16 * j);
  }
  for (int i = threadIdx.x; i < nc; i += kThreads) {
    const int c = c0 + i;
    s_dq[i] = c < g.C ? dq[c] : 0.f;
    s_bias[i] = c < g.C && bias != nullptr ? bias[c] : 0.f;
  }
  __syncthreads();

  const int j = threadIdx.x % cg;
  const int cl = 16 * j;          // first channel of the thread, in the block
  const int c = c0 + cl;          // and in the layer
  const int64_t p = static_cast<int64_t>(blockIdx.x) * (kThreads / cg) + threadIdx.x / cg;
  if (p >= n_pixels || c >= g.C) return;  // past the end, or wholly in the channel padding
  const int x = static_cast<int>(p % g.wo);
  const int64_t r = p / g.wo;
  const int y = static_cast<int>(r % g.ho);
  const int64_t b = r / g.ho;
  int acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
  const int8_t* img = xq + b * g.H * g.W * g.Cp + c0 + 16 * j;
  for (int dy = 0; dy < g.kh; ++dy) {
    const int iy = y * g.sh - g.ph + dy * g.dh;
    if (iy < 0 || iy >= g.H) continue;
    for (int dx = 0; dx < g.kw; ++dx) {
      const int ix = x * g.sw - g.pw + dx * g.dw;
      if (ix < 0 || ix >= g.W) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          img + (static_cast<int64_t>(iy) * g.W + ix) * g.Cp));
      mac16(acc, v, s_w[(dy * g.kw + dx) * cg + j]);
    }
  }

  const bool has_bias = bias != nullptr;
  float v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    // Two roundings, never an FMA: the product, then the bias.
    const float t = __fmul_rn(static_cast<float>(acc[k]), s_dq[cl + k]);
    v[k] = has_bias ? __fadd_rn(t, s_bias[cl + k]) : t;
  }
  const int64_t row = p * g.C;
  if (kBf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + row + c;
    if (vec_store) {
      uint32_t packed[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        packed[k] = *reinterpret_cast<const uint32_t*>(&h2);
      }
      uint4* o4 = reinterpret_cast<uint4*>(o);
      o4[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      o4[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (c + k < g.C) o[k] = __float2bfloat16_rn(v[k]);
      }
    }
  } else {
    float* o = static_cast<float*>(out) + row + c;
    if (vec_store) {
      float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        if (c + k < g.C) o[k] = v[k];
      }
    }
  }
}

}  // namespace

// xq: contiguous int8 [B, H, W, Cp]; w: contiguous int8 [kh * kw, Cp]; dq,
// bias (or null): float32 [C]; out: contiguous [B * Ho * Wo, C], bfloat16
// (out_bf16 != 0) or float32. Cp a multiple of 32, 0 < C <= Cp, kh * kw <=
// 64, xq and w 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int hp_int8_dwconv(const void* xq, const void* w, const float* dq,
                              const float* bias, void* out, int B, int H, int W, int Cp,
                              int C, int kh, int kw, int sh, int sw, int ph, int pw, int dh,
                              int dw, int out_bf16, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 32 || C <= 0 || C > Cp || kh <= 0 ||
      kw <= 0 || kh * kw > kMaxTaps || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || dh <= 0 ||
      dw <= 0 || reinterpret_cast<uintptr_t>(xq) % 16 || reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H + 2 * ph <= dh * (kh - 1) || W + 2 * pw <= dw * (kw - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the filter outgrows the padded image
  }
  const Geometry g{H, W, Cp, C,
                   (H + 2 * ph - dh * (kh - 1) - 1) / sh + 1,
                   (W + 2 * pw - dw * (kw - 1) - 1) / sw + 1,
                   kh, kw, sh, sw, ph, pw, dh, dw};
  const int64_t n_pixels = static_cast<int64_t>(B) * g.ho * g.wo;
  if (n_pixels == 0) return static_cast<int>(cudaGetLastError());
  const int groups = Cp / 16;
  const int cg = groups % 8 == 0 ? 8 : groups % 4 == 0 ? 4 : 2;
  const int64_t blocks = (n_pixels + kThreads / cg - 1) / (kThreads / cg);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kh) * kw * 16 * cg + 2 * sizeof(float) * 16 * cg;
  const bool vec = C % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups / cg));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  if (out_bf16) {
    dwconv_kernel<true><<<grid, kThreads, smem, s>>>(x8, w8, dq, bias, out, n_pixels, g, cg, vec);
  } else {
    dwconv_kernel<false><<<grid, kThreads, smem, s>>>(x8, w8, dq, bias, out, n_pixels, g, cg, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
