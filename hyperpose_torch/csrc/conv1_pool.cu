// TinyVGG's fused serving stem for Hopper (sm_90a): block_1 (BN folded) +
// bias + ReLU + the first 2x2 max pool in one kernel, on the pair-packed
// x-im2col of block_0 that VggTinyFusedStem.conv0p emits.
//
// Replaces the Pallas TPU kernel hyperpose_tpu/ops/pallas/stem_kernel.py
// fused_conv1_pool. Per output pair q and row y:
//
//   y1p[y, q, n] = sum_dy sum_c btp[y+dy-1, q, c] * w1p[dy, c, n],  n < 128
//   out[y/2, q, co] = max over the row pair, and over n = co and 64+co, of
//                     relu(y1p + b1p)
//
// with btp's lanes 0-31 at q = 0, lanes 96-127 at q = Q-1 and the rows -1
// and H read as zeros (block_1's SAME padding). The masks are applied while
// the tile is loaded: the input is never copied.
//
// Design. One block of 256 threads owns the output pairs of one image row
// pair (input rows 2*yo-1 .. 2*yo+2) and 32 consecutive q: a GEMM tile of
// 64 rows (2 rows x 32 q) by 128 lanes, 384 deep (3 dy x 128 lanes). The
// depth runs in chunks of 32: each chunk stages its A slice (masked, in
// float32) and its [32, 128] slice of w1p through shared memory. A thread
// keeps 2 q x 2 rows x 8 lanes in registers (lanes 4t..4t+3 and their pool
// partners 64+4t..), so bias, ReLU and both maxes happen in registers
// before one store per output: the full-resolution activation never
// reaches device memory. Sums are float32 for both input types; bf16 is
// read, widened and rounded back (round to nearest even) only on the store.
//
// Bound: operations. At B=8, 368x432 (Q = 216): 635,904 rows x 384 x 128
// multiply-adds = 62.5 GFLOP, 0.93 ms at the 67 TFLOP/s of float32 FMA;
// the bytes (407 MB in f32, 204 MB in bf16) move in 0.12 / 0.06 ms. This
// kernel uses plain FMA, not the tensor cores: for bf16 the bound is
// 0.063 ms at 989 TFLOP/s, which needs wgmma (or mma.sync) with the tiles
// fed by TMA or cp.async, left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTQ = 32;           // output pairs q per block
constexpr int kM = 2 * kTQ;       // GEMM rows per block: 2 image rows x kTQ
constexpr int kN = 128;           // output lanes: [x=2q: 64 | x=2q+1: 64]
constexpr int kC = 128;           // input lanes per dy
constexpr int kKC = 32;           // depth of one staged chunk
constexpr int kThreads = 256;
constexpr int kAStride = kM + 1;  // padding: the staging stores use 32 banks

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv1_pool_kernel(
    const T* __restrict__ a, int H, int Q, int64_t sb, int64_t sh, int64_t sq,
    const T* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ out) {
  __shared__ float As[kKC][kAStride];           // As[k][m], m = r * kTQ + qi
  __shared__ __align__(16) float Ws[kKC][kN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lanes 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid >> 4;   // pairs qi = ty and ty + 16
  const int q0 = blockIdx.x * kTQ;
  const int yo = blockIdx.y;
  const int b = blockIdx.z;
  const T* ab = a + b * sb;

  // Staging role: tile row m (image row r of the pair, pair q), 8 lanes.
  const int st_m = tid >> 2;
  const int st_k = (tid & 3) * 8;
  const int st_r = st_m / kTQ;
  const int st_q = q0 + st_m % kTQ;

  float acc[2][2][8];  // [pair ty + 16s][row r][lanes 4tx+j | 64+4tx+j]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[s][r][n] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    const int y = 2 * yo + st_r + dy - 1;
    const bool row_ok = y >= 0 && y < H && st_q < Q;
    for (int c0 = 0; c0 < kC; c0 += kKC) {
      // The 8 lanes lie in one 32-lane block, so one mask covers them.
      const int c = c0 + st_k;
      const bool ok = row_ok && !(st_q == 0 && c < 32) &&
                      !(st_q == Q - 1 && c >= 96);
      float v[8];
      if (ok) {
        load8(ab + y * sh + st_q * sq + c, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[st_k + j][st_m] = v[j];
      for (int i = tid; i < kKC * kN / 4; i += kThreads) {
        const int k = i / (kN / 4);
        const int n = (i % (kN / 4)) * 4;
        *reinterpret_cast<float4*>(&Ws[k][n]) =
            load4(w + static_cast<int64_t>(dy * kC + c0 + k) * kN + n);
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(&Ws[k][4 * tx]);
        const float4 w1 = *reinterpret_cast<const float4*>(&Ws[k][64 + 4 * tx]);
        const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float av = As[k][r * kTQ + ty + 16 * s];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              acc[s][r][n] = fmaf(av, wk[n], acc[s][r][n]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // Epilogue: bias, then the max over the row pair and the x pair, then
  // ReLU (relu(max) == max(relu)), one store per output.
  const int ho = H / 2;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = q0 + ty + 16 * s;
    if (q >= Q) continue;
    T* o = out + ((static_cast<int64_t>(b) * ho + yo) * Q + q) * 64 + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b0 = bias[4 * tx + j];
      const float b1 = bias[64 + 4 * tx + j];
      const float m = fmaxf(fmaxf(acc[s][0][j] + b0, acc[s][0][4 + j] + b1),
                            fmaxf(acc[s][1][j] + b0, acc[s][1][4 + j] + b1));
      store(o + j, fmaxf(m, 0.f));
    }
  }
}

}  // namespace

// a: [B, H, Q, 128] with element strides (sb, sh, sq) and contiguous lanes,
// 16-byte aligned rows; w: contiguous [3, 128, 128] of the same type; bias:
// float [128]; out: contiguous [B, H/2, Q, 64]. bf16 != 0 selects
// __nv_bfloat16 for a, w and out, else float. Returns cudaGetLastError()
// after the launch.
extern "C" int hp_conv1_pool(const void* a, int B, int H, int Q, int64_t sb,
                             int64_t sh, int64_t sq, const void* w,
                             const void* bias, void* out, int bf16,
                             void* stream) {
  if (B < 0 || H < 0 || Q < 0 || H % 2 || B > 65535 || H / 2 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || Q == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((Q + kTQ - 1) / kTQ, H / 2, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (bf16) {
    conv1_pool_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), H, Q, sb, sh, sq,
        static_cast<const __nv_bfloat16*>(w), bp,
        static_cast<__nv_bfloat16*>(out));
  } else {
    conv1_pool_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), H, Q, sb, sh, sq,
        static_cast<const float*>(w), bp, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
