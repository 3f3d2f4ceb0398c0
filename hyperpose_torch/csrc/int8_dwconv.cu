// The int8 depthwise convolution of the int8 engines, for Hopper (sm_90a),
// fused with the quantize of its input: one launch from the float
// activation to the output, the int8 values never written to memory.
//
// What it computes is the JAX package's int8 conv (hyperpose_tpu/quant.py
// _quantized_conv) with feature_group_count = C, each step rounded alone in
// the order of quant.py:139-157:
//   q = clamp(rint(float32(x) * inv_s), +-127)     (hp_int8_quantize's
//       operations, int8_gemm.cu: __fmul_rn, rintf, fmaxf / fminf);
//   s = the sum over the filter's taps of q times the channel's int8 tap;
//   out = cast(float(s) * dq[c] + bias[c]), the product and the sum rounded
//       apart (never an FMA).
//
//   hp_int8_dwconv: x [B, C, H, W] float32 or bf16 read through its element
//     strides (sb, sc, sh, sw); W int8 [kh * kw, Cp] (tap-major, channels
//     contiguous, Cp a multiple of 32, zero beyond C); dq and bias float32
//     [C] -> out [B * Ho * Wo, C] in x's type, rows (b, y, x): the layout of
//     hp_int8_conv's output.
//
// Bound. A depthwise conv has no contraction over channels: per channel it
// is a product with K = kh * kw <= 64 taps, so it reads each input byte and
// writes each output byte once against a few operations a byte, and bytes
// bind (tests/torch_measures.py int8_dwconv_work, with the input at its own
// width). The design keeps many loads in flight and has one block barrier,
// before its main loop:
//
// - Lanes. Where every pixel's run of channels starts on a 16-byte word
//   (channels-last, C * sizeof(T) a multiple of 16: all but one of the
//   families' depthwise widths), a lane owns V = 16 / sizeof(T) channels (8
//   in bf16, 4 in float32), loads each pixel's V values as one 16-byte word
//   and stores them as one. Otherwise (C = 1209 in bf16 has 2,418-byte
//   pixels; any layout whose channels are not contiguous) a lane owns one
//   channel and loads and stores one value: a warp's 32 lanes read 32
//   adjacent channels, 64 or 128 contiguous bytes on a channels-last input
//   at any alignment, and never need a padding copy.
// - Tiles. A lane computes NX adjacent output columns; lc lanes of a warp (a
//   power of two) span lc * V channels and its 32 / lc lane groups lie side
//   by side along the row. A block is 8 warps (wx across, 8 / wx down) on
//   one slice of lc * V channels. The host picks lc and wx per layer: the
//   pair that computes the fewest values beyond the layer's channels and
//   pixels.
// - Rows. A 16-byte lane computes one output row, loading the K rows of
//   its window in turn, each row's words all in flight before any is used.
//   A one-value lane on a 3x3 filter at stride 1 rolls down a strip of 8, 4
//   or 2 output rows (the longest that still gives 4 blocks an SM): each
//   input row is loaded and quantized once for the three output rows it
//   feeds, the next row's loads in flight while it is summed, and a row is
//   stored once its last input row is in.
// - Arithmetic. q = clamp(rint(x * inv_s), +-127) as a float. The sums run
//   in float32 FFMA on the integer values: |q| and |w| are at most 127 and a
//   filter has at most 64 taps, so every partial sum is an exact integer
//   below 2^24 in any order, equal to the s32 sum, and q needs no byte
//   extracted. The filters the layers use (3x3 at stride 1 or 2, dilation 1
//   or 2, and 1x1) are compiled apart, with the slice's taps as float32 in
//   shared memory (a 16-byte read feeds 4 x NX products); any other filter
//   (kh * kw <= 64) loads a value per tap.
//
// Refused (cudaErrorInvalidValue): Cp not a multiple of 32, C > Cp, kh * kw
// > 64, and a filter larger than the padded image.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kMaxTaps = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

struct Conv {
  int B, C, H, W, Ho, Wo, kh, kw, sh, sw, ph, pw, dh, dw;
  int64_t xb, xc, xh, xw;  // x's element strides
  float inv_s;
};

// The host's choice for one launch.
struct Tile {
  int lc;       // lanes of a warp across channels (1 to 32, a power of two)
  int wx;       // warps of a block across (8 / wx down)
  int tiles_x;  // blocks across the output's columns
  int rows;     // output rows a lane
};

// hp_int8_quantize's q = clamp(rintf(v * inv_s), +-127), bit for bit, with
// rintf (a conversion, a sixteenth of the FFMA rate) written as two adds:
// adding and taking away 1.5 * 2^23 rounds any |u| < 2^22 to the nearest
// integer, ties to even, as rintf does; from 2^22 on, both clamp to +-127,
// NaN and +-inf alike. Only the sign of a zero may differ, which no sum sees.
__device__ __forceinline__ float quantize1(float v, float inv_s) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(v, inv_s), kRound), -kRound);
  return fminf(fmaxf(u, -127.0f), 127.0f);
}

__device__ __forceinline__ uint32_t word32(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The values of T in a 16-byte word (a one-value lane's value alone, in its
// low bits), as bits.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int V = 4;
  __device__ static float get(const uint4& u, int i) { return __uint_as_float(word32(u, i)); }
  __device__ static uint32_t bits(float r) { return __float_as_uint(r); }
  __device__ static uint32_t load(const float* p) { return __float_as_uint(__ldg(p)); }
  __device__ static void put(float* p, uint32_t b) { *reinterpret_cast<uint32_t*>(p) = b; }
  __device__ static uint4 pack(const uint32_t (&b)[V]) { return make_uint4(b[0], b[1], b[2], b[3]); }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float get(const uint4& u, int i) {
    const uint32_t w = word32(u, i >> 1);
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ static uint32_t bits(float r) { return __bfloat16_as_ushort(__float2bfloat16_rn(r)); }
  __device__ static uint32_t load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void put(__nv_bfloat16* p, uint32_t b) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(b);
  }
  __device__ static uint4 pack(const uint32_t (&b)[V]) {
    return make_uint4(b[0] | b[1] << 16, b[2] | b[3] << 16, b[4] | b[5] << 16, b[6] | b[7] << 16);
  }
};

// kWide: a lane's V channels of a pixel are one aligned 16-byte word. One
// value a lane otherwise (V = 1).
template <typename T, bool kWide>
__host__ __device__ constexpr int lane_values() {
  return kWide ? Word<T>::V : 1;
}

// The lane's values of the input pixel at p (zero where not `live`).
template <typename T, bool kWide>
__device__ __forceinline__ uint4 fetch(const T* p, bool live) {
  if (!live) return make_uint4(0, 0, 0, 0);
  if constexpr (kWide) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return make_uint4(Word<T>::load(p), 0, 0, 0);
  }
}

// K > 0: a K x K filter at stride S and dilation D, compiled apart (each
// loaded row used by every output it feeds, the taps in shared memory).
// kRoll (3x3, stride 1): a strip of t.rows output rows a lane, each input
// row loaded once; otherwise one output row a lane. K == 0: any filter,
// from the run-time geometry, a value loaded per tap. A lane computes NX
// adjacent output columns.
template <typename T, int K, int S, int D, int NX, bool kWide, bool kRoll>
__global__ void __launch_bounds__(kThreads, 2) dwconv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ dq,
    const float* __restrict__ bias, T* __restrict__ out, Conv g, int Cp, Tile t) {
  using Wd = Word<T>;
  constexpr int V = lane_values<T, kWide>(), CH = V < 4 ? V : 4;  // CH: channels a tap read
  constexpr int kCols = K > 0 ? (NX - 1) * S + (K - 1) * D + 1 : 1;  // input columns a row
  static_assert(!kRoll || (K == 3 && S == 1 && D == 1), "only 3x3 at stride 1 rolls");
  extern __shared__ __align__(16) float taps[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lc = t.lc, slice = lc * V;
  const int cl = lane & (lc - 1), pg = lane / lc;
  const int c0 = blockIdx.x * slice, c = c0 + cl * V;
  const int nc = min(V, g.C - c);  // the lane's real channels (<= 0: none)
  const int tile_y = blockIdx.y / t.tiles_x, tile_x = blockIdx.y - tile_y * t.tiles_x;
  const int warp_ox = (tile_x * t.wx + warp % t.wx) * (32 / lc) * NX;
  const int oy0 = (tile_y * (kWarps / t.wx) + warp / t.wx) * t.rows, ox0 = warp_ox + pg * NX;
  const int b = blockIdx.z;

  // The slice's taps as float32, tap by tap; for 16-byte lanes each tap's
  // channels in groups of 4 ordered (group of the lane's V, lane, 4
  // channels), so that a warp's 16-byte reads of one group are contiguous;
  // zero past Cp.
  if constexpr (K > 0) {
    for (int i = threadIdx.x; i < K * K * slice; i += kThreads) {
      const int tap = i / slice, r = i - tap * slice;
      const int ch = V < 4 ? c0 + r : c0 + r / 4 % lc * V + r / (4 * lc) * 4 + r % 4;
      taps[i] = ch < Cp ? static_cast<float>(w[tap * Cp + ch]) : 0.f;
    }
    __syncthreads();
  }
  if (oy0 >= g.Ho || warp_ox >= g.Wo) return;  // no block barrier follows

  const T* img = x + b * g.xb + static_cast<int64_t>(c) * g.xc;
  const int ix0 = ox0 * g.sw - g.pw;
  auto pixel = [&](int iy, int ix) {
    return fetch<T, kWide>(img + iy * g.xh + ix * g.xw,
                           nc > 0 && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W);
  };
  // Quantized channels CH * h .. CH * h + CH - 1 of a loaded row.
  auto quantize_row = [&](const uint4 (&raw)[kCols], float (&q)[kCols][CH], int h) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
#pragma unroll
      for (int v = 0; v < CH; ++v) q[i][v] = quantize1(Wd::get(raw[i], CH * h + v), g.inv_s);
    }
  };
  // Adds those values times tap row dy to the sums `a` of one output row.
  auto sum_row = [&](float (&a)[NX][V], const float (&q)[kCols][CH], int dy, int h) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float* p = taps + (dy * K + dx) * slice + (h * lc + cl) * CH;
      float wv[CH];
      if constexpr (CH == 4) {
        const float4 f = *reinterpret_cast<const float4*>(p);
        wv[0] = f.x, wv[1] = f.y, wv[2] = f.z, wv[3] = f.w;
      } else {
        wv[0] = *p;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
#pragma unroll
        for (int v = 0; v < CH; ++v) {
          a[j][CH * h + v] = fmaf(q[j * S + dx * D][v], wv[v], a[j][CH * h + v]);
        }
      }
    }
  };
  // Output row oy's NX pixels from their sums: the epilogue in registers
  // (two roundings, never an FMA), a 16-byte word or one value a pixel.
  auto emit = [&](const float (&a)[NX][V], int oy) {
    if (nc <= 0 || oy >= g.Ho) return;
    float d[V], bb[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      d[v] = v < nc ? __ldg(dq + c + v) : 0.f;
      bb[v] = v < nc && bias != nullptr ? __ldg(bias + c + v) : 0.f;
    }
    T* row = out + ((static_cast<int64_t>(b) * g.Ho + oy) * g.Wo + ox0) * g.C + c;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      if (ox0 + j >= g.Wo) break;
      uint32_t bits[Wd::V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float r = __fmul_rn(a[j][v], d[v]);
        if (bias != nullptr) r = __fadd_rn(r, bb[v]);
        bits[v] = Wd::bits(r);
      }
      if constexpr (kWide) {
        *reinterpret_cast<uint4*>(row + j * g.C) = Wd::pack(bits);
      } else {
        Wd::put(row + j * g.C, bits[0]);
      }
    }
  };

  if constexpr (kRoll) {
    // acc[k] holds output row r - 2 + k of the strip after input row r.
    float acc[3][NX][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[k][j][v] = 0.f;
      }
    }
    const int rows = min(t.rows, g.Ho - oy0), iy0 = oy0 - g.ph;
    uint4 next[kCols];  // the next input row, in flight while this one is summed
#pragma unroll
    for (int i = 0; i < kCols; ++i) next[i] = pixel(iy0, ix0 + i);
    for (int r = 0; r < rows + 2; ++r) {
      uint4 raw[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) raw[i] = next[i];
      if (r + 1 < rows + 2) {
#pragma unroll
        for (int i = 0; i < kCols; ++i) next[i] = pixel(iy0 + r + 1, ix0 + i);
      }
#pragma unroll
      for (int h = 0; h < V / CH; ++h) {
        float q[kCols][CH];
        quantize_row(raw, q, h);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) sum_row(acc[2 - dy], q, dy, h);
      }
      if (r >= 2) emit(acc[0], oy0 + r - 2);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[0][j][v] = acc[1][j][v];
          acc[1][j][v] = acc[2][j][v];
          acc[2][j][v] = 0.f;
        }
      }
    }
    return;
  }

  float acc[NX][V];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[j][v] = 0.f;
  }
  const int iy0 = oy0 * g.sh - g.ph;
  if constexpr (K > 0) {
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      uint4 raw[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) raw[i] = pixel(iy0 + dy * D, ix0 + i);
#pragma unroll
      for (int h = 0; h < V / CH; ++h) {
        float q[kCols][CH];
        quantize_row(raw, q, h);
        sum_row(acc, q, dy, h);
      }
    }
  } else {
    for (int dy = 0; dy < g.kh; ++dy) {
      for (int dx = 0; dx < g.kw; ++dx) {
        float wv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          wv[v] = v < nc ? static_cast<float>(w[(dy * g.kw + dx) * Cp + c + v]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const uint4 raw = pixel(iy0 + dy * g.dh, ix0 + j * g.sw + dx * g.dw);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[j][v] = fmaf(quantize1(Wd::get(raw, v), g.inv_s), wv[v], acc[j][v]);
          }
        }
      }
    }
  }
  emit(acc, oy0);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The layout of one launch. Over lc (lanes across channels) and wx (warps
// across), the pair that computes the fewest values beyond the layer's
// own (the channels the slices cover times the pixels the blocks cover);
// ties go to the larger lc (longer runs a request), then to wx = 2. A
// rolling filter takes the longest strip (8, 4 or 2 output rows a lane)
// that still gives 4 blocks an SM; other filters one row a lane.
Tile choose(const Conv& g, int V, int NX, bool roll, int sms) {
  constexpr int kWx[4] = {2, 4, 1, 8};
  const int groups = ceil_div(g.C, V);
  Tile best{32, 2, 1, 1};
  for (int rows : {8, 4, 2, 1}) {
    if (roll ? rows == 1 : rows != 1) continue;
    int64_t best_cost = -1;
    for (int lc = 32; lc >= 1; lc /= 2) {
      for (int wx : kWx) {
        const int cols = wx * (32 / lc) * NX, tall = kWarps / wx * rows;
        const int64_t cost = static_cast<int64_t>(ceil_div(groups, lc)) * lc *
                             ceil_div(g.Wo, cols) * cols * ceil_div(g.Ho, tall) * tall;
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best = Tile{lc, wx, ceil_div(g.Wo, cols), rows};
        }
      }
    }
    const int64_t blocks = static_cast<int64_t>(ceil_div(groups, best.lc)) * best.tiles_x *
                           ceil_div(g.Ho, kWarps / best.wx * rows) * g.B;
    if (blocks >= 4LL * sms) break;
  }
  return best;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 132;
    }
  }
  return n;
}

template <typename T, int K, int S, int D, int NX, bool kWide, bool kRoll = false>
int launch(const T* x, const int8_t* w, const float* dq, const float* bias, T* out,
           const Conv& g, int Cp, cudaStream_t stream) {
  constexpr int V = lane_values<T, kWide>();
  const Tile t = choose(g, V, NX, kRoll, sm_count());
  const int slice = t.lc * V;
  const dim3 grid(ceil_div(g.C, slice), ceil_div(g.Ho, kWarps / t.wx * t.rows) * t.tiles_x,
                  g.B);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K * K) * slice * sizeof(float);  // <= 9,216 bytes
  dwconv_kernel<T, K, S, D, NX, kWide, kRoll><<<grid, kThreads, smem, stream>>>(x, w, dq, bias,
                                                                               out, g, Cp, t);
  return static_cast<int>(cudaGetLastError());
}

// The compiled filters and each one's output columns a lane (NX): with
// 16-byte lanes, 3x3 at stride 1 (4), stride 2 (2) and dilation 2 (4), and
// 1x1 (4); with one-value lanes, 3x3 at stride 1 (8, rolling), stride 2 (4)
// and dilation 2 (4), and 1x1 (8). Any other filter takes the general
// kernel (1).
template <typename T, bool kWide>
int by_filter(const T* x, const int8_t* w, const float* dq, const float* bias, T* o,
              const Conv& g, int Cp, cudaStream_t s) {
  if (g.kh == 3 && g.kw == 3 && g.sh == g.sw && g.dh == g.dw) {
    if (g.sh == 1 && g.dh == 1) {
      if constexpr (kWide) {
        return launch<T, 3, 1, 1, 4, kWide>(x, w, dq, bias, o, g, Cp, s);
      } else {
        return launch<T, 3, 1, 1, 8, kWide, true>(x, w, dq, bias, o, g, Cp, s);
      }
    }
    if (g.sh == 2 && g.dh == 1) {
      return launch<T, 3, 2, 1, kWide ? 2 : 4, kWide>(x, w, dq, bias, o, g, Cp, s);
    }
    if (g.sh == 1 && g.dh == 2) return launch<T, 3, 1, 2, 4, kWide>(x, w, dq, bias, o, g, Cp, s);
  }
  if (g.kh == 1 && g.kw == 1 && g.sh == 1 && g.sw == 1) {
    return launch<T, 1, 1, 1, kWide ? 4 : 8, kWide>(x, w, dq, bias, o, g, Cp, s);
  }
  return launch<T, 0, 0, 0, 1, kWide>(x, w, dq, bias, o, g, Cp, s);
}

// 16-byte lanes where every pixel's run of channels, and every row of
// `out`, starts on a 16-byte word.
template <typename T>
int dispatch(const void* x, const void* w, const float* dq, const float* bias, void* out,
             const Conv& g, int Cp, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  T* o = static_cast<T*>(out);
  constexpr int64_t z = sizeof(T);
  if (g.xc == 1 && g.C * z % 16 == 0 && g.xw * z % 16 == 0 && g.xh * z % 16 == 0 &&
      g.xb * z % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    return by_filter<T, true>(xt, w8, dq, bias, o, g, Cp, s);
  }
  return by_filter<T, false>(xt, w8, dq, bias, o, g, Cp, s);
}

}  // namespace

// x: float32 or bf16 (bf16 != 0) [B, C, H, W] with element strides (sb, sc,
// sh, sw); w: contiguous int8 [kh * kw, Cp]; dq, bias (or null): float32
// [C]; out: contiguous [B * Ho * Wo, C] in x's type. Cp a multiple of 32,
// 0 < C <= Cp, kh * kw <= 64. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for what it refuses.
extern "C" int hp_int8_dwconv(const void* x, const void* w, const float* dq,
                              const float* bias, void* out, int B, int C, int H, int W,
                              int64_t sb, int64_t sc, int64_t sh, int64_t sw, int Cp, int kh,
                              int kw, int st_h, int st_w, int ph, int pw, int dh, int dw,
                              float inv_s, int bf16, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % 32 || C <= 0 || C > Cp || kh <= 0 ||
      kw <= 0 || kh * kw > kMaxTaps || st_h <= 0 || st_w <= 0 || ph < 0 || pw < 0 ||
      dh <= 0 || dw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H + 2 * ph <= dh * (kh - 1) || W + 2 * pw <= dw * (kw - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the filter outgrows the padded image
  }
  const Conv g{B, C, H, W,
               (H + 2 * ph - dh * (kh - 1) - 1) / st_h + 1,
               (W + 2 * pw - dw * (kw - 1) - 1) / st_w + 1,
               kh, kw, st_h, st_w, ph, pw, dh, dw, sb, sc, sh, sw, inv_s};
  if (static_cast<int64_t>(B) * g.Ho * g.Wo == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, w, dq, bias, out, g, Cp, s)
              : dispatch<float>(x, w, dq, bias, out, g, Cp, s);
}
