// Peak front end of the PAF decoder for Hopper (sm_90a), two kernels on one
// shared smooth + NMS:
//
//   * peak_topk_kernel: smooth, NMS, plateau tie-break, top-K, sub-pixel fit
//     and raw-score gather in one kernel. Replaces the Pallas TPU kernel
//     hyperpose_tpu/ops/pallas/peak_kernel.py fused_peak_topk (border = zero)
//     and reproduces the production XLA front end
//     hyperpose_tpu/ops/paf_decode.py find_peaks (border = reflect).
//   * peak_candidates_kernel: smooth, NMS and tie-break only, writing the
//     ranked plane (the smoothed value at surviving peaks, `neg` elsewhere)
//     and the smoothed plane. Replaces the Pallas TPU kernel
//     peak_kernel.py fused_peak_candidates (zero borders), the front end of
//     the decoder's use_pallas_peaks mode.
//
// One block per (image, part) plane. The plane, its smoothed copy and one
// scratch plane live in shared memory (3 * H * W floats, 30 KB at 46x54), so
// the map is read from device memory once.
//
//   1. load the plane (strided: the decoder hands over an NHWC view);
//   2. separable smooth, taps added centre first then the pairs at distance
//      1, 2, ...; every product and sum is rounded on its own (__fmul_rn,
//      __fadd_rn), so the result equals the plain PyTorch version bit for bit;
//   3. 3x3 same-max NMS with the threshold, then the plateau tie-break (a
//      candidate survives only if no candidate in its window has a larger
//      pixel index);
//   then, in peak_topk_kernel only:
//   4. K rounds of a block-wide argmax, ties to the lowest pixel index; the
//      chosen pixel is masked with -2e30 (reflect, as find_peaks) or -1e30
//      (zero, as the Pallas kernel);
//   5. the quadratic sub-pixel fit and the raw-score gather per slot.
//
// Border modes: reflect is reflect-101 for the smooth, -inf outside the plane
// for the max pool, and the sub-pixel neighbours come from the clipped flat
// index (at x = W-1 the "x+1" neighbour is x = 0 of the next row), as
// find_peaks does. zero fills outside the plane with 0 everywhere.
//
// Bound: bytes. peak_topk reads each map value once and writes 4*K floats
// per plane; the arithmetic (10 multiply-adds per pixel for the smooth, K
// scans of the plane for the top-K) is far below the card's rate. The top-K
// scans run out of shared memory, not device memory. peak_candidates reads
// the map once and writes two planes of the same size (1.43 MB in, 2.86 MB
// out at B=8, 46x54, 18 parts: 1.3 us at 3.35 TB/s).
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxTaps = 31;
constexpr int kMaxK = 128;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Taps {
  float t[kMaxTaps];
};

__device__ __forceinline__ int reflect101(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float subpix(float fp, float fm, float f0) {
  const float denom = __fadd_rn(__fsub_rn(fp, __fmul_rn(2.f, f0)), fm);
  float off = 0.f;
  if (fabsf(denom) > 1e-9f) {
    off = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(fm, fp)), denom);
  }
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

// One smoothing pass along one axis: `step` is 1 along x, W along y; `pos`
// and `n` are the coordinate along that axis and its extent.
__device__ __forceinline__ float smooth_at(const float* src, int i, int pos,
                                           int n, int step, const Taps& taps,
                                           int r, bool zero) {
  float acc = __fmul_rn(taps.t[r], src[i]);
  for (int d = 1; d <= r; ++d) {
    float vm, vp;
    if (zero) {
      vm = pos - d >= 0 ? src[i - d * step] : 0.f;
      vp = pos + d < n ? src[i + d * step] : 0.f;
    } else {
      vm = src[i + (reflect101(pos - d, n) - pos) * step];
      vp = src[i + (reflect101(pos + d, n) - pos) * step];
    }
    acc = __fadd_rn(acc, __fmul_rn(taps.t[r - d], vm));
    acc = __fadd_rn(acc, __fmul_rn(taps.t[r + d], vp));
  }
  return acc;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Steps 1-3 for the plane at `src`: on return (after a barrier) `sm` holds
// the smoothed plane and `ranked` the smoothed value at surviving peaks and
// `neg` elsewhere. `t` is scratch. Every thread of the block calls it.
__device__ void smooth_nms(const float* __restrict__ src, int H, int W,
                           int64_t sy, int64_t sx, const Taps& taps, int r,
                           float thresh, bool zero, float neg, float* ranked,
                           float* t, float* sm) {
  const int HW = H * W;
  const int tid = threadIdx.x;
  int* cand = reinterpret_cast<int*>(t);
  float* a = ranked;  // the raw plane until the tie-break overwrites it
  for (int i = tid; i < HW; i += blockDim.x) {
    const int y = i / W, x = i % W;
    a[i] = src[y * sy + x * sx];
  }
  __syncthreads();
  for (int i = tid; i < HW; i += blockDim.x) {
    t[i] = smooth_at(a, i, i / W, H, W, taps, r, zero);
  }
  __syncthreads();
  for (int i = tid; i < HW; i += blockDim.x) {
    sm[i] = smooth_at(t, i, i % W, W, 1, taps, r, zero);
  }
  __syncthreads();

  // NMS + threshold: candidates hold their own pixel index, others -1.
  for (int i = tid; i < HW; i += blockDim.x) {
    const int y = i / W, x = i % W;
    const float v = sm[i];
    bool pk = v > thresh;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const int ny = y + dy, nx = x + dx;
        if (ny >= 0 && ny < H && nx >= 0 && nx < W) {
          pk = pk && v >= sm[ny * W + nx];
        } else if (zero) {
          pk = pk && v >= 0.f;
        }
      }
    }
    cand[i] = pk ? i : -1;
  }
  __syncthreads();
  // Plateau tie-break; the survivors' smoothed values form the ranked plane.
  for (int i = tid; i < HW; i += blockDim.x) {
    const int y = i / W, x = i % W;
    bool keep = cand[i] == i;
    for (int dy = -1; dy <= 1 && keep; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const int ny = y + dy, nx = x + dx;
        if (ny >= 0 && ny < H && nx >= 0 && nx < W && cand[ny * W + nx] > i) {
          keep = false;
        }
      }
    }
    ranked[i] = keep ? sm[i] : neg;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) peak_topk_kernel(
    const float* __restrict__ conf, int H, int W, int P, int64_t sb,
    int64_t sy, int64_t sx, int64_t sp, Taps taps, int ntaps, float thresh,
    int K, int zero_border, float* __restrict__ out_xy,
    float* __restrict__ out_raw, float* __restrict__ out_sval) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* a = smem;            // the ranked plane
  float* t = smem + HW;       // scratch
  float* sm = smem + 2 * HW;  // smoothed plane
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];
  __shared__ float sel_v[kMaxK];
  __shared__ int sel_i[kMaxK];

  const bool zero = zero_border != 0;
  const int tid = threadIdx.x;
  const int bp = blockIdx.x;
  const int b = bp / P;
  const int p = bp % P;
  const float* src = conf + b * sb + p * sp;
  smooth_nms(src, H, W, sy, sx, taps, ntaps / 2, thresh, zero, kNeg, a, t, sm);

  const float taken = zero ? kNeg : 2.f * kNeg;
  const int lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < K; ++k) {
    float bv = -FLT_MAX;
    int bi = INT_MAX;
    for (int i = tid; i < HW; i += kThreads) {
      if (better(a[i], i, bv, bi)) {
        bv = a[i];
        bi = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kThreads / 32 ? warp_v[lane] : -FLT_MAX;
      bi = lane < kThreads / 32 ? warp_i[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        sel_v[k] = bv;
        sel_i[k] = bi;
        a[bi] = taken;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < K; k += kThreads) {
    const int idx = sel_i[k];
    const int y = idx / W, x = idx % W;
    const float f0 = sm[idx];
    float fxp, fxm, fyp, fym;
    if (zero) {
      fxp = x + 1 < W ? sm[idx + 1] : 0.f;
      fxm = x - 1 >= 0 ? sm[idx - 1] : 0.f;
      fyp = y + 1 < H ? sm[idx + W] : 0.f;
      fym = y - 1 >= 0 ? sm[idx - W] : 0.f;
    } else {
      fxp = sm[min(idx + 1, HW - 1)];
      fxm = sm[max(idx - 1, 0)];
      fyp = sm[min(idx + W, HW - 1)];
      fym = sm[max(idx - W, 0)];
    }
    const int64_t o = static_cast<int64_t>(bp) * K + k;
    out_xy[2 * o] = __fadd_rn(static_cast<float>(x), subpix(fxp, fxm, f0));
    out_xy[2 * o + 1] = __fadd_rn(static_cast<float>(y), subpix(fyp, fym, f0));
    out_raw[o] = src[y * sy + x * sx];
    out_sval[o] = sel_v[k];
  }
}

__global__ void __launch_bounds__(kThreads) peak_candidates_kernel(
    const float* __restrict__ conf, int H, int W, int P, int64_t sb,
    int64_t sy, int64_t sx, int64_t sp, Taps taps, int ntaps, float thresh,
    float neg, float* __restrict__ out_ranked, float* __restrict__ out_sm) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* ranked = smem;
  float* sm = smem + 2 * HW;
  const int bp = blockIdx.x;
  const float* src = conf + (bp / P) * sb + (bp % P) * sp;
  smooth_nms(src, H, W, sy, sx, taps, ntaps / 2, thresh, true, neg, ranked,
             smem + HW, sm);
  const int64_t o = static_cast<int64_t>(bp) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) {
    out_ranked[o + i] = ranked[i];
    out_sm[o + i] = sm[i];
  }
}

// Copies the taps and raises the kernel's dynamic shared memory limit when
// the three planes need more than 48 KB. Returns a CUDA error code.
template <typename Kernel>
int prepare(Kernel kernel, const void* taps_host, int ntaps, int H, int W,
            Taps* taps, size_t* smem) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* th = static_cast<const float*>(taps_host);
  for (int i = 0; i < ntaps; ++i) taps->t[i] = th[i];
  *smem = 3 * static_cast<size_t>(H) * W * sizeof(float);
  if (*smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem)));
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// conf: float [B, H, W, P] with element strides (sb, sy, sx, sp); taps: host
// array of ntaps (odd, <= 31) floats; outputs contiguous: xy [B, P, K, 2],
// raw [B, P, K], sval [B, P, K]. K <= 128 and K <= H*W. Returns
// cudaGetLastError() after the launch.
extern "C" int hp_peak_topk(const void* conf, int B, int H, int W, int P,
                            int64_t sb, int64_t sy, int64_t sx, int64_t sp,
                            const void* taps_host, int ntaps, float thresh,
                            int K, int zero_border, void* xy, void* raw,
                            void* sval, void* stream) {
  if (K < 1 || K > kMaxK || K > H * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps{};
  size_t smem = 0;
  const int e = prepare(peak_topk_kernel, taps_host, ntaps, H, W, &taps, &smem);
  if (e != 0) return e;
  if (B * P == 0) return static_cast<int>(cudaGetLastError());
  peak_topk_kernel<<<B * P, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), H, W, P, sb, sy, sx, sp, taps, ntaps,
      thresh, K, zero_border, static_cast<float*>(xy),
      static_cast<float*>(raw), static_cast<float*>(sval));
  return static_cast<int>(cudaGetLastError());
}

// conf as for hp_peak_topk; zero borders; outputs contiguous float
// [B, P, H, W]: ranked (the smoothed value at surviving peaks, `neg`
// elsewhere) and smoothed. Returns cudaGetLastError() after the launch.
extern "C" int hp_peak_candidates(const void* conf, int B, int H, int W,
                                  int P, int64_t sb, int64_t sy, int64_t sx,
                                  int64_t sp, const void* taps_host,
                                  int ntaps, float thresh, float neg,
                                  void* ranked, void* smoothed,
                                  void* stream) {
  Taps taps{};
  size_t smem = 0;
  const int e = prepare(peak_candidates_kernel, taps_host, ntaps, H, W, &taps,
                        &smem);
  if (e != 0) return e;
  if (B * P * H * W == 0) return static_cast<int>(cudaGetLastError());
  peak_candidates_kernel<<<B * P, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), H, W, P, sb, sy, sx, sp, taps, ntaps,
      thresh, neg, static_cast<float*>(ranked), static_cast<float*>(smoothed));
  return static_cast<int>(cudaGetLastError());
}
