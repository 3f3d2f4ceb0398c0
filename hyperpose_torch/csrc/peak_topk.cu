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
// the map is read from device memory once. A thread walks its pixels with
// (y, x) advanced incrementally (no division per pixel).
//
//   1. load the plane (strided: the decoder hands over an NHWC view);
//   2. separable smooth, taps added centre first then the pairs at distance
//      1, 2, ...; every product and sum is rounded on its own (__fmul_rn,
//      __fadd_rn), so the result equals the plain PyTorch version bit for bit.
//      The taps sit in shared memory; radius 2 (the PAF decoder's ksize 5)
//      is compiled with the taps unrolled, other radii read it at run time;
//   3. 3x3 same-max NMS with the threshold, then the plateau tie-break (a
//      candidate survives only if no candidate in its window has a larger
//      pixel index), each as eight independent predicated compares;
//   then, in peak_topk_kernel only:
//   4. the top K in a fixed number of barriers, whatever K is: the K argmax
//      rounds of the plain version (ties to the lowest pixel index, a chosen
//      pixel masked with -2e30 under reflect, as find_peaks, or -1e30 under
//      zero, as the Pallas kernel) are a stable sort, written out directly.
//      After the tie-break no two survivors touch (a survivor sees no
//      candidate with a larger index in its 3x3 window), so a plane holds at
//      most ceil(H/2) * ceil(W/2) of them (621 at 46x54); each survivor's
//      value lies above -1e30 (it passed thresh > -1e30) and every other
//      pixel holds exactly -1e30. So slots 0 .. min(n, K) - 1 hold the n
//      survivors sorted by (value descending, index ascending), and slots
//      n .. K - 1 hold -1e30 at pixel 0 every time (zero: taken pixels
//      fall back to -1e30) or at the non-survivors in index order (reflect:
//      taken pixels drop below them). The survivors are compacted into a
//      list (warp ballots, one shared counter), each ranked by counting the
//      list entries that beat it (stopping at K), and written to slot
//      `rank`; a reflect filler's slot is its pixel index less the
//      survivors below it;
//   5. the quadratic sub-pixel fit and the raw-score gather per slot.
//
// Border modes: reflect is reflect-101 for the smooth, -inf outside the plane
// for the max pool, and the sub-pixel neighbours come from the clipped flat
// index (at x = W-1 the "x+1" neighbour is x = 0 of the next row), as
// find_peaks does. zero fills outside the plane with 0 everywhere.
//
// Bound: bytes. peak_topk reads each map value once and writes 4*K floats
// per plane (1.47 MB at B=8, 46x54, 18 parts, K=16: 0.44 us at 3.35 TB/s),
// far below what one block's chain of dependent steps takes, so the kernel's
// time is latency: the launch, the strided load, five barriers of smooth and
// NMS and two of the selection. The K serial argmax rounds this replaces
// added two barriers and two 5-step shuffle reductions per slot. What is
// left is the front end: 512 threads a block (about 5 pixels a thread at
// 46x54), the strided load with kLoads values a thread in flight, and
// passes without a division or a branch per pixel.
// peak_candidates reads the map once and writes two planes of the same size
// (1.43 MB in, 2.86 MB out at B=8, 46x54, 18 parts: 1.3 us at 3.35 TB/s).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxTaps = 31;
constexpr int kMaxK = 128;
constexpr int kThreads = 512;
constexpr int kLoads = 8;  // global loads a thread keeps in flight
static_assert(2 * kMaxK <= kThreads, "a reflect filler lies below K + n < 2K: a pixel a thread");
constexpr float kNeg = -1e30f;

struct Taps {
  float t[kMaxTaps];
};

// Entries of the survivor list: ceil(H/2) * ceil(W/2) survivors at most,
// rounded up to a multiple of 4 for 16-byte reads.
__host__ __device__ inline int list_capacity(int H, int W) {
  return ((H + 1) / 2 * ((W + 1) / 2) + 3) / 4 * 4;
}

// Whether list entry (vj, ij) comes before (v, i): value descending, pixel
// index ascending.
__device__ __forceinline__ int beats(float vj, int ij, float v, int i) {
  return vj > v || (vj == v && ij < i);
}

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

// Calls f(i, y, x) for the pixels i = tid, tid + kThreads, ... of an H x W
// plane, advancing (y, x) without a division per pixel.
template <typename F>
__device__ __forceinline__ void for_pixels(int H, int W, F f) {
  const int step_y = kThreads / W, step_x = kThreads % W;
  int y = threadIdx.x / W, x = threadIdx.x % W;
  for (int i = threadIdx.x; i < H * W; i += kThreads) {
    f(i, y, x);
    x += step_x;
    y += step_y;
    if (x >= W) {
      x -= W;
      ++y;
    }
  }
}

// One smoothing pass along one axis: `step` is 1 along x, W along y; `pos`
// and `n` are the coordinate along that axis and its extent. kR > 0 fixes
// the radius at compile time (the taps unroll); 0 reads it from r. Away
// from the borders the neighbours are read without index arithmetic.
template <int kR>
__device__ __forceinline__ float smooth_at(const float* src, int i, int pos, int n,
                                           int step, const float* taps, int r,
                                           bool zero) {
  const int R = kR > 0 ? kR : r;
  const bool inside = pos >= R && pos + R < n;
  float acc = __fmul_rn(taps[R], src[i]);
#pragma unroll
  for (int d = 1; d <= R; ++d) {
    float vm, vp;
    if (inside) {
      vm = src[i - d * step];
      vp = src[i + d * step];
    } else if (zero) {
      vm = pos - d >= 0 ? src[i - d * step] : 0.f;
      vp = pos + d < n ? src[i + d * step] : 0.f;
    } else {
      vm = src[i + (reflect101(pos - d, n) - pos) * step];
      vp = src[i + (reflect101(pos + d, n) - pos) * step];
    }
    acc = __fadd_rn(acc, __fmul_rn(taps[R - d], vm));
    acc = __fadd_rn(acc, __fmul_rn(taps[R + d], vp));
  }
  return acc;
}

// The separable smooth, a (raw) -> t (along y) -> sm (along x), a barrier
// after each pass.
template <int kR>
__device__ __forceinline__ void smooth(const float* a, float* t, float* sm, int H, int W,
                                       const float* taps, int r, bool zero) {
  for_pixels(H, W, [&](int i, int y, int) {
    t[i] = smooth_at<kR>(a, i, y, H, W, taps, r, zero);
  });
  __syncthreads();
  for_pixels(H, W, [&](int i, int, int x) {
    sm[i] = smooth_at<kR>(t, i, x, W, 1, taps, r, zero);
  });
  __syncthreads();
}

// Steps 1-3 for the plane at `src`: on return (after a barrier) `sm` holds
// the smoothed plane and `ranked` the smoothed value at surviving peaks and
// `neg` elsewhere. `t` is scratch; `taps` (2r + 1 of them) lie in shared
// memory, written before the call. Every thread of the block calls it.
// Radius 2 (the PAF decoder's ksize 5) is compiled apart.
__device__ __forceinline__ void smooth_nms(const float* __restrict__ src, int H, int W,
                                        int64_t sy, int64_t sx, const float* taps, int r,
                                        float thresh, bool zero, float neg,
                                        float* __restrict__ ranked, float* __restrict__ t,
                                        float* __restrict__ sm) {
  int* cand = reinterpret_cast<int*>(t);
  float* a = ranked;  // the raw plane until the tie-break overwrites it
  // The strided load, kLoads values a thread in flight before any is stored.
  const int HW = H * W;
  for (int base = 0; base < HW; base += kThreads * kLoads) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      v[u] = i < HW ? src[(i / W) * sy + (i % W) * sx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < HW) a[i] = v[u];
    }
  }
  __syncthreads();
  if (r == 2) {
    smooth<2>(a, t, sm, H, W, taps, r, zero);
  } else {
    smooth<0>(a, t, sm, H, W, taps, r, zero);
  }

  // NMS + threshold: candidates hold their own pixel index, others -1. A
  // neighbour inside the plane must not exceed v; one outside reads as 0
  // with zero borders and is absent with reflect borders (-inf padding).
  for_pixels(H, W, [&](int i, int y, int x) {
    const float v = sm[i];
    const bool up = y > 0, down = y + 1 < H, left = x > 0, right = x + 1 < W;
    const bool outside = !zero || v >= 0.f;
    bool pk = v > thresh;
    pk &= up && left ? v >= sm[i - W - 1] : outside;
    pk &= up ? v >= sm[i - W] : outside;
    pk &= up && right ? v >= sm[i - W + 1] : outside;
    pk &= left ? v >= sm[i - 1] : outside;
    pk &= right ? v >= sm[i + 1] : outside;
    pk &= down && left ? v >= sm[i + W - 1] : outside;
    pk &= down ? v >= sm[i + W] : outside;
    pk &= down && right ? v >= sm[i + W + 1] : outside;
    cand[i] = pk ? i : -1;
  });
  __syncthreads();
  // Plateau tie-break: a candidate survives unless a candidate in its 3x3
  // window has a larger pixel index. The survivors' smoothed values form
  // the ranked plane.
  for_pixels(H, W, [&](int i, int y, int x) {
    const bool up = y > 0, down = y + 1 < H, left = x > 0, right = x + 1 < W;
    bool keep = cand[i] == i;
    keep &= up && left ? cand[i - W - 1] < i : true;
    keep &= up ? cand[i - W] < i : true;
    keep &= up && right ? cand[i - W + 1] < i : true;
    keep &= left ? cand[i - 1] < i : true;
    keep &= right ? cand[i + 1] < i : true;
    keep &= down && left ? cand[i + W - 1] < i : true;
    keep &= down ? cand[i + W] < i : true;
    keep &= down && right ? cand[i + W + 1] < i : true;
    ranked[i] = keep ? sm[i] : neg;
  });
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) peak_topk_kernel(
    const float* __restrict__ conf, int H, int W, int P, int64_t sb,
    int64_t sy, int64_t sx, int64_t sp, Taps taps, int ntaps, float thresh,
    int K, int zero_border, float* __restrict__ out_xy,
    float* __restrict__ out_raw, float* __restrict__ out_sval) {
  extern __shared__ __align__(16) float smem[];
  const int HW = H * W;
  // The survivors' values and pixel indices (16-byte aligned, padded to a
  // multiple of 4 entries with values that beat nothing), then the planes.
  const int cap4 = list_capacity(H, W);
  float* list_v = smem;
  int* list_i = reinterpret_cast<int*>(smem + cap4);
  float* a = smem + 2 * cap4;  // the ranked plane
  float* t = a + HW;           // scratch
  float* sm = a + 2 * HW;      // smoothed plane
  __shared__ float sel_v[kMaxK];
  __shared__ int sel_i[kMaxK];
  __shared__ int n_surv;
  __shared__ float s_taps[kMaxTaps];

  const bool zero = zero_border != 0;
  const int tid = threadIdx.x;
  const int bp = blockIdx.x;
  const int b = bp / P;
  const int p = bp % P;
  const float* src = conf + b * sb + p * sp;
  if (tid == 0) n_surv = 0;
  if (tid < ntaps) s_taps[tid] = taps.t[tid];
  for (int j = tid; j < cap4; j += kThreads) list_v[j] = -INFINITY;
  smooth_nms(src, H, W, sy, sx, s_taps, ntaps / 2, thresh, zero, kNeg, a, t, sm);

  // Compact the survivors (any order: each entry carries its pixel index).
  const int lane = tid & 31;
  for (int base = 0; base < HW; base += kThreads) {
    const int i = base + tid;
    const bool keep = i < HW && a[i] > kNeg;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (mask == 0) continue;
    int first = 0;
    if (lane == 0) first = atomicAdd(&n_surv, __popc(mask));
    first = __shfl_sync(0xffffffffu, first, 0);
    const int pos = first + __popc(mask & ((1u << lane) - 1u));
    if (keep && pos < cap4) {
      list_i[pos] = i;
      list_v[pos] = a[i];
    }
  }
  __syncthreads();
  const int n = min(n_surv, cap4);

  // Rank each survivor by the entries that beat it, 16 entries between
  // checks of rank < K; slot `rank` if it is.
  const float4* lv4 = reinterpret_cast<const float4*>(list_v);
  const int4* li4 = reinterpret_cast<const int4*>(list_i);
  const int n4 = (n + 3) / 4;
  for (int q = tid; q < n; q += kThreads) {
    const float v = list_v[q];
    const int i = list_i[q];
    int rank = 0;
    for (int j = 0; j < n4 && rank < K; j += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < n4) {
          const float4 vv = lv4[j + u];
          const int4 ii = li4[j + u];
          rank += beats(vv.x, ii.x, v, i) + beats(vv.y, ii.y, v, i) +
                  beats(vv.z, ii.z, v, i) + beats(vv.w, ii.w, v, i);
        }
      }
    }
    if (rank < K) {
      sel_v[rank] = v;
      sel_i[rank] = i;
    }
  }
  // Fillers for slots n .. K - 1.
  if (n < K) {
    if (zero) {
      for (int k = n + tid; k < K; k += kThreads) {
        sel_v[k] = kNeg;
        sel_i[k] = 0;
      }
    } else if (tid < HW && tid < K + n && !(a[tid] > kNeg)) {
      int below = 0;  // survivors with a smaller pixel index
      for (int j = 0; j < n; ++j) below += list_i[j] < tid;
      const int k = n + tid - below;
      if (k < K) {
        sel_v[k] = kNeg;
        sel_i[k] = tid;
      }
    }
  }
  __syncthreads();

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
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_taps[kMaxTaps];
  const int HW = H * W;
  float* ranked = smem;
  float* sm = smem + 2 * HW;
  const int bp = blockIdx.x;
  const float* src = conf + (bp / P) * sb + (bp % P) * sp;
  if (threadIdx.x < ntaps) s_taps[threadIdx.x] = taps.t[threadIdx.x];
  smooth_nms(src, H, W, sy, sx, s_taps, ntaps / 2, thresh, true, neg, ranked,
             smem + HW, sm);
  const int64_t o = static_cast<int64_t>(bp) * HW;
  for (int i = threadIdx.x; i < HW; i += blockDim.x) {
    out_ranked[o + i] = ranked[i];
    out_sm[o + i] = sm[i];
  }
}

// Copies the taps and raises the kernel's dynamic shared memory limit when
// the three planes and `extra` floats need more than 48 KB. Returns a CUDA
// error code.
template <typename Kernel>
int prepare(Kernel kernel, const void* taps_host, int ntaps, int H, int W,
            size_t extra, Taps* taps, size_t* smem) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* th = static_cast<const float*>(taps_host);
  for (int i = 0; i < ntaps; ++i) taps->t[i] = th[i];
  *smem = (3 * static_cast<size_t>(H) * W + extra) * sizeof(float);
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
// raw [B, P, K], sval [B, P, K]. K <= 128 and K <= H*W; thresh > -1e30
// (the selection relies on it). Returns cudaGetLastError() after the
// launch.
extern "C" int hp_peak_topk(const void* conf, int B, int H, int W, int P,
                            int64_t sb, int64_t sy, int64_t sx, int64_t sp,
                            const void* taps_host, int ntaps, float thresh,
                            int K, int zero_border, void* xy, void* raw,
                            void* sval, void* stream) {
  if (K < 1 || K > kMaxK || K > H * W || !(thresh > kNeg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps{};
  size_t smem = 0;
  const int e = prepare(peak_topk_kernel, taps_host, ntaps, H, W, 2 * list_capacity(H, W),
                        &taps, &smem);
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
  const int e = prepare(peak_candidates_kernel, taps_host, ntaps, H, W, 0, &taps,
                        &smem);
  if (e != 0) return e;
  if (B * P * H * W == 0) return static_cast<int>(cudaGetLastError());
  peak_candidates_kernel<<<B * P, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), H, W, P, sb, sy, sx, sp, taps, ntaps,
      thresh, neg, static_cast<float*>(ranked), static_cast<float*>(smoothed));
  return static_cast<int>(cudaGetLastError());
}
