// Peak front end of the PAF decoder for Hopper (sm_90a), two kernels that
// run the same smooth + NMS + tie-break arithmetic:
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
//     the decoder's use_pallas_peaks mode. It works on row bands, not whole
//     planes (see "peak_candidates: row bands" below).
//
// peak_topk_kernel: one block per (image, part) plane. The plane, its
// smoothed copy and one scratch plane live in shared memory (3 * H * W
// floats, 30 KB at 46x54), so the map is read from device memory once. A
// thread walks its pixels with (y, x) advanced incrementally (no division
// per pixel). Planes too large for a block's shared memory (with the
// survivor lists, about 14 bytes a pixel: above roughly 16,500 pixels, such
// as the evaluator's 120x160 maps of a 480x640 input) take a second
// instantiation of the same kernel, which keeps the three planes in a device
// scratch buffer that the caller allocates (`hp_peak_topk_scratch` gives its
// size) and the lists in shared memory; at those sizes the scratch of a
// batch lies in L2 (33 MB at 8 x 18 planes of 120x160). Where even the
// lists do not fit (above about 115,000 pixels) they go to the scratch too.
// The host picks the path from the bytes a plane needs; the arithmetic and
// the selection are the same on both, so both equal the plain version bit
// for bit.
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
// With one block a plane, as peak_topk, its time was one block's chain: the
// strided NHWC load (a 32-byte sector a value) and five barrier-separated
// passes over 2,484 pixels, on 144 blocks (a few SMs holding two). Its band
// kernel below spreads the planes over 216 small blocks, loads a column of
// a band in one round trip and has two barriers.
#include <cuda_runtime.h>

#include <atomic>
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
  // with zero borders and is absent with reflect borders (-inf padding). A
  // NaN anywhere in the window fails a compare (v > thresh where v is NaN),
  // so that pixel is no peak, as the Pallas kernel's NMS rules.
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

// kGlobal: the planes live in `scratch`, `scratch_stride` floats a block
// (a multiple of 4), and the lists too where `global_lists`; otherwise
// everything lies in dynamic shared memory and `scratch` is unused.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads) peak_topk_kernel(
    const float* __restrict__ conf, int H, int W, int P, int64_t sb,
    int64_t sy, int64_t sx, int64_t sp, Taps taps, int ntaps, float thresh,
    int K, int zero_border, float* __restrict__ out_xy,
    float* __restrict__ out_raw, float* __restrict__ out_sval,
    float* scratch, int64_t scratch_stride, int global_lists) {
  extern __shared__ __align__(16) float smem[];
  const int HW = H * W;
  const int tid = threadIdx.x;
  const int bp = blockIdx.x;
  // The survivors' values and pixel indices (16-byte aligned, padded to a
  // multiple of 4 entries with values that beat nothing), then the planes.
  const int cap4 = list_capacity(H, W);
  const bool lists_apart = kGlobal && !global_lists;  // lists in shared memory
  float* region = kGlobal ? scratch + bp * scratch_stride : smem;
  float* list_v = lists_apart ? smem : region;
  int* list_i = reinterpret_cast<int*>(list_v + cap4);
  float* a = lists_apart ? region : region + 2 * cap4;  // the ranked plane
  float* t = a + HW;           // scratch
  float* sm = a + 2 * HW;      // smoothed plane
  __shared__ float sel_v[kMaxK];
  __shared__ int sel_i[kMaxK];
  __shared__ int n_surv;
  __shared__ float s_taps[kMaxTaps];

  const bool zero = zero_border != 0;
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

// -- peak_candidates: row bands of the NHWC map ----------------------------
//
// A block owns a band of kRows output rows of G parts of one image (grid:
// part groups x bands x images), so the 144 planes of the flagship batch
// spread over a few hundred blocks and every SM gets an even share. A
// thread owns one (part, x) column of the band at a time:
//
//   1. it loads the column's raw rows y0 - r - 2 .. y0 + kRows + r + 1 (the
//      band and a halo of r for the smooth, 1 for the NMS and 1 for the
//      tie-break; rows outside the plane read 0) into registers, all loads
//      in flight together, and runs the vertical smooth there. Where the
//      map's part stride is below its x stride (the decoder's NHWC view),
//      consecutive threads take consecutive parts of a pixel, then the next
//      pixel: whole pixel rows, coalesced, the background channel skipped.
//      Otherwise consecutive threads take consecutive x of one part;
//   2. the horizontal smooth, from rows padded with r zero columns (the
//      zero border), into rows padded with two zero columns and holding
//      zero outside the plane (the NMS's zero border);
//   3. the NMS at its column and the two beside it: the 3x3 maximum as a
//      maximum along x then along y, in registers; a candidate holds its
//      pixel index. Repeating the neighbours' NMS costs less than a barrier
//      and a round trip through shared memory;
//   4. the tie-break the same way over those candidates (a candidate
//      survives iff it is the largest index of its window), and the writes
//      of both outputs, consecutive threads on consecutive x.
//
// Steps 2 and 3 read what the step before left in shared memory, after a
// barrier. The taps sit in registers; every product and sum is rounded on
// its own, centre first, as in smooth_nms. Only the plane's own edges are
// zero borders: a band's inner edge reads its halo. The maxima carry NaN
// (max_nan), as jnp.maximum does in the Pallas kernel's NMS, so a pixel
// with a NaN in its window fails `v >= max`, as it fails one of
// smooth_nms's eight compares. kMaxR = 2 serves ksize 3 and
// 5 (the decoder's), kMaxR = 15 every ksize up to 31. The launch picks G
// and, by the shared memory, shrinks G and then kRows until the planes fit:
// every shape the wrapper accepts runs on this kernel.
//
// What bounds it is not the bytes but each block's chain: the launch, the
// load round trip with the vertical pass, and the two barrier-separated
// passes after it, each of them a comparable share of the time.
struct Band {
  int parts;
  int st, ss;  // plane strides in floats: vertical pass, smoothed
};

__host__ __device__ inline Band band_geometry(int rows, int parts, int r, int W) {
  return Band{parts, ((rows + 4) * (W + 2 * r)) | 1, ((rows + 4) * (W + 4)) | 1};
}

inline size_t band_smem(const Band& g) {
  return static_cast<size_t>(g.parts) * (g.st + g.ss) * sizeof(float);
}

constexpr int kBandThreads = 256;  // threads a block at most: a thread may use 255 registers

// The larger of a and b, NaN if either is NaN (fmaxf drops a NaN operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int kRows, int kMaxR>
__global__ void __launch_bounds__(kBandThreads) peak_candidates_kernel(
    const float* __restrict__ conf, int H, int W, int P, int64_t sb,
    int64_t sy, int64_t sx, int64_t sp, const __grid_constant__ Taps taps, int r,
    Band bg, float thresh, float neg, float* __restrict__ out_ranked,
    float* __restrict__ out_sm) {
  constexpr int kT = kRows + 4;                  // rows of the smoothed band
  constexpr int kLoad = kRows + 2 * kMaxR + 4;   // raw rows loaded
  extern __shared__ __align__(16) float smem[];
  const int p0 = blockIdx.x * bg.parts, y0 = blockIdx.y * kRows;
  const int64_t b = blockIdx.z;
  const int G = min(bg.parts, P - p0), n = G * W;
  const int wt = W + 2 * r, ws = W + 4;
  float* ts = smem;  // vertical pass
  float* ss = smem + bg.parts * bg.st;
  // The taps in registers: lo[d] = taps[r - d], hi[d] = taps[r + d].
  float lo[kMaxR + 1], hi[kMaxR + 1];
#pragma unroll
  for (int d = 0; d <= kMaxR; ++d) {
    lo[d] = d <= r ? taps.t[r - d] : 0.f;
    hi[d] = d <= r ? taps.t[r + d] : 0.f;
  }

  // 1. Raw columns into registers, vertical smooth into ts[g][j][x + r]
  // (row j is y0 - 2 + j); its padding columns 0.
  const float* src = conf + b * sb + p0 * sp;
  const bool part_fastest = sp < sx;
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int g = part_fastest ? q % G : q / W, x = part_fastest ? q / G : q % W;
    const float* col = src + g * sp + x * sx;
    float raw[kLoad];
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const int y = y0 - kMaxR - 2 + k;
      raw[k] = y >= 0 && y < H ? __ldg(col + y * sy) : 0.f;
    }
    float* t = ts + g * bg.st + x + r;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int c = j + kMaxR;
      float acc = __fmul_rn(lo[0], raw[c]);
#pragma unroll
      for (int d = 1; d <= kMaxR; ++d) {
        if (d <= r) {
          acc = __fadd_rn(acc, __fmul_rn(lo[d], raw[c - d]));
          acc = __fadd_rn(acc, __fmul_rn(hi[d], raw[c + d]));
        }
      }
      t[j * wt] = acc;
    }
  }
  for (int q = threadIdx.x; q < G * kT * 2 * r; q += blockDim.x) {
    const int c = q % (2 * r), j = q / (2 * r) % kT, g = q / (2 * r * kT);
    ts[g * bg.st + j * wt + (c < r ? c : W + c)] = 0.f;
  }
  __syncthreads();

  // 2. Horizontal smooth into ss[g][j][x + 2], 0 outside the plane; two
  // zero columns on each side.
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int g = q / W, x = q % W;
    const float* t = ts + g * bg.st + x + r;
    float* s = ss + g * bg.ss + x + 2;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int y = y0 - 2 + j;
      float acc = 0.f;
      if (y >= 0 && y < H) {
        const float* c = t + j * wt;
        acc = __fmul_rn(lo[0], c[0]);
#pragma unroll
        for (int d = 1; d <= kMaxR; ++d) {
          if (d <= r) {
            acc = __fadd_rn(acc, __fmul_rn(lo[d], c[-d]));
            acc = __fadd_rn(acc, __fmul_rn(hi[d], c[d]));
          }
        }
      }
      s[j * ws] = acc;
    }
  }
  for (int q = threadIdx.x; q < G * kT * 4; q += blockDim.x) {
    const int c = q % 4, j = q / 4 % kT, g = q / (4 * kT);
    ss[g * bg.ss + j * ws + (c < 2 ? c : W + c)] = 0.f;
  }
  __syncthreads();

  // 3. NMS + threshold at columns x - 1, x, x + 1 and rows y0 - 1 ..
  // y0 + kRows (the pixel index of a candidate, else -1), then the
  // tie-break at x and the writes of rows y0 .. y0 + kRows - 1. A thread
  // repeats its neighbours' NMS rather than wait for it at a barrier.
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const int g = q / W, x = q % W;
    const float* s = ss + g * bg.ss + x + 2;
    float hmax[3][kT];  // 3x1 maxima centred on columns x - 1, x, x + 1
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const float* row = s + j * ws;
      const float m = max_nan(row[-1], row[0]);
      const float p = max_nan(row[0], row[1]);
      hmax[0][j] = max_nan(row[-2], m);
      hmax[1][j] = max_nan(m, row[1]);
      hmax[2][j] = max_nan(p, row[2]);
    }
    int cand[3][kRows + 2];
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      const int xo = x + o - 1;
#pragma unroll
      for (int j = 0; j < kRows + 2; ++j) {
        const int y = y0 - 1 + j;
        const float v = s[(j + 1) * ws + o - 1];
        const bool pk = xo >= 0 && xo < W && y >= 0 && y < H && v > thresh &&
                        v >= max_nan(max_nan(hmax[o][j], hmax[o][j + 1]), hmax[o][j + 2]);
        cand[o][j] = pk ? y * W + xo : -1;
      }
    }
    float* ranked = out_ranked + ((b * P + p0 + g) * H + y0) * W + x;
    float* smoothed = out_sm + ((b * P + p0 + g) * H + y0) * W + x;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (y0 + i < H) {
        int m = -1;
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          m = max(m, max(max(cand[o][i], cand[o][i + 1]), cand[o][i + 2]));
        }
        const float v = s[(i + 2) * ws];
        ranked[i * W] = m == (y0 + i) * W + x ? v : neg;
        smoothed[i * W] = v;
      }
    }
  }
}

}  // namespace

// The shared memory a block may use on the current device.
static int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(e);
}

// The dynamic shared memory a block of peak_topk_kernel may use on the
// current device: the opt-in limit less the kernel's static shared memory
// (the same for both instantiations). Read once a device, so a launch adds
// one cudaGetDevice to its host cost.
constexpr int kMaxDevices = 64;

static int topk_budget(size_t* budget) {
  static std::atomic<size_t> cached[kMaxDevices];  // 0: not read yet
  int dev = 0;
  int e = static_cast<int>(cudaGetDevice(&dev));
  if (e != 0) return e;
  if (dev < kMaxDevices && (*budget = cached[dev].load(std::memory_order_relaxed)) != 0) {
    return 0;
  }
  int optin = 0;
  e = smem_optin(&optin);
  if (e != 0) return e;
  cudaFuncAttributes attr{};
  e = static_cast<int>(cudaFuncGetAttributes(&attr, peak_topk_kernel<true>));
  if (e != 0) return e;
  *budget = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  if (dev < kMaxDevices) cached[dev].store(*budget, std::memory_order_relaxed);
  return 0;
}

// Where peak_topk_kernel keeps an H x W plane: everything in shared memory
// where the three planes and the two lists fit the budget; else the planes
// in device scratch, and the lists too where they alone do not fit (above
// about 115,000 pixels).
struct TopkPlan {
  size_t smem;             // dynamic shared memory, bytes
  int64_t scratch_stride;  // scratch floats a block (0: no scratch)
  bool global_lists;
};

static int topk_plan(int H, int W, TopkPlan* plan) {
  size_t budget = 0;
  const int e = topk_budget(&budget);
  if (e != 0) return e;
  const size_t planes = 3 * static_cast<size_t>(H) * W;
  const size_t lists = 2 * static_cast<size_t>(list_capacity(H, W));
  if ((planes + lists) * sizeof(float) <= budget) {
    *plan = {(planes + lists) * sizeof(float), 0, false};
  } else if (lists * sizeof(float) <= budget) {
    *plan = {lists * sizeof(float), static_cast<int64_t>((planes + 3) / 4 * 4), false};
  } else {
    *plan = {0, static_cast<int64_t>((planes + lists + 3) / 4 * 4), true};
  }
  return 0;
}

// The device scratch, in floats, that hp_peak_topk needs for each H x W
// plane on the current device (0 where a plane fits shared memory), and
// whether the survivor lists go there too.
extern "C" int hp_peak_topk_scratch(int H, int W, int64_t* floats, int* global_lists) {
  TopkPlan plan{};
  const int e = topk_plan(H, W, &plan);
  if (e != 0) return e;
  *floats = plan.scratch_stride;
  *global_lists = plan.global_lists;
  return 0;
}

// conf: float [B, H, W, P] with element strides (sb, sy, sx, sp); taps: host
// array of ntaps (odd, <= 31) floats; outputs contiguous: xy [B, P, K, 2],
// raw [B, P, K], sval [B, P, K]; scratch: B * P times the device floats
// hp_peak_topk_scratch gives (null where that is 0). K <= 128 and
// K <= H*W; thresh > -1e30 (the selection relies on it). Returns
// cudaGetLastError() after the launch.
extern "C" int hp_peak_topk(const void* conf, int B, int H, int W, int P,
                            int64_t sb, int64_t sy, int64_t sx, int64_t sp,
                            const void* taps_host, int ntaps, float thresh,
                            int K, int zero_border, void* xy, void* raw,
                            void* sval, void* scratch, void* stream) {
  if (K < 1 || K > kMaxK || K > H * W || !(thresh > kNeg) || ntaps < 1 ||
      ntaps > kMaxTaps || ntaps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps{};
  const float* th = static_cast<const float*>(taps_host);
  for (int i = 0; i < ntaps; ++i) taps.t[i] = th[i];
  TopkPlan plan{};
  const int e = topk_plan(H, W, &plan);
  if (e != 0) return e;
  const bool global = plan.scratch_stride > 0;
  if (global && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B * P == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = global ? peak_topk_kernel<true> : peak_topk_kernel<false>;
  if (plan.smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  kernel<<<B * P, kThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), H, W, P, sb, sy, sx, sp, taps, ntaps,
      thresh, K, zero_border, static_cast<float*>(xy),
      static_cast<float*>(raw), static_cast<float*>(sval),
      static_cast<float*>(scratch), plan.scratch_stride, plan.global_lists);
  return static_cast<int>(cudaGetLastError());
}

// conf as for hp_peak_topk; zero borders; outputs contiguous float
// [B, P, H, W]: ranked (the smoothed value at surviving peaks, `neg`
// elsewhere) and smoothed. Returns cudaErrorInvalidValue when no band fits
// a block's shared memory (W above about 3,600), else cudaGetLastError()
// after the launch.
extern "C" int hp_peak_candidates(const void* conf, int B, int H, int W,
                                  int P, int64_t sb, int64_t sy, int64_t sx,
                                  int64_t sp, const void* taps_host,
                                  int ntaps, float thresh, float neg,
                                  void* ranked, void* smoothed, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps || ntaps % 2 == 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(B) * P * H * W == 0) return static_cast<int>(cudaGetLastError());
  int optin = 0;
  const int e = smem_optin(&optin);
  if (e != 0) return e;
  Taps taps{};
  const float* th = static_cast<const float*>(taps_host);
  for (int i = 0; i < ntaps; ++i) taps.t[i] = th[i];
  const int r = ntaps / 2;
  // Bands of 16 rows and 2 parts (216 blocks of 108 columns at the
  // flagship's 8 x 46 x 54 x 18: the fastest of R in {4, 8, 16} and G in
  // {1, 2, 3, 6, 9, 18} there, measured on an H100); fewer parts, then fewer
  // rows, where that does not fit.
  int R = 16, G = P < 2 ? P : 2;
  const size_t budget = static_cast<size_t>(optin);
  while (band_smem(band_geometry(R, G, r, W)) > budget && (G > 1 || R > 4)) {
    if (G > 1) {
      G = 1;
    } else {
      R /= 2;
    }
  }
  const Band bg = band_geometry(R, G, r, W);
  const size_t smem = band_smem(bg);
  if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = r <= 2 ? (R == 4 ? peak_candidates_kernel<4, 2>
                          : R == 8 ? peak_candidates_kernel<8, 2> : peak_candidates_kernel<16, 2>)
                       : (R == 4 ? peak_candidates_kernel<4, 15>
                          : R == 8 ? peak_candidates_kernel<8, 15> : peak_candidates_kernel<16, 15>);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  const int n = G * W;
  const int threads = n >= kBandThreads ? kBandThreads : (n + 31) / 32 * 32;
  const dim3 grid((P + G - 1) / G, (H + R - 1) / R, B);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(conf), H, W, P, sb, sy, sx, sp, taps, r, bg,
      thresh, neg, static_cast<float*>(ranked), static_cast<float*>(smoothed));
  return static_cast<int>(cudaGetLastError());
}
