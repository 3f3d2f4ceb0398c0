// PifPaf skeleton growth for Hopper (sm_90a). Replaces the Pallas TPU kernel
// hyperpose_tpu/ops/pallas/grow_kernel.py fused_grow (semantics of
// hyperpose_tpu/ops/pifpaf_decode.py _grow_xla).
//
// One block of 256 threads (8 warps) per (image, seed slot). The block keeps
// the annotation (score, x, y, scale) of its P parts and the per-edge results
// of the current round in shared memory and runs all `steps` rounds:
//
//   1. each warp takes directed edges e = warp, warp + 8, ...; it reads the
//      state of the edge's source and destination parts (direct indexing by
//      e_src[e] / e_dst[e]: the TPU kernel's one-hot [P, E] contractions are
//      gathers), then evaluates find_connection over the K candidates of
//      the edge, 32 lanes with up to 8 candidates each: masked Gaussian
//      weight, best and second best by a warp-shuffle reduction over (value,
//      index) pairs with the lower index winning ties, the 2-best blend.
//      With reverse matching it evaluates edge e's reverse tables at the
//      found point and checks |qx - rx| + |qy - ry| <= qs;
//   2. after a barrier each part takes its best incoming edge (the lowest
//      edge index on ties) and commits where that merge score is > 0.
//
// All reads of a round happen before the barrier and all writes after it, so
// the update is the Jacobi update of the JAX decoder.
//
// Arithmetic: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the order of the plain
// PyTorch version (ops/kernels/grow.py fused_grow_plain), expf and sqrtf are
// the accurate library functions, and the file is built without fast math,
// so nothing is contracted into an FMA and the kernel equals the plain
// version bit for bit.
//
// Bound: operations. At the serving size (B=8, MH=32, 8 rounds, E=38,
// K=128, reverse matching) a call makes 19.9 M candidate evaluations of
// about 20 float32 operations and one expf each (~0.4 GFLOP), while it reads
// about 1 MB of tables (each image's 12 tables are re-read by its 32 blocks
// out of L2) and writes 33 KB.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 32;
constexpr int kMaxE = 64;
constexpr int kPerLane = 8;
constexpr int kMaxK = 32 * kPerLane;
constexpr unsigned kFull = 0xffffffffu;

// em_x, em_y, em_s, eo_x, eo_y, eo_s, then the same six reverse tables; each
// contiguous float [B, E, K].
struct Tables {
  const float* t[12];
};

struct Edges {
  int src[kMaxE];
  int dst[kMaxE];
};

struct Conn {
  float c, x, y, s;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Every lane ends with the warp's best (value, index): the largest value,
// the lowest index among equal values.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// find_connection of the query (qx, qy, qs) against one edge's K candidates
// (match side m_*, output side o_*). Called by all 32 lanes of a warp; every
// lane returns the result.
__device__ Conn find_connection(const float* __restrict__ m_x,
                                const float* __restrict__ m_y,
                                const float* __restrict__ m_s,
                                const float* __restrict__ o_x,
                                const float* __restrict__ o_y,
                                const float* __restrict__ o_s, int K,
                                float qx, float qy, float qs, int lane) {
  const float sf = __fmul_rn(2.f, qs);
  const float sg = fmaxf(__fmul_rn(__fmul_rn(0.25f, qs), qs), 1e-6f);
  float w[kPerLane];
  float s1 = -INFINITY;
  int i1 = INT_MAX;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int j = lane + 32 * r;
    float wj = -INFINITY;  // no candidate: never chosen
    if (j < K) {
      const float dx = __fsub_rn(m_x[j], qx);
      const float dy = __fsub_rn(m_y[j], qy);
      wj = 0.f;
      if (fabsf(dx) <= sf && fabsf(dy) <= sf) {
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        wj = __fmul_rn(expf(__fdiv_rn(__fmul_rn(-0.5f, d2), sg)), m_s[j]);
      }
    }
    w[r] = wj;
    if (better(wj, j, s1, i1)) {
      s1 = wj;
      i1 = j;
    }
  }
  warp_best(s1, i1);
  float s2 = -INFINITY;
  int i2 = INT_MAX;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int j = lane + 32 * r;
    const float wj = j == i1 ? 0.f : w[r];
    if (better(wj, j, s2, i2)) {
      s2 = wj;
      i2 = j;
    }
  }
  warp_best(s2, i2);

  Conn out{0.f, 0.f, 0.f, 0.f};
  if (!(s1 > 0.f)) return out;  // no match (s1 <= 0)
  const float o1x = o_x[i1], o1y = o_y[i1], o1s = o_s[i1];
  const float o2x = o_x[i2], o2y = o_y[i2], o2s = o_s[i2];
  const bool second_bad = s2 < 0.01f || s2 < __fmul_rn(0.5f, s1);
  const float ddx = __fsub_rn(o1x, o2x), ddy = __fsub_rn(o1y, o2y);
  const float d12 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
  const bool too_far = d12 > __fdiv_rn(__fmul_rn(o1s, o1s), 4.f);
  if (second_bad || too_far) {
    out.c = __fmul_rn(0.5f, s1);
    out.x = o1x;
    out.y = o1y;
    out.s = o1s;
    return out;
  }
  const float sum = __fadd_rn(s1, s2);
  const float denom = fmaxf(sum, 1e-12f);
  out.c = __fmul_rn(0.5f, sum);
  out.x = __fdiv_rn(__fadd_rn(__fmul_rn(o1x, s1), __fmul_rn(o2x, s2)), denom);
  out.y = __fdiv_rn(__fadd_rn(__fmul_rn(o1y, s1), __fmul_rn(o2y, s2)), denom);
  out.s = __fdiv_rn(__fadd_rn(__fmul_rn(o1s, s1), __fmul_rn(o2s, s2)), denom);
  return out;
}

__global__ void __launch_bounds__(kThreads) grow_kernel(
    const int* __restrict__ seed_part, const float* __restrict__ seed_vals,
    Tables tb, Edges edges, int MH, int E, int K, int P, int steps,
    int reverse_match, float* __restrict__ out_score,
    float* __restrict__ out_x, float* __restrict__ out_y,
    float* __restrict__ out_sc) {
  __shared__ float ann[4][kMaxP];  // score, x, y, scale
  __shared__ float e_merge[kMaxE], e_x[kMaxE], e_y[kMaxE], e_s[kMaxE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.x;
  const int b = bm / MH;

  // The seed's part holds (x, y, scale, score); the others hold 0 * value,
  // as the one-hot product of the plain version.
  const int sp = seed_part[bm];
  const float* sv = seed_vals + 4 * static_cast<int64_t>(bm);
  for (int p = tid; p < P; p += kThreads) {
    const float oh = p == sp ? 1.f : 0.f;
    ann[0][p] = __fmul_rn(oh, sv[3]);
    ann[1][p] = __fmul_rn(oh, sv[0]);
    ann[2][p] = __fmul_rn(oh, sv[1]);
    ann[3][p] = __fmul_rn(oh, sv[2]);
  }
  __syncthreads();

  const int64_t base = static_cast<int64_t>(b) * E * K;
  for (int step = 0; step < steps; ++step) {
    for (int e = warp; e < E; e += kWarps) {
      const int s = edges.src[e], d = edges.dst[e];
      const float src_score = ann[0][s], dst_score = ann[0][d];
      const float qx = ann[1][s], qy = ann[2][s], qs = ann[3][s];
      const int64_t o = base + static_cast<int64_t>(e) * K;
      const Conn f = find_connection(tb.t[0] + o, tb.t[1] + o, tb.t[2] + o,
                                     tb.t[3] + o, tb.t[4] + o, tb.t[5] + o,
                                     K, qx, qy, qs, lane);
      float merge = sqrtf(fmaxf(__fmul_rn(f.c, src_score), 0.f));
      if (reverse_match) {
        const Conn r = find_connection(tb.t[6] + o, tb.t[7] + o, tb.t[8] + o,
                                       tb.t[9] + o, tb.t[10] + o, tb.t[11] + o,
                                       K, f.x, f.y, f.s, lane);
        const float dist = __fadd_rn(fabsf(__fsub_rn(qx, r.x)),
                                     fabsf(__fsub_rn(qy, r.y)));
        if (!(r.c > 0.f && dist <= qs)) merge = 0.f;
      }
      if (!(src_score > 0.f && dst_score <= 0.f && f.c > 0.f)) merge = 0.f;
      if (lane == 0) {
        e_merge[e] = merge;
        e_x[e] = f.x;
        e_y[e] = f.y;
        e_s[e] = f.s;
      }
    }
    __syncthreads();
    for (int p = tid; p < P; p += kThreads) {
      float best = 0.f;
      int ib = -1;
      for (int e = 0; e < E; ++e) {
        if (edges.dst[e] == p && e_merge[e] > best) {
          best = e_merge[e];
          ib = e;
        }
      }
      if (ib >= 0) {
        ann[0][p] = best;
        ann[1][p] = e_x[ib];
        ann[2][p] = e_y[ib];
        ann[3][p] = e_s[ib];
      }
    }
    __syncthreads();
  }

  const int64_t o = static_cast<int64_t>(bm) * P;
  for (int p = tid; p < P; p += kThreads) {
    out_score[o + p] = ann[0][p];
    out_x[o + p] = ann[1][p];
    out_y[o + p] = ann[2][p];
    out_sc[o + p] = ann[3][p];
  }
}

}  // namespace

// seed_part: int [B, MH]; seed_vals: float [B, MH, 4] (x, y, scale, score);
// tables: host array of 12 device pointers, each a contiguous float
// [B, E, K] table; e_src, e_dst: host int arrays of E part indices in
// [0, P). Outputs contiguous float [B, MH, P]. P <= 32, E <= 64, K <= 256.
// Returns cudaGetLastError() after the launch.
extern "C" int hp_fused_grow(const void* seed_part, const void* seed_vals,
                             const void* tables, const void* e_src,
                             const void* e_dst, int B, int MH, int E, int K,
                             int P, int steps, int reverse_match, void* score,
                             void* x, void* y, void* sc, void* stream) {
  if (P < 1 || P > kMaxP || E < 1 || E > kMaxE || K < 1 || K > kMaxK ||
      steps < 0 || B < 0 || MH < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables tb{};
  const float* const* tp = static_cast<const float* const*>(tables);
  for (int i = 0; i < 12; ++i) tb.t[i] = tp[i];
  Edges edges{};
  const int* src = static_cast<const int*>(e_src);
  const int* dst = static_cast<const int*>(e_dst);
  for (int e = 0; e < E; ++e) {
    if (src[e] < 0 || src[e] >= P || dst[e] < 0 || dst[e] >= P) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    edges.src[e] = src[e];
    edges.dst[e] = dst[e];
  }
  if (B * MH == 0) return static_cast<int>(cudaGetLastError());
  grow_kernel<<<B * MH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed_part), static_cast<const float*>(seed_vals),
      tb, edges, MH, E, K, P, steps, reverse_match,
      static_cast<float*>(score), static_cast<float*>(x),
      static_cast<float*>(y), static_cast<float*>(sc));
  return static_cast<int>(cudaGetLastError());
}
