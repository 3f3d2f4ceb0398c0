// PAF line-integral scoring of every limb candidate pair for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperpose_tpu/ops/pallas/line_gather.py
// fused_line_gather together with the PyTorch ops around it in the decoder
// (hyperpose_tpu/ops/paf_decode.py _limb_pair_scores): for every image b,
// limb l = (part_a, part_b) and peak pair (i, j) it samples the limb's two
// PAF channels at S points on the segment from peak i of part_a to peak j of
// part_b and writes the pair's score, cand_score[b, l, i, j]
// (reference: src/paf.cpp:66-137). The TPU has no fast scattered gather, so
// it ran the lookup as a one-hot MXU contraction and the scoring as ~40
// separate XLA ops over [B, L, K, K, S] arrays. The card gathers directly, so
// the whole scoring is one thread per pair and one launch: no sample index
// or value array goes through device memory.
//
// Threads: one per (b, l, i, j), j fastest, so the stores of cand_score are
// coalesced and a warp shares its peak a. The limb table travels in the
// kernel's parameters (no device copy, no host sync; __grid_constant__, so
// that indexing it at run time reads the parameters where they lie instead
// of a copy in local memory). A pair whose peaks are
// not both valid, or whose length is not above 1e-6, scores -1e30 whatever
// its samples hold, so its thread returns before sampling. The S samples run
// serially in the thread, each as two 4-byte loads through the field's four
// strides, so any layout of the field runs. An 8-byte load of the two
// channels where they sit side by side (a channels-last map) measured no
// faster on the H100, so the kernel has no second branch for it.
//
// Bound: bytes. The field at the samples the valid pairs need (3.0 MB for the
// whole flagship field, which stays in L2 beside the decode), the peaks
// (39 KB) and cand_score (156 KB); per pair some 100 float operations, far
// below the memory time.
//
// Arithmetic: every product, sum, quotient and root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, so nvcc contracts nothing
// into an FMA), in the order of the plain version
// (ops/kernels/line_gather.py limb_scores_plain): the sample fraction i / S
// (divided once on the host, in float32, and passed in the parameters) and
// the mean sum / S are true divisions, 0.5 * H / max(upsample * norm, 1e-12)
// one division, and the S dot products are summed left to right. So
// the kernel equals the plain version bit for bit on the CPU and on the card.
// bf16 != 0 rounds each sampled value to bfloat16 (round to nearest even)
// and back, as `astype(bfloat16)` does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLimbs = 64;
constexpr int kMaxSamples = 32;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct LimbTable {
  int a[kMaxLimbs];
  int b[kMaxLimbs];
};

// The sample fractions i / S, each the float32 quotient (rounded once), as
// __fdiv_rn gives it.
struct Fractions {
  float t[kMaxSamples];
};

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int sample_at(float p, float t, float d, int n) {
  const float v = floorf(__fadd_rn(__fadd_rn(p, __fmul_rn(t, d)), 0.5f));
  return min(max(static_cast<int>(v), 0), n - 1);
}

__global__ void __launch_bounds__(kThreads) limb_scores_kernel(
    const float* __restrict__ paf, int64_t sb, int64_t sy, int64_t sx,
    int64_t sc, const float* __restrict__ xy, const uint8_t* __restrict__ valid,
    const __grid_constant__ LimbTable limbs, const __grid_constant__ Fractions fractions,
    int L, int P, int K, int H, int W,
    int S, float upsample, float paf_thresh, int crit1_thresh, int bf16,
    float* __restrict__ out, int total) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int j = t % K, q = t / K, i = q % K, bl = q / K, l = bl % L, b = bl / L;
  const int ia = (b * P + limbs.a[l]) * K + i;
  const int ib = (b * P + limbs.b[l]) * K + j;
  // Both peaks and their flags in one round trip.
  const float2 pa = __ldg(reinterpret_cast<const float2*>(xy) + ia);
  const float2 pb = __ldg(reinterpret_cast<const float2*>(xy) + ib);
  const bool both = valid[ia] & valid[ib];
  float score = kNeg;
  if (!both) {
    out[t] = score;
    return;
  }
  const float ax = pa.x, ay = pa.y;
  const float dx = __fsub_rn(pb.x, ax);
  const float dy = __fsub_rn(pb.y, ay);
  const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  if (!(norm > 1e-6f)) {
    out[t] = score;
    return;
  }
  const float den = fmaxf(norm, 1e-12f);
  const float ux = __fdiv_rn(dx, den), uy = __fdiv_rn(dy, den);
  const float* base = paf + b * sb + 2 * l * sc;
  float sum = 0.f;
  int count = 0;
#pragma unroll
  for (int s = 0; s < kMaxSamples; ++s) {
    if (s == S) break;
    const float ts = fractions.t[s];
    const int x = sample_at(ax, ts, dx, W);
    const int y = sample_at(ay, ts, dy, H);
    const float* p = base + y * sy + x * sx;
    float vx = __ldg(p);
    float vy = __ldg(p + sc);
    if (bf16) {
      vx = to_bf16(vx);
      vy = to_bf16(vy);
    }
    const float d = __fadd_rn(__fmul_rn(ux, vx), __fmul_rn(uy, vy));
    count += d > paf_thresh;
    sum = s == 0 ? d : __fadd_rn(sum, d);
  }
  const float mean = __fdiv_rn(sum, static_cast<float>(S));
  const float half_h = 0.5f * static_cast<float>(H);
  const float penalty = fminf(
      __fsub_rn(__fdiv_rn(half_h, fmaxf(__fmul_rn(upsample, norm), 1e-12f)), 1.f), 0.f);
  const float crit2 = __fadd_rn(mean, penalty);
  if (count > crit1_thresh && crit2 > 0.f) score = crit2;
  out[t] = score;
}

}  // namespace

// paf: float [B, H, W, 2L] with element strides (sb, sy, sx, sc); xy:
// contiguous float [B, P, K, 2], 8-byte aligned; valid: contiguous uint8 (bool) [B, P, K];
// limb_a, limb_b: host arrays of L (<= 64) part indices in [0, P); out:
// contiguous float [B, L, K, K], fewer than 2^31 elements. 1 <= S <= 32.
// Returns cudaErrorInvalidValue for arguments outside that contract, else
// cudaGetLastError() after the launch.
extern "C" int hp_limb_scores(const void* paf, int B, int H, int W, int L,
                              int64_t sb, int64_t sy, int64_t sx, int64_t sc,
                              const void* xy, const void* valid, int P, int K,
                              const int* limb_a, const int* limb_b, int S,
                              float upsample, float paf_thresh,
                              int crit1_thresh, int bf16, void* out,
                              void* stream) {
  const int64_t total = static_cast<int64_t>(B) * L * K * K;
  if (L < 1 || L > kMaxLimbs || S < 1 || S > kMaxSamples || K < 1 || H < 1 ||
      W < 1 || total >= (int64_t{1} << 31) || reinterpret_cast<uintptr_t>(xy) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LimbTable limbs{};
  for (int l = 0; l < L; ++l) {
    if (limb_a[l] < 0 || limb_a[l] >= P || limb_b[l] < 0 || limb_b[l] >= P) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    limbs.a[l] = limb_a[l];
    limbs.b[l] = limb_b[l];
  }
  if (total == 0) return static_cast<int>(cudaGetLastError());
  Fractions fractions{};
  for (int s = 0; s < S; ++s) fractions.t[s] = static_cast<float>(s) / static_cast<float>(S);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  limb_scores_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(paf), sb, sy, sx, sc,
      static_cast<const float*>(xy), static_cast<const uint8_t*>(valid), limbs,
      fractions, L, P, K, H, W, S, upsample, paf_thresh, crit1_thresh, bf16,
      static_cast<float*>(out), static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}
