// PifPaf skeleton growth for Hopper (sm_90a). Replaces the Pallas TPU kernel
// hyperpose_tpu/ops/pallas/grow_kernel.py fused_grow (semantics of
// hyperpose_tpu/ops/pifpaf_decode.py _grow_xla).
//
// Every seed slot of every image grows one annotation (score, x, y, scale
// of P parts) for `steps` Jacobi rounds. A round evaluates find_connection
// on each directed edge e from the state at the round's start (masked
// Gaussian weights over the edge's K candidates, best and second best with
// ties to the lowest index, the 2-best blend), checks the reverse match on
// the edge's reverse tables, and commits to each part its best incoming
// edge (the lowest edge index on ties) where that merge score is > 0.
//
// Bound: latency. At the serving size (B=8, MH=32, 8 rounds, E=38, K=128,
// reverse matching) the arithmetic is small (at most 19.9 M candidate
// evaluations of about 20 float32 operations and one expf each) and the
// tables are 1.9 MB, but every round is a chain of dependent steps: load
// the candidates, two argmax reductions, gathers at the two winners, the
// reverse check (the same again), then the commit.
//
// Design.
//   - One block of 16 warps serves S seed slots of one image (S chosen so
//     that the grid is about one block per SM: 128 blocks of 2 slots at the
//     serving size), so the card is full in one wave.
//   - The image's six match-side tables (m_x, m_y, m_s, forward and
//     reverse; 117 KB at the serving size) are copied into shared memory
//     once, by cp.async, before round 0; the rounds read them there. The
//     output-side tables are read only at the two winners, from L1/L2.
//   - A round evaluates only the edges that can commit: an edge whose source
//     part has not grown (score <= 0) or whose destination has (score > 0)
//     has merge score 0 in every case, so it is skipped; the remaining
//     (slot, edge) pairs are compacted into a task list and spread over the
//     warps, one edge per warp. The reverse check runs only where the
//     forward merge score is > 0. A round with no task changes nothing, so
//     the rounds stop there.
//   - Best and second best: each lane keeps its own over its K/32
//     candidates, then two redux.sync operations find the warp's largest
//     value (as an order-preserving integer key) and the lowest index that
//     holds it.
//   - Each part's incoming edges are listed once (in edge order) so the
//     commit reads only those.
// Every read of a round happens before a barrier and every write after it:
// the update is the Jacobi update of the JAX decoder.
//
// Arithmetic: every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) in the order of the plain
// PyTorch version (ops/kernels/grow.py fused_grow_plain), expf and sqrtf are
// the accurate library functions, and the file is built without fast math,
// so nothing is contracted into an FMA and the kernel equals the plain
// version bit for bit.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 32;
constexpr int kMaxE = 64;
constexpr int kPerLane = 8;
constexpr int kMaxK = 32 * kPerLane;
constexpr int kMaxSeeds = 8;                 // seed slots per block
constexpr int kStageBytes = 192 * 1024;      // shared memory for tables
constexpr unsigned kFull = 0xffffffffu;

// em_x, em_y, em_s, eo_x, eo_y, eo_s, then the same six reverse tables; each
// contiguous float [B, E, K].
struct Tables {
  const float* t[12];
};

// Edge ends, and each part's incoming edges in edge order: part p's are
// in_edge[in_start[p] .. in_start[p+1]).
struct Edges {
  int src[kMaxE];
  int dst[kMaxE];
  int in_start[kMaxP + 1];
  int in_edge[kMaxE];
};

struct Conn {
  float c, x, y, s;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// An integer key in the order of the float values (for values that are not
// NaN); -0 and +0 share the key of +0, as they compare equal.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v == 0.f ? 0.f : v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Every lane ends with the warp's best (value, index) of the lanes' own:
// the largest value, the lowest index among equal values.
__device__ __forceinline__ void warp_best(float& v, int& i) {
  const int k = order_key(v);
  const int kmax = __reduce_max_sync(kFull, k);
  i = static_cast<int>(__reduce_min_sync(
      kFull, k == kmax ? static_cast<unsigned>(i) : 0xffffffffu));
  v = key_value(kmax);
}

// find_connection of the query (qx, qy, qs) against one edge's K candidates
// (match side m_*, in shared or global memory; output side o_*). Called by
// all 32 lanes of a warp; every lane returns the result.
__device__ Conn find_connection(const float* m_x, const float* m_y,
                                const float* m_s, const float* o_x,
                                const float* o_y, const float* o_s, int K,
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

// Copies n floats of one table into shared memory (cp.async where 16-byte
// chunks line up, else plain loads) and returns the copy.
__device__ const float* stage_table(float* dst, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + 4 * i))),
                   "l"(src + 4 * i)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
  return dst;
}

__global__ void __launch_bounds__(kThreads) grow_kernel(
    const int* __restrict__ seed_part, const float* __restrict__ seed_vals,
    Tables tb, Edges edges, int MH, int E, int K, int P, int steps,
    int reverse_match, int S, int staged, float* __restrict__ out_score,
    float* __restrict__ out_x, float* __restrict__ out_y,
    float* __restrict__ out_sc) {
  extern __shared__ __align__(16) float stage[];  // staged match tables
  __shared__ float ann[kMaxSeeds][4][kMaxP];     // score, x, y, scale
  __shared__ float e_merge[kMaxSeeds][kMaxE], e_x[kMaxSeeds][kMaxE],
      e_y[kMaxSeeds][kMaxE], e_s[kMaxSeeds][kMaxE];
  __shared__ int e_src[kMaxE], e_dst[kMaxE], in_edge[kMaxE];
  __shared__ int in_start[kMaxP + 1];
  __shared__ int task[kMaxSeeds * kMaxE];
  __shared__ int n_task;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nsg = (MH + S - 1) / S;
  const int b = blockIdx.x / nsg;
  const int m0 = (blockIdx.x % nsg) * S;
  const int ns = min(S, MH - m0);  // seed slots of this block

  // This image's tables; the match sides of `staged` directions (forward,
  // then reverse) are read from their copies in shared memory.
  const int n = E * K;
  const int64_t base = static_cast<int64_t>(b) * n;
  const float *mf[3], *of[3], *mr[3], *orv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mf[i] = tb.t[i] + base;
    of[i] = tb.t[3 + i] + base;
    mr[i] = tb.t[6 + i] + base;
    orv[i] = tb.t[9 + i] + base;
  }
  if (staged >= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mf[i] = stage_table(stage + i * n, mf[i], n);
  }
  if (staged >= 2) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mr[i] = stage_table(stage + (3 + i) * n, mr[i], n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int i = tid; i < E; i += kThreads) {
    e_src[i] = edges.src[i];
    e_dst[i] = edges.dst[i];
    in_edge[i] = edges.in_edge[i];
  }
  for (int i = tid; i <= P; i += kThreads) in_start[i] = edges.in_start[i];
  // The seed's part holds (x, y, scale, score); the others hold 0 * value,
  // as the one-hot product of the plain version.
  for (int i = tid; i < ns * P; i += kThreads) {
    const int s = i / P, p = i % P;
    const int64_t bm = static_cast<int64_t>(b) * MH + m0 + s;
    const float oh = p == seed_part[bm] ? 1.f : 0.f;
    const float* sv = seed_vals + 4 * bm;
    ann[s][0][p] = __fmul_rn(oh, sv[3]);
    ann[s][1][p] = __fmul_rn(oh, sv[0]);
    ann[s][2][p] = __fmul_rn(oh, sv[1]);
    ann[s][3][p] = __fmul_rn(oh, sv[2]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    // Tasks: the (slot, edge) pairs whose source has grown and whose
    // destination has not; every other edge's merge score is 0.
    if (tid == 0) n_task = 0;
    __syncthreads();
    for (int i = tid; i < ns * E; i += kThreads) {
      const int s = i / E, e = i % E;
      e_merge[s][e] = 0.f;
      if (ann[s][0][e_src[e]] > 0.f && ann[s][0][e_dst[e]] <= 0.f) {
        task[atomicAdd(&n_task, 1)] = i;
      }
    }
    __syncthreads();
    const int nt = n_task;
    if (nt == 0) break;  // nothing can commit now or in any later round

    for (int t = warp; t < nt; t += kWarps) {
      const int s = task[t] / E, e = task[t] % E;
      const int sp = e_src[e];
      const float src_score = ann[s][0][sp];
      const float qx = ann[s][1][sp], qy = ann[s][2][sp], qs = ann[s][3][sp];
      const int o = e * K;
      const Conn f = find_connection(mf[0] + o, mf[1] + o, mf[2] + o,
                                     of[0] + o, of[1] + o, of[2] + o, K, qx,
                                     qy, qs, lane);
      float merge = sqrtf(fmaxf(__fmul_rn(f.c, src_score), 0.f));
      if (reverse_match && merge > 0.f) {  // a merge score of 0 stays 0
        const Conn r = find_connection(mr[0] + o, mr[1] + o, mr[2] + o,
                                       orv[0] + o, orv[1] + o, orv[2] + o, K,
                                       f.x, f.y, f.s, lane);
        const float dist = __fadd_rn(fabsf(__fsub_rn(qx, r.x)),
                                     fabsf(__fsub_rn(qy, r.y)));
        if (!(r.c > 0.f && dist <= qs)) merge = 0.f;
      }
      if (!(f.c > 0.f)) merge = 0.f;
      if (lane == 0) {
        e_merge[s][e] = merge;
        e_x[s][e] = f.x;
        e_y[s][e] = f.y;
        e_s[s][e] = f.s;
      }
    }
    __syncthreads();
    for (int i = tid; i < ns * P; i += kThreads) {
      const int s = i / P, p = i % P;
      float best = 0.f;
      int ib = -1;
      for (int k = in_start[p]; k < in_start[p + 1]; ++k) {
        const int e = in_edge[k];
        if (e_merge[s][e] > best) {
          best = e_merge[s][e];
          ib = e;
        }
      }
      if (ib >= 0) {
        ann[s][0][p] = best;
        ann[s][1][p] = e_x[s][ib];
        ann[s][2][p] = e_y[s][ib];
        ann[s][3][p] = e_s[s][ib];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < ns * P; i += kThreads) {
    const int s = i / P, p = i % P;
    const int64_t o = (static_cast<int64_t>(b) * MH + m0 + s) * P + p;
    out_score[o] = ann[s][0][p];
    out_x[o] = ann[s][1][p];
    out_y[o] = ann[s][2][p];
    out_sc[o] = ann[s][3][p];
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
    ++edges.in_start[dst[e] + 1];
  }
  for (int p = 0; p < P; ++p) edges.in_start[p + 1] += edges.in_start[p];
  int fill[kMaxP] = {};
  for (int e = 0; e < E; ++e) {
    edges.in_edge[edges.in_start[dst[e]] + fill[dst[e]]++] = e;
  }
  if (B * MH == 0) return static_cast<int>(cudaGetLastError());

  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // About one block per SM: S slots each, at most kMaxSeeds.
  int S = (B * MH + sms - 1) / sms;
  S = S < 1 ? 1 : (S > kMaxSeeds ? kMaxSeeds : S);
  const int blocks = B * ((MH + S - 1) / S);
  const int64_t side = 3 * static_cast<int64_t>(E) * K * sizeof(float);
  const int staged = static_cast<int>(kStageBytes / side > 2 ? 2 : kStageBytes / side);
  const int smem = static_cast<int>(staged * side);
  rc = cudaFuncSetAttribute(grow_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  grow_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed_part), static_cast<const float*>(seed_vals),
      tb, edges, MH, E, K, P, steps, reverse_match, S, staged,
      static_cast<float*>(score), static_cast<float*>(x),
      static_cast<float*>(y), static_cast<float*>(sc));
  return static_cast<int>(cudaGetLastError());
}
