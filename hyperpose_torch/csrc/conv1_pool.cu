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
// the input is loaded: it is never copied. Sums are float32; a bf16 result is
// rounded once, on the store.
//
// Bound. At B=8, 368x432 (Q = 216) this is a GEMM of M = B*H*Q = 635,904
// rows, N = 128, K = 384 (3 dy x 128 lanes): 62.5 GFLOP. In bf16 that takes
// 0.063 ms at the 989 TFLOP/s of the tensor cores, and the 204 MB it must
// move (the input once, the pooled output once) take 0.061 ms at 3.35 TB/s:
// operations and bytes are balanced.
//
// bf16 design (tensor cores). mma.sync.m16n8k16 with float32 accumulators.
// A warp owns one unit: 8 consecutive pairs q at the two image rows of one
// output row (MMA rows 0-7 at row 2*yo, 8-15 at 2*yo+1) by all 128 lanes n,
// so each thread holds both rows of a pool pair (fragment rows lane/4 and
// lane/4+8) and both lanes n and n+64 (n-tiles j and j+8): bias, ReLU and
// the 2x2 max stay in registers. The three dy slices of A are one strip of
// four input rows (2*yo-1 .. 2*yo+2) seen at three row offsets; the strip
// is loaded once by cp.async 16-byte chunks whose source size is 0 where a
// mask applies (zero fill covers rows -1 and H and the two border lane
// blocks) into a ring of six rows per warp, XOR-swizzled so that ldmatrix
// and the copies are free of bank conflicts. Warps are persistent: each
// walks a contiguous range of units down one column (image, q group), so
// consecutive units share two of their four rows and every input row is
// loaded from device memory once (plus two halo rows where a range starts);
// the next unit's two rows load while the current one multiplies. The
// weights (96 KB) are staged once per block in shared memory, in the order
// of the MMA's B fragments, so each thread fetches two n-tiles' fragments
// with one 16-byte load. One block of kTcWarps warps per SM.
//
// The float32 path (the parity path, TF32 off) keeps float32 FMA: one block
// of 256 threads owns 2 rows x 32 pairs, the 384-deep sum staged through
// shared memory in chunks of 32; its bound is 0.93 ms of operations at the
// 67 TFLOP/s of float32.
//
// The same GEMM without masks or pool, a [M, 384] @ [384, 128] product,
// is csrc/stem_gemm.cu (the port of the TPU matmul probe): it measures how
// close a plain bf16 GEMM of this shape comes to streaming device memory at
// full rate, on wgmma fed by TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16_t = __nv_bfloat16;

// -- float32: FMA ----------------------------------------------------------------

constexpr int kTQ = 32;           // output pairs q per block
constexpr int kM = 2 * kTQ;       // GEMM rows per block: 2 image rows x kTQ
constexpr int kN = 128;           // output lanes: [x=2q: 64 | x=2q+1: 64]
constexpr int kC = 128;           // input lanes per dy
constexpr int kKC = 32;           // depth of one staged chunk
constexpr int kThreads = 256;
constexpr int kAStride = kM + 1;  // padding: the staging stores use 32 banks

__global__ void __launch_bounds__(kThreads) conv1_pool_f32_kernel(
    const float* __restrict__ a, int H, int Q, int64_t sb, int64_t sh,
    int64_t sq, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out) {
  __shared__ float As[kKC][kAStride];           // As[k][m], m = r * kTQ + qi
  __shared__ __align__(16) float Ws[kKC][kN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lanes 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid >> 4;   // pairs qi = ty and ty + 16
  const int q0 = blockIdx.x * kTQ;
  const int yo = blockIdx.y;
  const int b = blockIdx.z;
  const float* ab = a + b * sb;

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
        const float* p = ab + y * sh + st_q * sq + c;
        const float4 lo = *reinterpret_cast<const float4*>(p);
        const float4 hi = *reinterpret_cast<const float4*>(p + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
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
            *reinterpret_cast<const float4*>(
                w + static_cast<int64_t>(dy * kC + c0 + k) * kN + n);
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
    float* o = out + ((static_cast<int64_t>(b) * ho + yo) * Q + q) * 64 + 4 * tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b0 = bias[4 * tx + j];
      const float b1 = bias[64 + 4 * tx + j];
      const float m = fmaxf(fmaxf(acc[s][0][j] + b0, acc[s][0][4 + j] + b1),
                            fmaxf(acc[s][1][j] + b0, acc[s][1][4 + j] + b1));
      o[j] = fmaxf(m, 0.f);
    }
  }
}

// -- bf16: tensor cores ------------------------------------------------------------

constexpr int kTcWarps = 10;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kK = 384;                        // 3 dy x 128 lanes
constexpr int kRowBytes = 128 * 2;             // 128 bf16 lanes of one q / row
constexpr int kTile = 8 * kRowBytes;           // 8 rows: one ldmatrix tile
constexpr int kRing = 6;                       // ring slots per warp
constexpr int kWarpRing = kRing * kTile;       // 12 KB
constexpr int kWBytes = kK * 128 * 2;          // 96 KB of fragment-ordered w
constexpr int kTcSmem = kWBytes + kTcWarps * kWarpRing;  // 221,184 B

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory to shared memory, or 16 zero bytes if !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w [384, 128] (k rows, n contiguous) into shared memory in B-fragment
// order: for k-step s (16 deep), n-tile j < 8 and lane l, 16 bytes hold the
// fragments (b0, b1) of n-tile j and then of n-tile j + 8, where b0 holds
// w[16s + 2(l%4) + {0,1}][8j + l/4] and b1 the same 8 rows further down.
__device__ void stage_weights(bf16_t* f, const bf16_t* __restrict__ w) {
  for (int c = threadIdx.x; c < kK * 16; c += blockDim.x) {
    const int k = c >> 4, nt = c & 15;  // w[k][8nt .. 8nt+7]
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + k * 128 + nt * 8));
    const bf16_t* e = reinterpret_cast<const bf16_t*>(&v);
    const int kk = k & 15;
    const int word = (((k >> 4) * 8 + (nt & 7)) * 32) * 4 + (nt >> 3) * 2 +
                     (kk >> 3);
    const int lq = (kk & 7) >> 1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      f[(word + (n * 4 + lq) * 4) * 2 + (kk & 1)] = e[n];
    }
  }
}

// The mainloop: one 128-deep slice (8 k-steps) of a warp's 16 x 128 tile.
// A's rows 0-7 are the swizzled 8-row tile at shared address lo, rows 8-15
// the one at hi (row r's 16-byte chunk c sits at chunk c ^ r); wf holds the
// slice's B fragments.
__device__ __forceinline__ void mma_k128(float (&acc)[16][4], uint32_t lo,
                                         uint32_t hi,
                                         const uint4* __restrict__ wf,
                                         int lane) {
  // ldmatrix.x4: lanes 8i..8i+7 address the rows of matrix i = (rows 0-7 |
  // 8-15) x (k 0-7 | 8-15) of the 16 x 16 A fragment.
  const int r = lane & 7;
  const uint32_t row = ((lane & 8) ? hi : lo) + r * kRowBytes;
  const int kh = lane >> 4;
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    uint32_t a[4];
    ldmatrix_x4(a, row + ((((st << 1) | kh) ^ r) << 4));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint4 b = wf[(st * 8 + j) * 32 + lane];
      mma_bf16(acc[j], a, b.x, b.y);
      mma_bf16(acc[j + 8], a, b.z, b.w);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// This warp's contiguous share [u0, u1) of `units` units, the grid's warps
// taking equal shares in order.
__device__ __forceinline__ void warp_range(int64_t units, int64_t& u0,
                                           int64_t& u1) {
  const int64_t nw = static_cast<int64_t>(gridDim.x) * kTcWarps;
  const int64_t gw =
      static_cast<int64_t>(blockIdx.x) * kTcWarps + (threadIdx.x >> 5);
  u0 = units * gw / nw;
  u1 = units * (gw + 1) / nw;
}

// Input row y of the unit at pairs q0 .. q0+7 of one image (masked) into a
// ring slot: 128 chunks of 16 bytes, pair qi's chunk ch at chunk ch ^ qi.
__device__ __forceinline__ void stage_row(uint32_t slot,
                                          const bf16_t* __restrict__ ab, int y,
                                          int H, int q0, int Q, int64_t sh,
                                          int64_t sq, int lane) {
  const bool row_ok = y >= 0 && y < H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i;
    const int qi = idx >> 4, ch = idx & 15;
    const int q = q0 + qi;
    const bool ok = row_ok && q < Q && !(q == 0 && ch < 4) &&
                    !(q == Q - 1 && ch >= 12);
    const bf16_t* src = ok ? ab + y * sh + q * sq + ch * 8 : ab;
    cp_async16(slot + qi * kRowBytes + ((ch ^ qi) << 4), src, ok);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1) conv1_pool_bf16_kernel(
    const bf16_t* __restrict__ a, int B, int H, int Q, int64_t sb, int64_t sh,
    int64_t sq, const bf16_t* __restrict__ w, const float* __restrict__ bias,
    bf16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  stage_weights(reinterpret_cast<bf16_t*>(smem), w);
  __syncthreads();
  const uint4* wf = reinterpret_cast<const uint4*>(smem);
  const uint32_t ring =
      smem_u32(smem + kWBytes + (threadIdx.x >> 5) * kWarpRing);

  // This thread's output lanes: n = 8j + 2(lane%4) + {0, 1} and n + 64.
  const int g = lane >> 2, t4 = lane & 3;
  float2 b_lo[8], b_hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * t4;
    b_lo[j] = make_float2(__ldg(bias + n), __ldg(bias + n + 1));
    b_hi[j] = make_float2(__ldg(bias + 64 + n), __ldg(bias + 65 + n));
  }

  const int ho = H / 2, nqg = (Q + 7) / 8;
  int64_t u0, u1;
  warp_range(static_cast<int64_t>(B) * nqg * ho, u0, u1);
  for (int64_t u = u0; u < u1; ++u) {
    const int yo = static_cast<int>(u % ho);
    const int64_t col = u / ho;
    const int q0 = static_cast<int>(col % nqg) * 8;
    const int b = static_cast<int>(col / nqg);
    const bf16_t* ab = a + b * sb;
    // Input row 2yo-1+t lives in slot (2yo+t) % kRing.
    if (u == u0 || yo == 0) {  // a new column: its first four rows
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        stage_row(ring + ((2 * yo + t) % kRing) * kTile, ab, 2 * yo - 1 + t,
                  H, q0, Q, sh, sq, lane);
      }
      cp_commit();
    }
    if (u + 1 < u1 && yo + 1 < ho) {  // the next unit's two new rows
#pragma unroll
      for (int t = 4; t < 6; ++t) {
        stage_row(ring + ((2 * yo + t) % kRing) * kTile, ab, 2 * yo - 1 + t,
                  H, q0, Q, sh, sq, lane);
      }
    }
    cp_commit();
    cp_wait<1>();  // every group but the prefetch: this unit's rows
    __syncwarp();

    float acc[16][4];
    zero(acc);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      mma_k128(acc, ring + ((2 * yo + dy) % kRing) * kTile,
               ring + ((2 * yo + dy + 1) % kRing) * kTile, wf + dy * 8 * 8 * 32,
               lane);
    }

    // Fragment rows g (image row 2yo) and g + 8 (2yo+1) of pair q0 + g;
    // n-tile j + 8 holds the pool partner of n-tile j.
    const int q = q0 + g;
    if (q < Q) {
      bf16_t* o = out + ((static_cast<int64_t>(b) * ho + yo) * Q + q) * 64 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v0 =
            fmaxf(fmaxf(acc[j][0] + b_lo[j].x, acc[j + 8][0] + b_hi[j].x),
                  fmaxf(acc[j][2] + b_lo[j].x, acc[j + 8][2] + b_hi[j].x));
        const float v1 =
            fmaxf(fmaxf(acc[j][1] + b_lo[j].y, acc[j + 8][1] + b_hi[j].y),
                  fmaxf(acc[j][3] + b_lo[j].y, acc[j + 8][3] + b_hi[j].y));
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
    __syncwarp();  // the ring's rows are read before the next unit refills
  }
}

// Persistent grid: at most one block per SM, none without work.
int tc_blocks(int64_t units, int& blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t need = (units + kTcWarps - 1) / kTcWarps;
  blocks = static_cast<int>(need < sms ? need : sms);
  return static_cast<int>(e);
}

}  // namespace

// a: [B, H, Q, 128] with element strides (sb, sh, sq) and contiguous lanes,
// 16-byte aligned rows; w: contiguous 16-byte aligned [3, 128, 128] of the
// same type; bias: float [128]; out: contiguous
// [B, H/2, Q, 64]. bf16 != 0 selects __nv_bfloat16 for a, w and out (tensor
// cores), else float (FMA). Returns cudaGetLastError() after the launch.
extern "C" int hp_conv1_pool(const void* a, int B, int H, int Q, int64_t sb,
                             int64_t sh, int64_t sq, const void* w,
                             const void* bias, void* out, int bf16,
                             void* stream) {
  if (B < 0 || H < 0 || Q < 0 || H % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || H == 0 || Q == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  if (bf16) {
    int blocks = 0;
    const int64_t units = static_cast<int64_t>(B) * ((Q + 7) / 8) * (H / 2);
    int rc = tc_blocks(units, blocks);
    if (rc == 0) {
      rc = static_cast<int>(cudaFuncSetAttribute(
          conv1_pool_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kTcSmem));
    }
    if (rc != 0) return rc;
    conv1_pool_bf16_kernel<<<blocks, kTcThreads, kTcSmem, s>>>(
        static_cast<const bf16_t*>(a), B, H, Q, sb, sh, sq,
        static_cast<const bf16_t*>(w), bp, static_cast<bf16_t*>(out));
  } else {
    if (B > 65535 || H / 2 > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((Q + kTQ - 1) / kTQ, H / 2, B);
    conv1_pool_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), H, Q, sb, sh, sq,
        static_cast<const float*>(w), bp, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
