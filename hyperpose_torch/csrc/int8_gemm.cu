// Tiled GEMM on the tensor cores for Hopper (sm_90a), in two types with one
// structure: s8 x s8 -> s32 (the GEMM of every int8 convolution) and
// bf16 x bf16 -> f32.
//
// Replaces the Pallas TPU kernel scripts/probe_int8_pallas.py make_matmul
// (the same contraction in both types, accumulating in s32 / f32). On the
// TPU it is one grid step per 512 x 256 output block with the whole K in
// VMEM; here a block of 8 warps owns a 128 x 128 output tile and walks K in
// 128-byte slices through a three-stage cp.async ring in shared memory.
//
//   C[m, n] = sum_k A[m, k] * Bt[n, k]
//
// A [M, K] and Bt [N, K] are row-major (B is given transposed: the .row.col
// layout mma.sync wants, and int8 has no ldmatrix.trans), C [M, N] is
// contiguous s32 or f32. The M and N tails are masked; K must be a multiple
// of 32 bytes (32 s8 or 16 bf16 values, one k-step of the MMA), rows
// 16-byte aligned.
//
// Both types use the same bytes: one k-step is 32 bytes of a row, and the
// A and B fragments of mma.sync m16n8k32 (s8, IMMA) and m16n8k16 (bf16,
// HMMA) hold the same bytes of the same rows, so one ldmatrix.x4 of 16-bit
// elements fills either.
//
// Bound. At the TPU probe's shape, (4096, 1792) @ (1792, 256): 3.76 G
// operations take 0.0019 ms at 1,979 TOP/s (int8) and 0.0038 ms at 989
// TFLOP/s (bf16); the 11,993,088 B (s8) or 19,791,872 B (bf16) that must
// move take 0.0036 and 0.0059 ms at 3.35 TB/s: bytes bind both. On the
// int8 network the GEMMs have N <= 512 and read an explicit im2col of
// 32 to 3456 bytes a row (3.38 GB for the 40 GEMMs of a flagship step at
// batch 8), so they are bound by bytes too. This kernel is
// the simple one: mma.sync fed by cp.async, no wgmma, no TMA, no fused
// epilogue; each A tile is read once per 128 output columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                       // output rows per block
constexpr int kBN = 128;                       // output columns per block
constexpr int kBK = 128;                       // bytes of K per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;                  // 8 warps: 2 (M) x 4 (N)
constexpr int kTileBytes = kBM * kBK;          // one operand's tile: 16 KB
constexpr int kSmem = kStages * 2 * kTileBytes;  // 96 KB

static_assert(kBM == kBN, "A and B tiles share the loader");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of row r's 16-byte chunk c (of 8) in a tile: XOR-swizzled, so
// the eight rows an ldmatrix phase reads lie in eight different bank groups.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kBK + ((c ^ (r & 7)) << 4));
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

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(int* p, int v0, int v1) {
  *reinterpret_cast<int2*>(p) = make_int2(v0, v1);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Rows r0 .. r0+127 (of `rows`), bytes k0 .. k0+127 (of kb) of a row-major
// operand into a swizzled tile; rows and chunks outside are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const unsigned char* __restrict__ p,
                                          int64_t r0, int64_t rows, int64_t k0,
                                          int64_t kb) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 16 / kThreads; ++i) {
    const int idx = threadIdx.x + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    const int64_t row = r0 + r, k = k0 + 16 * c;
    const bool ok = row < rows && k < kb;
    cp_async16(tile + swz(r, c), ok ? p + row * kb + k : p, ok);
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(
    const unsigned char* __restrict__ a, const unsigned char* __restrict__ bt,
    Acc* __restrict__ c, int64_t M, int N, int64_t kb, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int wm = (warp & 1) * 64;   // this warp's 64 rows and 32 columns
  const int wn = (warp >> 1) * 32;
  // A warp whose rows or columns lie wholly outside C loads but does no MMA.
  const bool live = m0 + wm < M && n0 + wn < N;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  const int64_t k_tiles = (kb + kBK - 1) / kBK;
  auto stage = [&](int64_t kt) {
    const uint32_t s = base + static_cast<uint32_t>(kt % kStages) * 2 * kTileBytes;
    load_tile(s, a, m0, M, kt * kBK, kb);
    load_tile(s + kTileBytes, bt, n0, N, kt * kBK, kb);
  };
  for (int64_t kt = 0; kt < kStages - 1; ++kt) {
    if (kt < k_tiles) stage(kt);
    cp_commit();
  }
  for (int64_t kt = 0; kt < k_tiles; ++kt) {
    cp_wait<kStages - 2>();  // slice kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slice kt-1's slot is free
    if (kt + kStages - 1 < k_tiles) stage(kt + kStages - 1);
    cp_commit();
    if (!live) continue;
    const uint32_t sa = base + static_cast<uint32_t>(kt % kStages) * 2 * kTileBytes;
    const uint32_t sb = sa + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {  // 32 bytes a k-step
      // A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) of a 16-row
      // tile -> a0..a3. B: (n 0-7, bytes 0-15 | 16-31), then n 8-15 ->
      // (b0, b1) of two n-tiles.
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(af[i], sa + swz(wm + 16 * i + (lane & 15),
                                    2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ldmatrix_x4(bf[j], sb + swz(wn + 16 * j + ((lane >> 4) << 3) + (lane & 7),
                                    2 * ks + ((lane >> 3) & 1)));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][j], af[i], bf[j >> 1][2 * (j & 1)], bf[j >> 1][2 * (j & 1) + 1]);
        }
      }
    }
  }
  if (!live) return;

  // Accumulator e of tile (i, j): row g (+8 for e >= 2), column 2*(lane%4)
  // + e%2. With N even a pair of columns is one 8-byte store.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      Acc* row = c + m * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * t4;
        if (n >= N) continue;
        const Acc v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if ((N & 1) == 0) {
          store2(row + n, v0, v1);
        } else {
          row[n] = v0;
          if (n + 1 < N) row[n + 1] = v1;
        }
      }
    }
  }
}

template <typename Acc>
int launch(const void* a, const void* bt, void* c, int64_t M, int N,
           int64_t kb, cudaStream_t s) {
  const int n_tiles = (N + kBN - 1) / kBN;
  const int64_t blocks = (M + kBM - 1) / kBM * n_tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  gemm_kernel<Acc><<<static_cast<unsigned>(blocks), kThreads, kSmem, s>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(bt),
      static_cast<Acc*>(c), M, N, kb, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: [M, K], bt: [N, K], both row-major, contiguous and 16-byte aligned,
// int8 (bf16 == 0) or __nv_bfloat16 (bf16 != 0); c: contiguous [M, N],
// int32 or float. K must be a multiple of 32 (int8) or 16 (bf16). Returns
// cudaGetLastError() after the launch.
extern "C" int hp_int8_gemm(const void* a, const void* bt, void* c, int64_t M,
                            int N, int K, int bf16, void* stream) {
  const int64_t kb = static_cast<int64_t>(K) * (bf16 ? 2 : 1);
  if (M < 0 || N < 0 || K < 0 || kb % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<float>(a, bt, c, M, N, kb, s)
              : launch<int>(a, bt, c, M, N, kb, s);
}
