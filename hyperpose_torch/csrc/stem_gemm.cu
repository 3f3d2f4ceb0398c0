// The stem's bf16 GEMM for Hopper (sm_90a): a [M, 384] @ w [384, 128] ->
// [M, 128] bf16, float32 sums rounded once (M = G * M' for a [G, M', 384]
// batch of strips).
//
// Replaces the Pallas TPU probe scripts/probe_mosaic_matmul.py
// pallas_batch_matmul, the batched strip matmul that measured the matrix
// unit's rate for the flagship's block_1 (K = 3 dy x 128 lanes, N = 128 as in
// csrc/conv1_pool.cu, without its masks and pool).
//
// Bound: bytes. At the probe's shape (G = 64 strips of 9936 rows: 635,904
// rows) it reads 488 MB of A and writes 163 MB (651 MB: 0.194 ms at 3.35
// TB/s) for 62.5 GFLOP (0.063 ms at 989 TFLOP/s). So the kernel has to keep
// device memory streaming at full rate in both directions; the tensor cores
// idle two thirds of the time whatever it does.
//
// Design. A persistent grid of one block per SM walks 128-row tiles (block
// b takes tiles b, b + gridDim.x, ...). A block is one producer warp and two
// consumer warpgroups (288 threads):
//   * the weights (96 KB) are loaded once by TMA and stay in shared memory
//     for the block's life, as they arrive: w is [K, N] row-major, so B is
//     MN-major and wgmma reads it with its transpose bit (two 64-column
//     halves, 128-byte swizzle, 8-row groups of K 1024 bytes apart);
//   * one producer thread streams A through a ring of kStages boxes of 128
//     rows x 64 bf16 (128-byte rows, 128-byte swizzle, 16 KB), six per tile;
//     the ring runs on from tile to tile, so the next tile's loads overlap
//     this tile's epilogue, and TMA fills rows past M with zeros;
//   * each consumer warpgroup runs wgmma.m64n128k16 on its 64 rows of the
//     tile (24 k-steps, float32 accumulators, one group in flight), rounds
//     each sum once (__float2bfloat16_rn) into its own 16 KB staging tile in
//     the 128-byte swizzled layout (conflict-free 4-byte st.shared), and
//     issues two TMA stores of 64 rows x 64 columns: every output line is
//     written whole, rows past M are clipped, and the store drains while the
//     next tile multiplies (the staging tile is reused once the store has
//     read it: cp.async.bulk.wait_group.read).
// Shared memory: 96 KB of weights + 80 KB of ring + 32 KB of staging.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kK = 384;                 // depth: 3 dy x 128 lanes
constexpr int kN = 128;                 // output columns
constexpr int kBM = 128;                // rows per tile: two warpgroups of 64
constexpr int kChunks = kK / 64;        // A boxes of 64 bf16 (128 bytes) per tile
constexpr int kStages = 6;              // A ring: one tile ahead
constexpr int kThreads = 288;           // warpgroups 0 and 1 consume, warp 8 produces
constexpr uint32_t kAStage = kBM * 128;           // 16 KB
constexpr uint32_t kWHalf = kK * 128;             // 48 KB: 64 columns of w
constexpr uint32_t kWBytes = 2 * kWHalf;          // 96 KB
constexpr int kWBoxRows = 192;                    // a TMA box has at most 256 rows
constexpr uint32_t kOutBox = 64 * 128;            // 8 KB: 64 rows x 64 columns
constexpr uint32_t kOutWg = 2 * kOutBox;          // 16 KB per warpgroup
constexpr int kSmem = kWBytes + kStages * kAStage + 2 * kOutWg + (2 * kStages + 1) * 8 + 1024;

// wgmma's descriptor of the resident weights at k-step address `addr`: an
// MN-major tile with the 128-byte swizzle, whose 64-column halves lie kWHalf
// bytes apart (LBO) and whose 8-row groups of K lie 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_w(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kWHalf >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int x,
                                             int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every committed store has read its shared memory (it may still be writing).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The 128 threads of warpgroup c (named barrier 1 + c).
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, float lo, float hi) {
  const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 1) stem_gemm_kernel(
    const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
    const __grid_constant__ CUtensorMap tma_out, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t w_smem = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t a_smem = w_smem + kWBytes;
  const uint32_t o_smem = a_smem + kStages * kAStage;
  const uint32_t bars = o_smem + 2 * kOutWg;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t w_bar = bars + 16u * kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);
    }
    mbar_init(w_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer: one thread of warp 8 loads the weights once, then keeps the
    // A ring full. Coordinates are (byte column, row).
    if (threadIdx.x != 256) return;
    mbar_expect_tx(w_bar, kWBytes);
    for (int h = 0; h < 2; ++h) {
      for (int r = 0; r < kK / kWBoxRows; ++r) {
        tma_2d(w_smem + h * kWHalf + r * kWBoxRows * 128, &tma_w, w_bar, 128 * h,
               r * kWBoxRows);
      }
    }
    int ring = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int q = 0; q < kChunks; ++q, ++ring) {
        const int s = ring % kStages;
        mbar_wait(empty(s), ((ring / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kAStage);
        tma_2d(a_smem + s * kAStage, &tma_a, full(s), 128 * q, tile * kBM);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns rows 64c .. 64c + 63 of each tile.
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128, lane = t % 32;
  const uint32_t stage_out = o_smem + c * kOutWg;
  mbar_wait(w_bar, 0);
  __syncwarp();
  int ring = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int q = 0; q < kChunks; ++q, ++ring) {
      const int s = ring % kStages;
      mbar_wait(full(s), (ring / kStages) & 1);
      __syncwarp();  // the spin may leave the warp diverged; wgmma wants it whole
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k-steps of 16 (32 bytes of an A row)
        const uint64_t da = desc_k_major(a_smem + s * kAStage + c * 64 * 128 + 32 * j, 128);
        const uint64_t db = desc_w(w_smem + (4 * q + j) * 16 * 128);
        wgmma_m64n128k16_bf16<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free its slot
      if (q > 0 && t == 0) mbar_arrive(empty((ring - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
    if (t == 0) mbar_arrive(empty((ring - 1) % kStages));

    // Epilogue. Accumulator 4j + 2h + {0, 1}: row 16 * warp + lane / 4 + 8h
    // of the warpgroup's 64, columns 8j + 2 * (lane % 4) + {0, 1}. Column
    // block j goes to staging box j / 8, 16-byte chunk (j % 8) ^ (row % 8).
    if (t == 0) bulk_wait_read();  // the last tile's store has left the staging
    warpgroup_sync(c);
    const int row = 16 * (t / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        const uint32_t addr = stage_out + (j / 8) * kOutBox + r * 128 +
                              ((((j % 8) ^ (r % 8))) << 4) + 4 * (lane % 4);
        st_shared(addr, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
    warpgroup_sync(c);
    if (t == 0) {
      const int y = tile * kBM + 64 * c;
      tma_store_2d(&tma_out, stage_out, 0, y);
      tma_store_2d(&tma_out, stage_out + kOutBox, 128, y);
      bulk_commit();
    }
  }
  if (t == 0) bulk_wait();
}

}  // namespace

// a: contiguous 16-byte aligned bf16 [M, 384] (a [G, M', 384] batch with
// M = G * M'); w: contiguous 16-byte aligned bf16 [384, 128]; out:
// contiguous 16-byte aligned bf16 [M, 128]. Returns cudaGetLastError()
// after the launch, or 10000 + the CUresult of a tensor map that failed to
// encode.
extern "C" int hp_stem_gemm(const void* a, int64_t M, const void* w, void* out,
                            void* stream) {
  if (M < 0 || M > 0x7fffffff - kBM) {  // TMA coordinates are 32-bit
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap map_a, map_w, map_out;
  int rc = encode_2d(&map_a, a, M, kK * 2, 128, kBM);
  if (rc == 0) rc = encode_2d(&map_w, w, kK, kN * 2, 128, kWBoxRows);
  if (rc == 0) rc = encode_2d(&map_out, out, M, kN * 2, 128, 64);
  if (rc != 0) return rc;
  static int sms = 0;  // the process drives one model of card
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(stem_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    }
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int64_t tiles = (M + kBM - 1) / kBM;
  const int blocks = static_cast<int>(std::min<int64_t>(tiles, sms));
  stem_gemm_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_w, map_out, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
