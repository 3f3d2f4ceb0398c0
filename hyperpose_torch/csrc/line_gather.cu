// PAF line-integral sample gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperpose_tpu/ops/pallas/line_gather.py
// fused_line_gather: vals[b,l,c,m] = planes[b,l,c,ly[b,l,m],lx[b,l,m]].
// The TPU has no fast scattered gather, so it ran the lookup as a one-hot
// MXU contraction in VMEM. The card has one: each thread does the two
// direct loads of one (b, l, m) sample, one per PAF channel, and writes both
// outputs. The planes are addressed through their strides, so the decoder
// passes a permuted view of the NHWC field without copying it.
//
// Bound: bytes. Per sample it reads two int32 indices and writes two floats,
// and it reads the planes once; there is no arithmetic to speak of. Reads of
// the indices and writes of the outputs are coalesced (m is the fastest
// index); the plane loads go through the read-only cache, and the whole field
// (3 MB at the flagship shape) sits in L2.
//
// bf16 != 0 rounds each value to bfloat16 (round to nearest even) and back,
// as `astype(bfloat16)` does. Samples whose indices fall outside the plane
// read 0, as the one-hot contraction does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void line_gather_kernel(
    const float* __restrict__ planes, const int32_t* __restrict__ ly,
    const int32_t* __restrict__ lx, float* __restrict__ out, int L, int H,
    int W, int M, int64_t sb, int64_t sl, int64_t sc, int64_t sh, int64_t sw,
    int bf16, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t m = t % M;
  const int64_t bl = t / M;
  const int64_t l = bl % L;
  const int64_t b = bl / L;
  const int y = ly[t];
  const int x = lx[t];
  float v0 = 0.f, v1 = 0.f;
  if (y >= 0 && y < H && x >= 0 && x < W) {
    const float* p = planes + b * sb + l * sl + y * sh + x * sw;
    v0 = __ldg(p);
    v1 = __ldg(p + sc);
    if (bf16) {
      v0 = __bfloat162float(__float2bfloat16_rn(v0));
      v1 = __bfloat162float(__float2bfloat16_rn(v1));
    }
  }
  float* o = out + bl * 2 * M + m;
  o[0] = v0;
  o[M] = v1;
}

}  // namespace

// planes: float [B, L, 2, H, W] with element strides (sb, sl, sc, sh, sw);
// ly, lx: contiguous int32 [B, L, M]; out: contiguous float [B, L, 2, M].
// Returns cudaGetLastError() after the launch.
extern "C" int hp_line_gather(const void* planes, const void* ly,
                              const void* lx, void* out, int B, int L, int H,
                              int W, int M, int64_t sb, int64_t sl, int64_t sc,
                              int64_t sh, int64_t sw, int bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * L * M;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  line_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const int32_t*>(ly),
      static_cast<const int32_t*>(lx), static_cast<float*>(out), L, H, W, M,
      sb, sl, sc, sh, sw, bf16, total);
  return static_cast<int>(cudaGetLastError());
}
