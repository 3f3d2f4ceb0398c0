"""TinyVGG's fused serving stem: block_1 (BN folded) + bias + ReLU + pool1 in
one CUDA kernel, its wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `hyperpose_tpu/ops/pallas/stem_kernel.py`
`fused_conv1_pool`. Its input `btp` [B, H, Q=W/2, 128] is the pair-packed
x-im2col of block_0's output that `VggTinyFusedStem.conv0p` emits: lane
32*(off+1)+c holds block_0's channel c at x = 2q+off, off in {-1, 0, 1, 2}.
For each output pair q the 3x3 conv over x in 2q-1..2q+2 is, per dy, one
128-deep product with `w1p[dy]` [128, 128] whose output lanes are
[x=2q: 64 channels | x=2q+1: 64 channels]; the 2x2 pool is then the max over
the two 64-lane halves and over each pair of rows. The activation at full
resolution (20.3 MB per frame in bf16) never reaches device memory.

`csrc/conv1_pool.cu` runs bf16 on the tensor cores (mma.sync, one warp per
8 pairs x 2 rows, persistent warps walking down the rows) and float32 on
FMA; see the source for the bounds. Zero lanes 0-31 at q = 0 and 96-127 at
q = Q-1 (conv0p evaluated them outside the image) and the rows -1 and H are
applied as masks on load, not as copies of the input.

`stem_gemm` is the same GEMM without masks or pool, [G, M, 384] @ [384, 128]
-> [G, M, 128] in bf16: the counterpart of the TPU probe
`scripts/probe_mosaic_matmul.py` `pallas_batch_matmul`, on its own kernel
(`csrc/stem_gemm.cu`: `wgmma` fed by TMA, the weights resident in shared
memory, TMA-stored output tiles).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .library import define, tracing

_SIG = (
    [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_int64] * 3
    + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
)


def _masked(btp: torch.Tensor) -> torch.Tensor:
    """btp in float32 with the border lanes that block_1's SAME padding
    reads as zeros set to zero."""
    q = btp.shape[2]
    lanes = torch.arange(128, device=btp.device)
    keep = torch.ones(q, 128, dtype=torch.bool, device=btp.device)
    keep[0] &= lanes >= 32
    keep[q - 1] &= lanes < 96
    return torch.where(keep, btp.to(torch.float32), 0.0)


def conv1_pool_plain(btp: torch.Tensor, w1p: torch.Tensor,
                     b1p: torch.Tensor) -> torch.Tensor:
    """btp [B, H, Q, 128], w1p [3, 128, 128], b1p [128] -> [B, H/2, Q, 64]
    in btp's dtype: three dy products summed in float32, float32 bias, ReLU,
    max over the lane halves and over row pairs (`fused_conv1_pool`'s
    semantics, as `fused_conv1_pool_reference`)."""
    b, h, q, _ = btp.shape
    a = F.pad(_masked(btp), (0, 0, 0, 0, 1, 1))               # rows -1 and H
    w = w1p.to(torch.float32)
    acc = sum(torch.matmul(a[:, dy:dy + h], w[dy]) for dy in range(3))
    y = torch.relu(acc + b1p.to(torch.float32))
    y = torch.maximum(y[..., :64], y[..., 64:])
    y = y.reshape(b, h // 2, 2, q, 64).amax(dim=2)
    return y.to(btp.dtype)


def conv1_pool(btp: torch.Tensor, w1p: torch.Tensor,
               b1p: torch.Tensor) -> torch.Tensor:
    """`conv1_pool_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot run.

    On the card `btp` must have its 128 lanes contiguous (the NCHW conv0p
    output in channels-last memory, permuted to [B, H, Q, 128], is), so the
    kernel reads it through its strides and never through a transposing
    copy; w1p is in btp's dtype, b1p in float32. The result is contiguous
    [B, H/2, Q, 64]. Traced, the operator `hyperpose::conv1_pool`
    (`library.py`)."""
    if tracing():
        return _conv1_pool_op(btp, w1p, b1p)
    return _conv1_pool(btp, w1p, b1p)


def _conv1_pool(btp, w1p, b1p):
    """The wrapper's body: the plain version or the launch."""
    if btp.device.type == "cpu":
        return conv1_pool_plain(btp, w1p, b1p)
    if btp.device.type != "cuda":
        raise ValueError(f"conv1_pool: unsupported device {btp.device}")
    if btp.ndim != 4 or btp.shape[3] != 128 or btp.shape[1] % 2:
        raise ValueError(f"conv1_pool: btp must be [B, even H, Q, 128], got "
                         f"{tuple(btp.shape)}")
    if tuple(w1p.shape) != (3, 128, 128) or tuple(b1p.shape) != (128,):
        raise ValueError(f"conv1_pool: w1p {tuple(w1p.shape)}, b1p {tuple(b1p.shape)}")
    if btp.dtype not in (torch.float32, torch.bfloat16) or w1p.dtype != btp.dtype:
        raise TypeError(f"conv1_pool: btp and w1p must both be float32 or both "
                        f"bfloat16, got {btp.dtype} and {w1p.dtype}")
    if b1p.dtype != torch.float32:
        raise TypeError(f"conv1_pool: b1p must be float32, not {b1p.dtype}")
    if w1p.device != btp.device or b1p.device != btp.device:
        raise ValueError("conv1_pool: inputs on different devices")
    per16 = 16 // btp.element_size()
    if (btp.stride(3) != 1 or any(s % per16 for s in btp.stride()[:3])
            or btp.data_ptr() % 16):
        raise ValueError(
            f"conv1_pool: btp's lanes must be contiguous and 16-byte aligned "
            f"(strides {btp.stride()}); give it the conv0p output in "
            "channels-last memory")
    b, h, q, _ = btp.shape
    w1p, b1p = w1p.contiguous(), b1p.contiguous()
    if w1p.data_ptr() % 16:
        raise ValueError("conv1_pool: w1p must be 16-byte aligned")
    out = torch.empty((b, h // 2, q, 64), dtype=btp.dtype, device=btp.device)
    lib = build.load("conv1_pool")
    fn = lib.hp_conv1_pool
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(btp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            btp.data_ptr(), b, h, q, *btp.stride()[:3],
            w1p.data_ptr(), b1p.data_ptr(), out.data_ptr(),
            int(btp.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv1_pool kernel failed: CUDA error {rc}")
    conv1_pool.launches += 1
    return out


conv1_pool.launches = 0  # kernel launches since the count was last set to 0


def _conv1_pool_fake(btp, w1p, b1p):
    b, h, q, _ = btp.shape
    return btp.new_empty((b, h // 2, q, 64))


_conv1_pool_op = define(
    "conv1_pool", "(Tensor btp, Tensor w1p, Tensor b1p) -> Tensor",
    lambda *args: _conv1_pool(*args).contiguous(), _conv1_pool_fake)

def stem_gemm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [G, M, 384] @ w [384, 128] -> [G, M, 128] in a's dtype: a float32
    product (bf16 products are exact in float32), rounded once."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32)).to(a.dtype)


def stem_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`stem_gemm_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch `hp_stem_gemm` (`csrc/stem_gemm.cu`), which takes
    contiguous, 16-byte aligned bf16 operands and raises on anything
    else."""
    if a.device.type == "cpu":
        return stem_gemm_plain(a, w)
    if a.device.type != "cuda":
        raise ValueError(f"stem_gemm: unsupported device {a.device}")
    if a.ndim != 3 or a.shape[2] != 384 or tuple(w.shape) != (384, 128):
        raise ValueError(f"stem_gemm: a must be [G, M, 384] and w [384, 128], "
                         f"got {tuple(a.shape)} and {tuple(w.shape)}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"stem_gemm: a and w must be bfloat16, got {a.dtype} "
                        f"and {w.dtype}")
    if w.device != a.device:
        raise ValueError("stem_gemm: inputs on different devices")
    if not (a.is_contiguous() and w.is_contiguous()) or a.data_ptr() % 16 \
            or w.data_ptr() % 16:
        raise ValueError("stem_gemm: a and w must be contiguous and 16-byte aligned")
    g, m, _ = a.shape
    out = torch.empty((g, m, 128), dtype=a.dtype, device=a.device)
    lib = build.load("stem_gemm")
    fn = lib.hp_stem_gemm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), g * m, w.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"stem_gemm kernel failed: CUDA error {rc}")
    stem_gemm.launches += 1
    return out


stem_gemm.launches = 0  # kernel launches since the count was last set to 0
