"""PAF line-integral sample gather: the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the Pallas TPU kernel `hyperpose_tpu/ops/pallas/line_gather.py`
`fused_line_gather`. The decoder samples the part-affinity field at
K*K*S points per limb (reference: src/paf.cpp:66-137). On the TPU the lookup
was a one-hot MXU contraction in VMEM, because the TPU has no fast scattered
gather. The card has one, so `csrc/line_gather.cu` does direct indexed loads,
one thread per sample. It is bound by bytes (indices in, values out, the
field read once) and does no arithmetic beyond the optional bf16 rounding;
see the source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SIG = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 5
    + [ctypes.c_int, ctypes.c_void_p]
)


def line_gather_plain(
    paf_planes: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
    bf16: bool = True,
) -> torch.Tensor:
    """vals [B, L, 2, M] float32: vals[b,l,c,m] = paf_planes[b,l,c,ly,lx].

    bf16=True rounds the values to bfloat16 (round to nearest even) first.
    Indices outside the plane give 0, as the one-hot contraction does."""
    b, l, _, h, w = paf_planes.shape
    planes = paf_planes.to(torch.float32)
    if bf16:
        planes = planes.to(torch.bfloat16).to(torch.float32)
    ly = ly.long()
    lx = lx.long()
    inside = (ly >= 0) & (ly < h) & (lx >= 0) & (lx < w)
    flat = (ly.clamp(0, h - 1) * w + lx.clamp(0, w - 1))[:, :, None, :]
    vals = torch.gather(
        planes.reshape(b, l, 2, h * w), 3, flat.expand(b, l, 2, -1)
    )
    return torch.where(inside[:, :, None, :], vals, 0.0)


def line_gather(
    paf_planes: torch.Tensor, ly: torch.Tensor, lx: torch.Tensor,
    bf16: bool = True,
) -> torch.Tensor:
    """`fused_line_gather`'s contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot run."""
    if paf_planes.device.type == "cpu":
        return line_gather_plain(paf_planes, ly, lx, bf16)
    if paf_planes.device.type != "cuda":
        raise ValueError(f"line_gather: unsupported device {paf_planes.device}")
    b, l, c, h, w = paf_planes.shape
    m = ly.shape[-1]
    if c != 2 or ly.shape != (b, l, m) or lx.shape != (b, l, m):
        raise ValueError(
            f"line_gather: planes {tuple(paf_planes.shape)}, "
            f"ly {tuple(ly.shape)}, lx {tuple(lx.shape)}"
        )
    if paf_planes.dtype != torch.float32:
        raise TypeError(f"line_gather: planes must be float32, not {paf_planes.dtype}")
    if ly.dtype != torch.int32 or lx.dtype != torch.int32:
        raise TypeError("line_gather: ly and lx must be int32")
    if ly.device != paf_planes.device or lx.device != paf_planes.device:
        raise ValueError("line_gather: inputs on different devices")
    ly = ly.contiguous()
    lx = lx.contiguous()
    out = torch.empty((b, l, 2, m), dtype=torch.float32, device=paf_planes.device)
    lib = build.load("line_gather")
    fn = lib.hp_line_gather
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(paf_planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            paf_planes.data_ptr(), ly.data_ptr(), lx.data_ptr(), out.data_ptr(),
            b, l, h, w, m, *paf_planes.stride(), int(bf16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"line_gather kernel failed: CUDA error {rc}")
    line_gather.launches += 1
    return out


line_gather.launches = 0  # kernel launches since the count was last set to 0
