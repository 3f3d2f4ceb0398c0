"""The GEMM of the int8 convolutions: s8 x s8 -> s32, and the same kernel in
bf16 x bf16 -> f32; its wrapper and its plain PyTorch version.

Replaces the Pallas TPU kernel `scripts/probe_int8_pallas.py` `make_matmul`
(a tiled matmul in both types, accumulating in s32 / f32). On the card it is
`csrc/int8_gemm.cu`: `mma.sync` on the tensor cores (m16n8k32 for s8,
m16n8k16 for bf16) fed by a `cp.async` ring; see the source for the bound.

Contract: `a` [M, K] row-major, `bt` [N, K] row-major (B given transposed,
the layout `mma.sync` reads), result [M, N] contiguous. K is a multiple of
32 for s8 and of 16 for bf16 (callers pad K with zeros, which add nothing).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
_K_STEP = {torch.int8: 32, torch.bfloat16: 16}
_CHUNK = 1 << 25   # float64 elements of `a` in one chunk of the plain version


def int8_gemm_plain(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ bt[N, K]^T. For int8: the float64 product of the integer
    values, cast to int32. It is exact: every product is, and |sum| <=
    K * 127^2 stays far below 2^53 (torch has no integer matmul on CUDA, and
    the CPU's int8 matmul returns int8). Taken in row chunks to bound the
    float64 copy. For bf16: the float32 product of the bf16 values."""
    if a.dtype == torch.bfloat16:
        return torch.matmul(a.to(torch.float32), bt.to(torch.float32).T)
    m, k = a.shape
    b = bt.to(torch.float64).T
    out = torch.empty((m, bt.shape[0]), dtype=torch.int32, device=a.device)
    step = max(1, _CHUNK // max(k, 1))
    for i in range(0, m, step):
        out[i:i + step] = torch.matmul(a[i:i + step].to(torch.float64), b).to(torch.int32)
    return out


def int8_gemm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """`int8_gemm_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch `hp_int8_gemm`, which takes contiguous, 16-byte
    aligned operands of one type (int8 or bfloat16) and raises on anything
    else."""
    if a.device.type == "cpu":
        return int8_gemm_plain(a, bt)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {a.device}")
    if a.ndim != 2 or bt.ndim != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"int8_gemm: a must be [M, K] and bt [N, K], got "
                         f"{tuple(a.shape)} and {tuple(bt.shape)}")
    if a.dtype not in _K_STEP or bt.dtype != a.dtype:
        raise TypeError(f"int8_gemm: a and bt must both be int8 or both "
                        f"bfloat16, got {a.dtype} and {bt.dtype}")
    if bt.device != a.device:
        raise ValueError("int8_gemm: inputs on different devices")
    (m, k), n = a.shape, bt.shape[0]
    if k % _K_STEP[a.dtype]:
        raise ValueError(f"int8_gemm: K={k} is not a multiple of "
                         f"{_K_STEP[a.dtype]} for {a.dtype}; pad it with zeros")
    if not (a.is_contiguous() and bt.is_contiguous()) or a.data_ptr() % 16 \
            or bt.data_ptr() % 16:
        raise ValueError("int8_gemm: a and bt must be contiguous and 16-byte aligned")
    bf16 = a.dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.float32 if bf16 else torch.int32,
                      device=a.device)
    fn = build.load("int8_gemm").hp_int8_gemm
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel failed: CUDA error {rc}")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0  # kernel launches since the count was last set to 0
