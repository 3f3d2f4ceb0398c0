"""The int8 convolutions and the TPU int8 probe's GEMM: wrappers of
`csrc/int8_gemm.cu` and `csrc/int8_dwconv.cu` and their plain PyTorch
versions.

Replaces the Pallas TPU kernel `scripts/probe_int8_pallas.py` `make_matmul`
(a tiled matmul in s8 -> s32 and bf16 -> f32), which on the TPU stands for
the GEMM that XLA's int8 conv runs. On the card a dense int8 conv is two
launches, a depthwise one a single launch:

- `int8_quantize`: NCHW x (any strides, f32 or bf16) -> int8 NHWC
  [B, H, W, Cp] with Cp >= C a multiple of 32 (`padded_channels`), channels
  >= C zero, and no spatial padding:
  q = clamp(round_half_even(float32(x) * inv_s), +-127).
- `int8_conv`: an implicit-GEMM conv on `wgmma`, A fed by TMA's im2col mode
  straight from that buffer (the hardware fills the zero border), B the
  weights [Np, kh, kw, Cp] int8, the dequantize (s32 -> f32, * dq, + bias)
  and the cast fused into its epilogue; it writes [M, cout] once in the
  activation dtype, rows (b, y, x).
- `int8_dwconv`: the depthwise conv (one filter a channel) from the float
  activation itself: the quantize, the exact sums against taps [kh, kw, Cp]
  int8 and the same epilogue in one kernel, the same output layout; the
  int8 buffer is never written (`csrc/int8_dwconv.cu`). Its plain version is
  the two stages' (`int8_quantize_plain`, then `int8_dwconv_plain`).

`int8_gemm` is the probe's contract on the same mainloop: `a` [M, K] @
`bt` [N, K]^T, raw s32 (s8) or f32 (bf16) sums; K a multiple of 32 for s8
and of 16 for bf16. See the source for the design and the bounds.

Each wrapper takes its plain version for a CPU tensor, launches its kernel
for a CUDA tensor (or raises on what the kernel does not take), and counts
its launches in `.launches`. The three conv wrappers are also the operators
`hyperpose::int8_quantize`, `int8_conv` and `int8_dwconv`, which a traced
step calls (`library.py`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .library import define, tracing

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> (its library, i.e. its source in csrc/, and its argument types)
_SIGS = {
    "hp_int8_gemm": ("int8_gemm", [_P] * 3 + [_I64, _I, _I, _I, _P]),
    "hp_int8_quantize": ("int8_gemm", [_P, _P] + [_I] * 4 + [_I64] * 4 + [_I] * 9
                         + [ctypes.c_float, _I, _P]),
    "hp_int8_conv": ("int8_gemm", [_P] * 5 + [_I] * 15 + [_P]),
    "hp_int8_dwconv": ("int8_dwconv", [_P] * 5 + [_I] * 4 + [_I64] * 4 + [_I] * 9
                       + [ctypes.c_float, _I, _P]),
}
_K_STEP = {torch.int8: 32, torch.bfloat16: 16}
_CHUNK = 1 << 25   # float64 elements of `a` in one chunk of the plain GEMM
_ACT_TYPES = (torch.float32, torch.bfloat16)


def _fn(name: str):
    lib, argtypes = _SIGS[name]
    fn = getattr(build.load(lib), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _run(what: str, name: str, device, *args) -> None:
    with torch.cuda.device(device):
        rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc >= 10000:
        raise RuntimeError(f"{what}: a TMA tensor map failed to encode (CUresult {rc - 10000})")
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc}")


def _on_card(what: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (take the plain version), True for CUDA."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _aligned(*ts) -> bool:
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts)


# -- the GEMM -----------------------------------------------------------------------

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
    if not _on_card("int8_gemm", a):
        return int8_gemm_plain(a, bt)
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
    if not _aligned(a, bt):
        raise ValueError("int8_gemm: a and bt must be contiguous and 16-byte aligned")
    bf16 = a.dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.float32 if bf16 else torch.int32, device=a.device)
    _run("int8_gemm", "hp_int8_gemm", a.device,
         a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, int(bf16))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0  # kernel launches since the count was last set to 0


# -- the quantize pass ----------------------------------------------------------------

def int8_quantize_plain(x: torch.Tensor, inv_s: float, cp: int, fold=None) -> torch.Tensor:
    """NCHW x -> int8 [B, H, W, cp]: float32(x) * inv_s (inv_s a float32
    value), rounded half to even, clipped to +-127 (JAX `_quantized_conv`,
    `quant.py:139-141`); channels >= C are zero.

    With `fold` = (kernel_size, stride, padding, dilation) of a conv, the
    conv's taps are folded into the channels: [B, Ho, Wo, cp] holding, for
    each output pixel, the kh * kw * C quantized values its filter reads in
    (dy, dx, c) order (`int8_im2col_plain`), zero beyond; the conv then runs
    as 1x1 over cp channels."""
    b, c, h, w = x.shape
    if fold is not None:
        a = int8_im2col_plain(int8_quantize_plain(x, inv_s, c), *fold)
        ho, wo = conv_out_hw(h, w, *fold)
        out = torch.zeros((b, ho, wo, cp), dtype=torch.int8, device=x.device)
        out[..., :a.shape[1]] = a.view(b, ho, wo, -1)
        return out
    out = (torch.zeros if cp > c else torch.empty)((b, h, w, cp), dtype=torch.int8,
                                                  device=x.device)
    q = x.to(torch.float32, copy=True).mul_(inv_s).round_().clamp_(-127, 127)
    out[..., :c] = q.permute(0, 2, 3, 1)
    return out


def int8_quantize(x: torch.Tensor, inv_s: float, cp: int, fold=None) -> torch.Tensor:
    """`int8_quantize_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch `hp_int8_quantize`, which reads x through its
    strides (a channels-last view is read in order) in float32 or bfloat16,
    and raises on anything else."""
    if tracing():
        flat = None if fold is None else [int(v) for pair in fold for v in _pair(pair)]
        return _int8_quantize_op(x, float(inv_s), int(cp), flat)
    return _int8_quantize(x, inv_s, cp, fold)


def _int8_quantize(x, inv_s, cp, fold):
    """The wrapper's body: the plain version or the launch."""
    if not _on_card("int8_quantize", x):
        return int8_quantize_plain(x, inv_s, cp, fold)
    if x.ndim != 4:
        raise ValueError(f"int8_quantize: x must be NCHW, got {tuple(x.shape)}")
    if x.dtype not in _ACT_TYPES:
        raise TypeError(f"int8_quantize: x must be float32 or bfloat16, got {x.dtype}")
    b, c, h, w = x.shape
    (kh, kw), stride, padding, dilation = fold or ((1, 1), (1, 1), (0, 0), (1, 1))
    if cp < kh * kw * c or cp % 32:
        raise ValueError(f"int8_quantize: cp={cp} must be a multiple of 32 and >= "
                         f"{kh * kw * c} (kh * kw * C)")
    ho, wo = conv_out_hw(h, w, (kh, kw), stride, padding, dilation)
    out = torch.empty((b, ho, wo, cp), dtype=torch.int8, device=x.device)
    _run("int8_quantize", "hp_int8_quantize", x.device, x.data_ptr(), out.data_ptr(),
         b, c, h, w, *x.stride(), cp, kh, kw, *stride, *padding, *dilation, float(inv_s),
         int(x.dtype == torch.bfloat16))
    int8_quantize.launches += 1
    return out


int8_quantize.launches = 0


def _int8_quantize_fake(x, inv_s, cp, fold):
    b, _, h, w = x.shape
    if fold is not None:
        h, w = conv_out_hw(h, w, *_unflat_fold(fold))
    return x.new_empty((b, h, w, cp), dtype=torch.int8)


_int8_quantize_op = define(
    "int8_quantize", "(Tensor x, float inv_s, int cp, int[]? fold) -> Tensor",
    lambda x, inv_s, cp, fold: _int8_quantize(x, inv_s, cp, _unflat_fold(fold)).contiguous(),
    _int8_quantize_fake)

def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _unflat_fold(fold):
    """[kh, kw, sh, sw, ph, pw, dh, dw] -> the `fold` tuple of pairs."""
    if fold is None:
        return None
    return tuple(tuple(fold[i:i + 2]) for i in range(0, 8, 2))


# -- the conv -------------------------------------------------------------------------

def padded_channels(cin: int) -> int:
    """Cp, the channels of the quantized buffer and of each weight tap:
    a multiple of 128 or 64 where that pads cin by at most 15% more than a
    multiple of 32 does, else a multiple of 32. The conv kernel loads each
    tap in boxes of the widest of 128, 64 and 32 bytes that divides Cp, and
    TMA's time goes by box rows, so wider boxes are worth a few zero
    channels (cin 200 -> 256, 185 -> 192, 3 -> 32)."""
    base = -(-cin // 32) * 32
    for width in (128, 64):
        cp = -(-cin // width) * width
        if 20 * cp <= 23 * base:
            return cp
    return base


def conv_out_hw(h: int, w: int, kernel_size, stride, padding, dilation) -> tuple[int, int]:
    return tuple(
        (n + 2 * p - d * (k - 1) - 1) // s + 1
        for n, k, s, p, d in zip((h, w), kernel_size, stride, padding, dilation))


def int8_im2col_plain(xq: torch.Tensor, kernel_size, stride, padding, dilation
                      ) -> torch.Tensor:
    """The quantized buffer [B, H, W, Cp] -> the conv's A [B*Ho*Wo, kh*kw*Cp]
    int8, columns (dy, dx, c): one copy of a strided view of the buffer
    padded with zeros."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    b, h, w, cp = xq.shape
    ho, wo = conv_out_hw(h, w, kernel_size, stride, padding, dilation)
    xp = F.pad(xq, (0, 0, pw, pw, ph, ph)) if ph or pw else xq
    s = xp.stride()
    windows = xp.as_strided((b, ho, wo, kh, kw, cp),
                            (s[0], sh * s[1], sw * s[2], dh * s[1], dw * s[2], 1))
    return windows.reshape(b * ho * wo, kh * kw * cp)


def int8_conv_sums_plain(xq: torch.Tensor, w: torch.Tensor, stride, padding, dilation
                         ) -> torch.Tensor:
    """The conv's exact s32 sums [B*Ho*Wo, Np]: `int8_im2col_plain` and
    `int8_gemm_plain` against the weights [Np, kh, kw, Cp]."""
    a = int8_im2col_plain(xq, tuple(w.shape[1:3]), stride, padding, dilation)
    return int8_gemm_plain(a, w.reshape(w.shape[0], -1))


def int8_conv_plain(xq, w, dq, bias, stride, padding, dilation, dtype) -> torch.Tensor:
    """[B*Ho*Wo, cout] in `dtype`, cout = len(dq): the s32 sums (of
    `int8_conv_sums_plain`), times dq, plus bias, in float32, then the cast
    (JAX `_quantized_conv`, `quant.py:154-157`)."""
    y = int8_conv_sums_plain(xq, w, stride, padding, dilation)[:, :dq.shape[0]]
    y = y.to(torch.float32).mul_(dq)
    if bias is not None:
        y.add_(bias)
    return y.to(dtype)


def int8_conv(xq: torch.Tensor, w: torch.Tensor, dq: torch.Tensor, bias, stride,
              padding, dilation, dtype: torch.dtype) -> torch.Tensor:
    """`int8_conv_plain`'s contract: xq [B, H, W, Cp] int8 (from
    `int8_quantize`), w [Np, kh, kw, Cp] int8 with Np a multiple of 8, dq
    and bias (or None) float32 [cout], symmetric zero padding. CPU tensors
    take the plain version; CUDA tensors launch `hp_int8_conv`, which takes
    contiguous, 16-byte aligned tensors on one card and raises on anything
    else."""
    if tracing():
        return _int8_conv_op(xq, w, dq, bias, list(_pair(stride)), list(_pair(padding)),
                             list(_pair(dilation)), dtype)
    return _int8_conv(xq, w, dq, bias, stride, padding, dilation, dtype)


def _int8_conv(xq, w, dq, bias, stride, padding, dilation, dtype):
    """The wrapper's body: the plain version or the launch."""
    if not _on_card("int8_conv", xq):
        return int8_conv_plain(xq, w, dq, bias, stride, padding, dilation, dtype)
    if xq.ndim != 4 or w.ndim != 4 or xq.shape[3] != w.shape[3]:
        raise ValueError(f"int8_conv: xq must be [B, H, W, Cp] and w [Np, kh, kw, Cp], "
                         f"got {tuple(xq.shape)} and {tuple(w.shape)}")
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv: xq and w must be int8, got {xq.dtype} and {w.dtype}")
    if dq.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("int8_conv: dq and bias must be float32")
    if dtype not in _ACT_TYPES:
        raise TypeError(f"int8_conv: output dtype must be float32 or bfloat16, got {dtype}")
    others = [w, dq] + ([] if bias is None else [bias])
    if any(t.device != xq.device for t in others):
        raise ValueError("int8_conv: inputs on different devices")
    b, h, wd, cp = xq.shape
    np_, kh, kw = w.shape[:3]
    cout = dq.shape[0]
    if cp % 32 or np_ % 8 or not 0 < cout <= np_ or dq.ndim != 1 \
            or (bias is not None and tuple(bias.shape) != (cout,)):
        raise ValueError(f"int8_conv: Cp={cp} must be a multiple of 32, Np={np_} of 8, "
                         f"and dq / bias [cout <= Np]")
    if not _aligned(xq, *others):
        raise ValueError("int8_conv: inputs must be contiguous and 16-byte aligned")
    ho, wo = conv_out_hw(h, wd, (kh, kw), stride, padding, dilation)
    out = torch.empty((b * ho * wo, cout), dtype=dtype, device=xq.device)
    _run("int8_conv", "hp_int8_conv", xq.device, xq.data_ptr(), w.data_ptr(),
         dq.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
         b, h, wd, cp, np_, kh, kw, *stride, *padding, *dilation, cout,
         int(dtype == torch.bfloat16))
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def _int8_conv_fake(xq, w, dq, bias, stride, padding, dilation, dtype):
    b, h, wd, _ = xq.shape
    ho, wo = conv_out_hw(h, wd, tuple(w.shape[1:3]), stride, padding, dilation)
    return xq.new_empty((b * ho * wo, dq.shape[0]), dtype=dtype)


_int8_conv_op = define(
    "int8_conv", "(Tensor xq, Tensor w, Tensor dq, Tensor? bias, int[] stride, int[] padding, "
    "int[] dilation, ScalarType dtype) -> Tensor",
    lambda xq, w, dq, bias, stride, padding, dilation, dtype: _int8_conv(
        xq, w, dq, bias, tuple(stride), tuple(padding), tuple(dilation), dtype).contiguous(),
    _int8_conv_fake)

# -- the depthwise conv -----------------------------------------------------------------

def dw_channels(c: int) -> int:
    """Cp of a depthwise conv's taps (and of its plain version's quantized
    buffer): c rounded up to a multiple of 32, the kernel's channel slice."""
    return -(-c // 32) * 32


def int8_dwconv_sums_plain(xq: torch.Tensor, w: torch.Tensor, stride, padding, dilation
                           ) -> torch.Tensor:
    """The depthwise conv's exact s32 sums [B*Ho*Wo, Cp]: xq [B, H, W, Cp]
    int8 zero-padded, then for each tap (dy, dx) the strided view of the
    input it reads times w[dy, dx] (w [kh, kw, Cp] int8), summed in int32."""
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    b, h, wd, cp = xq.shape
    kh, kw = w.shape[:2]
    ho, wo = conv_out_hw(h, wd, (kh, kw), stride, padding, dilation)
    xp = F.pad(xq.to(torch.int32), (0, 0, pw, pw, ph, ph))
    w32 = w.to(torch.int32)
    acc = torch.zeros((b, ho, wo, cp), dtype=torch.int32, device=xq.device)
    for dy in range(kh):
        for dx in range(kw):
            y0, x0 = dy * dh, dx * dw
            acc += xp[:, y0:y0 + sh * (ho - 1) + 1:sh, x0:x0 + sw * (wo - 1) + 1:sw] * w32[dy, dx]
    return acc.view(b * ho * wo, cp)


def int8_dwconv_plain(xq, w, dq, bias, stride, padding, dilation, dtype) -> torch.Tensor:
    """[B*Ho*Wo, C] in `dtype`, C = len(dq): the s32 sums (of
    `int8_dwconv_sums_plain`), times dq, plus bias, in float32, then the
    cast (JAX `_quantized_conv` with feature_group_count = C)."""
    y = int8_dwconv_sums_plain(xq, w, stride, padding, dilation)[:, :dq.shape[0]]
    y = y.to(torch.float32).mul_(dq)
    if bias is not None:
        y.add_(bias)
    return y.to(dtype)


def int8_dwconv_fused_plain(x, inv_s, w, dq, bias, stride, padding, dilation
                            ) -> torch.Tensor:
    """`int8_dwconv`'s plain version: NCHW x -> [B*Ho*Wo, C] in x's dtype,
    the two stages in turn, `int8_quantize_plain` into [B, H, W, Cp] and
    `int8_dwconv_plain` (Cp = w.shape[-1])."""
    xq = int8_quantize_plain(x, inv_s, w.shape[-1])
    return int8_dwconv_plain(xq, w, dq, bias, stride, padding, dilation, x.dtype)


def int8_dwconv(x: torch.Tensor, inv_s: float, w: torch.Tensor, dq: torch.Tensor, bias,
                stride, padding, dilation) -> torch.Tensor:
    """`int8_dwconv_fused_plain`'s contract: x NCHW [B, C, H, W] float32 or
    bfloat16, inv_s the float32 value of 1 / s_in, w [kh, kw, Cp] int8
    (Cp a multiple of 32, kh * kw <= 64), dq and bias (or None) float32
    [C], symmetric zero padding. CPU tensors take the plain version; CUDA
    tensors launch `hp_int8_dwconv`, which reads x through its strides (a
    channels-last view is the fast path), and raise on anything it does not
    take: w, dq and bias not contiguous, 16-byte aligned and on x's card, or
    a filter larger than the padded image."""
    if tracing():
        return _int8_dwconv_op(x, float(inv_s), w, dq, bias, list(_pair(stride)),
                               list(_pair(padding)), list(_pair(dilation)))
    return _int8_dwconv(x, inv_s, w, dq, bias, stride, padding, dilation)


def _int8_dwconv(x, inv_s, w, dq, bias, stride, padding, dilation):
    """The wrapper's body: the plain version or the launch."""
    if not _on_card("int8_dwconv", x):
        return int8_dwconv_fused_plain(x, inv_s, w, dq, bias, stride, padding, dilation)
    if x.ndim != 4 or w.ndim != 3:
        raise ValueError(f"int8_dwconv: x must be NCHW and w [kh, kw, Cp], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _ACT_TYPES:
        raise TypeError(f"int8_dwconv: x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != torch.int8:
        raise TypeError(f"int8_dwconv: w must be int8, got {w.dtype}")
    if dq.dtype != torch.float32 or (bias is not None and bias.dtype != torch.float32):
        raise TypeError("int8_dwconv: dq and bias must be float32")
    others = [w, dq] + ([] if bias is None else [bias])
    if any(t.device != x.device for t in others):
        raise ValueError("int8_dwconv: inputs on different devices")
    b, c, h, wd = x.shape
    kh, kw, cp = w.shape
    if cp % 32 or not 0 < c <= cp or tuple(dq.shape) != (c,) or kh * kw > 64 \
            or (bias is not None and tuple(bias.shape) != (c,)):
        raise ValueError(f"int8_dwconv: x's C={c} must equal len(dq) (and bias), C <= Cp={cp}, "
                         f"Cp a multiple of 32, and kh * kw <= 64")
    if not _aligned(*others):
        raise ValueError("int8_dwconv: w, dq and bias must be contiguous and 16-byte aligned")
    ho, wo = conv_out_hw(h, wd, (kh, kw), stride, padding, dilation)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"int8_dwconv: the {kh}x{kw} filter (dilation {dilation}) is larger "
                         f"than the padded {h}x{wd} image")
    out = torch.empty((b * ho * wo, c), dtype=x.dtype, device=x.device)
    _run("int8_dwconv", "hp_int8_dwconv", x.device, x.data_ptr(), w.data_ptr(),
         dq.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
         b, c, h, wd, *x.stride(), cp, kh, kw, *stride, *padding, *dilation, float(inv_s),
         int(x.dtype == torch.bfloat16))
    int8_dwconv.launches += 1
    return out


int8_dwconv.launches = 0


def _int8_dwconv_fake(x, inv_s, w, dq, bias, stride, padding, dilation):
    b, _, h, wd = x.shape
    ho, wo = conv_out_hw(h, wd, tuple(w.shape[:2]), stride, padding, dilation)
    return x.new_empty((b * ho * wo, dq.shape[0]))


_int8_dwconv_op = define(
    "int8_dwconv", "(Tensor x, float inv_s, Tensor w, Tensor dq, Tensor? bias, int[] stride, "
    "int[] padding, int[] dilation) -> Tensor",
    lambda x, inv_s, w, dq, bias, stride, padding, dilation: _int8_dwconv(
        x, inv_s, w, dq, bias, tuple(stride), tuple(padding), tuple(dilation)).contiguous(),
    _int8_dwconv_fake)
