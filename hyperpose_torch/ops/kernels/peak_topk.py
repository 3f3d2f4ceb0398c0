"""Peak front end of the PAF decoder: the CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces the Pallas TPU kernel `hyperpose_tpu/ops/pallas/peak_kernel.py`
`fused_peak_topk`: per image and part, a separable Gaussian smooth, 3x3
same-max NMS with a threshold, the plateau tie-break, K argmax rounds (ties
to the lowest pixel index), the quadratic sub-pixel fit and the raw-score
gather (reference: src/post_process.hpp:56-187, src/cudnn_kernel_pool.hpp).

`border` picks the semantics:
  * "reflect" reproduces the decoder's production front end
    (`hyperpose_tpu/ops/paf_decode.py` find_peaks): reflect-101 smooth, -inf
    padded max pool, taken pixels masked with 2*_NEG, and the sub-pixel
    neighbours read at the clipped flat index (at x = W-1 the "x+1"
    neighbour is x = 0 of the next row);
  * "zero" reproduces the Pallas kernel, whose shifted maps are zero-filled
    and which masks taken pixels with _NEG.

On the card (`csrc/peak_topk.cu`) one block owns one (image, part) plane and
keeps the plane, its smoothed copy and a scratch plane in shared memory
(30 KB at 46x54), so the map is read from device memory once and only the K
results go back. It is bound by those bytes; the K block-wide argmax scans
run out of shared memory. The plain version runs the same arithmetic as ~50
small tensor ops.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..image import _gaussian_kernel_1d, smooth_planes
from . import build

_NEG = -1e30
MAX_K = 128     # csrc/peak_topk.cu kMaxK
MAX_TAPS = 31   # csrc/peak_topk.cu kMaxTaps

_SIG = (
    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_int] + [ctypes.c_void_p] * 4
)


def _taps(ksize: int, sigma: float):
    if ksize < 1 or ksize % 2 == 0 or ksize > MAX_TAPS:
        raise ValueError(f"peak_topk: ksize must be odd and <= {MAX_TAPS}, got {ksize}")
    return [float(t) for t in _gaussian_kernel_1d(ksize, sigma)]


def _is_zero(border: str) -> bool:
    if border not in ("reflect", "zero"):
        raise ValueError(f"peak_topk: border must be 'reflect' or 'zero', got {border!r}")
    return border == "zero"


def _subpix(fp, fm, f0):
    denom = fp - 2.0 * f0 + fm
    off = torch.where(denom.abs() > 1e-9, 0.5 * (fm - fp) / denom, 0.0)
    return off.clamp(-0.5, 0.5)


def peak_topk_plain(
    conf: torch.Tensor, k: int = 16, ksize: int = 5, sigma: float = 0.75,
    thresh: float = 0.05, border: str = "reflect",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """conf [B, H, W, P] float32 -> (xy [B, P, K, 2] sub-pixel (x, y),
    raw [B, P, K] unsmoothed score, sval [B, P, K] smoothed score). A slot
    holds a real peak iff sval > _NEG / 2."""
    zero = _is_zero(border)
    taps = _taps(ksize, sigma)
    b, h, w, p = conf.shape
    hw = h * w
    x = conf.permute(0, 3, 1, 2).to(torch.float32)          # [B, P, H, W]
    sm = smooth_planes(x, taps, border)
    if zero:
        pooled = F.max_pool2d(F.pad(sm, (1, 1, 1, 1)), 3, 1)
    else:
        pooled = F.max_pool2d(sm, 3, 1, padding=1)          # pads -inf
    is_peak = (sm >= pooled) & (sm > thresh)
    # Plateau tie-break: keep the candidate with the largest pixel index in
    # its 3x3 window (pixel indices are exact in float32).
    pix = torch.arange(hw, device=conf.device, dtype=torch.float32).view(h, w)
    cand = torch.where(is_peak, pix, -1.0)
    is_peak = is_peak & (pix == F.max_pool2d(cand, 3, 1, padding=1))
    cur = torch.where(is_peak, sm, _NEG).reshape(b, p, hw)

    taken = _NEG if zero else 2.0 * _NEG
    iota = torch.arange(hw, device=conf.device)
    vals, idxs = [], []
    for _ in range(k):
        v, i = cur.max(dim=-1)                 # ties: the lowest index
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], taken, cur)
    sval = torch.stack(vals, dim=-1)
    top = torch.stack(idxs, dim=-1)            # [B, P, K] int64
    ys, xs = top // w, top % w

    smf = sm.reshape(b, p, hw)

    def g(flat, idx):
        return flat.gather(-1, idx.clamp(0, hw - 1))

    f0 = g(smf, top)
    fxp, fxm = g(smf, top + 1), g(smf, top - 1)
    fyp, fym = g(smf, top + w), g(smf, top - w)
    if zero:
        fxp = torch.where(xs + 1 < w, fxp, 0.0)
        fxm = torch.where(xs >= 1, fxm, 0.0)
        fyp = torch.where(ys + 1 < h, fyp, 0.0)
        fym = torch.where(ys >= 1, fym, 0.0)
    xy = torch.stack([
        xs.to(torch.float32) + _subpix(fxp, fxm, f0),
        ys.to(torch.float32) + _subpix(fyp, fym, f0),
    ], dim=-1)
    raw = g(x.reshape(b, p, hw), top)
    return xy, raw, sval


def peak_topk(
    conf: torch.Tensor, k: int = 16, ksize: int = 5, sigma: float = 0.75,
    thresh: float = 0.05, border: str = "reflect",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`peak_topk_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot run. `conf`
    may be a strided view (the decoder passes conf[..., :P])."""
    if conf.device.type == "cpu":
        return peak_topk_plain(conf, k, ksize, sigma, thresh, border)
    if conf.device.type != "cuda":
        raise ValueError(f"peak_topk: unsupported device {conf.device}")
    zero = _is_zero(border)
    taps = _taps(ksize, sigma)
    if conf.ndim != 4 or conf.dtype != torch.float32:
        raise TypeError(
            f"peak_topk: conf must be float32 [B,H,W,P], got {conf.dtype} "
            f"{tuple(conf.shape)}"
        )
    b, h, w, p = conf.shape
    if not 1 <= k <= min(MAX_K, h * w):
        raise ValueError(f"peak_topk: k={k} outside [1, min({MAX_K}, H*W)]")
    dev = conf.device
    xy = torch.empty((b, p, k, 2), dtype=torch.float32, device=dev)
    raw = torch.empty((b, p, k), dtype=torch.float32, device=dev)
    sval = torch.empty((b, p, k), dtype=torch.float32, device=dev)
    taps_c = (ctypes.c_float * len(taps))(*taps)
    lib = build.load("peak_topk")
    fn = lib.hp_peak_topk
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            conf.data_ptr(), b, h, w, p, *conf.stride(),
            ctypes.addressof(taps_c), len(taps), float(thresh), k, int(zero),
            xy.data_ptr(), raw.data_ptr(), sval.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"peak_topk kernel failed: CUDA error {rc}")
    peak_topk.launches += 1
    return xy, raw, sval


peak_topk.launches = 0  # kernel launches since the count was last set to 0
