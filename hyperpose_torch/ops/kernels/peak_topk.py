"""Peak front end of the PAF decoder: two CUDA kernels, their wrappers and
their plain PyTorch versions.

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
results go back. A plane too large for shared memory (above about 16,500
pixels, such as the evaluator's 120x160 maps) is kept in a device scratch
buffer that the wrapper allocates, by a second instantiation of the same
kernel, with the survivor lists there too above about 115,000 pixels; the
launch picks the path from the bytes a plane needs (`scratch_plan`, asked
of the library once a size). Its time is one block's chain of dependent
steps. The K
argmax rounds are written out in a fixed number of steps whatever K is: the
survivors of the tie-break never touch, their values lie above `_NEG` (the
threshold does) and every other pixel holds `_NEG`, so the rounds are the
survivors stably sorted by (value desc, index asc), then fillers at `_NEG`
(`select_peaks` states the rule). The kernel ranks each survivor by
counting those that beat it. The plain version runs the same arithmetic as
~50 small tensor ops.

`peak_candidates` replaces the Pallas TPU kernel `fused_peak_candidates`
(same file), the front end of the decoder's `use_pallas_peaks` mode: the
zero-border smooth, NMS and tie-break alone, returning the ranked and the
smoothed planes. On the card a block takes a band of rows of a few parts
with a halo of r + 2 rows, read as whole pixel rows of the NHWC map, so
the planes spread over several hundred blocks; it is bound by the bytes of
its two output planes.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..image import _gaussian_kernel_1d, smooth_planes
from . import build
from .library import define, tracing

_NEG = -1e30
MAX_K = 128     # csrc/peak_topk.cu kMaxK
MAX_TAPS = 31   # csrc/peak_topk.cu kMaxTaps

_SIG = (
    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_int] + [ctypes.c_void_p] * 5
)
_SCRATCH_SIG = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int)]
_CAND_SIG = (
    [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float]
    + [ctypes.c_void_p] * 3
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


def _smooth_nms(x: torch.Tensor, taps, thresh: float, zero: bool):
    """[B, P, H, W] float32 planes -> (smoothed, is_peak): the smooth, the
    3x3 same-max NMS with the threshold, and the plateau tie-break, which
    keeps the candidate with the largest pixel index in its 3x3 window
    (pixel indices are exact in float32)."""
    h, w = x.shape[-2:]
    sm = smooth_planes(x, taps, "zero" if zero else "reflect")
    if zero:
        pooled = F.max_pool2d(F.pad(sm, (1, 1, 1, 1)), 3, 1)
    else:
        pooled = F.max_pool2d(sm, 3, 1, padding=1)          # pads -inf
    is_peak = (sm >= pooled) & (sm > thresh)
    pix = torch.arange(h * w, device=x.device, dtype=torch.float32).view(h, w)
    cand = torch.where(is_peak, pix, -1.0)
    return sm, is_peak & (pix == F.max_pool2d(cand, 3, 1, padding=1))


def select_peaks(
    ranked: torch.Tensor, smoothed: torch.Tensor, raw: torch.Tensor,
    h: int, w: int, k: int, taken: float, zero: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K of ranked planes [B, P, H*W] by K argmax rounds (ties to the
    lowest index; a chosen pixel is set to `taken`), then the quadratic
    sub-pixel fit on `smoothed` and the gather of `raw` (both [B, P, H*W]).
    zero=True reads neighbours outside the plane as 0, else at the clipped
    flat index. Returns (xy [B, P, K, 2], raw [B, P, K], sval [B, P, K]).

    Where every pixel holds either `_NEG` or a value above it (n of them),
    the rounds equal the first K of those n pixels stably sorted by (value
    desc, index asc), then K - n fillers of value `_NEG`: pixel 0 each time
    when taken == _NEG (a taken pixel falls back to `_NEG`, and pixel 0 is
    the lowest index at `_NEG`), else (taken below `_NEG`) the `_NEG`
    pixels in index order. The CUDA kernel writes that rule out
    (tests/test_torch_peak_select.py holds the two equal)."""
    hw = h * w
    iota = torch.arange(hw, device=ranked.device)
    cur, vals, idxs = ranked, [], []
    for _ in range(k):
        v, i = cur.max(dim=-1)                 # ties: the lowest index
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], taken, cur)
    sval = torch.stack(vals, dim=-1)
    top = torch.stack(idxs, dim=-1)            # [B, P, K] int64
    ys, xs = top // w, top % w

    def g(flat, idx):
        return flat.gather(-1, idx.clamp(0, hw - 1))

    f0 = g(smoothed, top)
    fxp, fxm = g(smoothed, top + 1), g(smoothed, top - 1)
    fyp, fym = g(smoothed, top + w), g(smoothed, top - w)
    if zero:
        fxp = torch.where(xs + 1 < w, fxp, 0.0)
        fxm = torch.where(xs >= 1, fxm, 0.0)
        fyp = torch.where(ys + 1 < h, fyp, 0.0)
        fym = torch.where(ys >= 1, fym, 0.0)
    xy = torch.stack([
        xs.to(torch.float32) + _subpix(fxp, fxm, f0),
        ys.to(torch.float32) + _subpix(fyp, fym, f0),
    ], dim=-1)
    return xy, g(raw, top), sval


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
    x = conf.permute(0, 3, 1, 2).to(torch.float32)          # [B, P, H, W]
    sm, is_peak = _smooth_nms(x, taps, thresh, zero)
    cur = torch.where(is_peak, sm, _NEG).reshape(b, p, h * w)
    return select_peaks(cur, sm.reshape(b, p, h * w), x.reshape(b, p, h * w),
                        h, w, k, _NEG if zero else 2.0 * _NEG, zero)


def peak_topk(
    conf: torch.Tensor, k: int = 16, ksize: int = 5, sigma: float = 0.75,
    thresh: float = 0.05, border: str = "reflect",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`peak_topk_plain`'s contract for thresh > _NEG, which the kernel's
    selection relies on (on either device a lower threshold raises). CPU
    tensors take the plain version; CUDA tensors launch the kernel, which
    raises if it cannot run. `conf` may be a strided view (the decoder
    passes conf[..., :P]). Traced, the operator `hyperpose::peak_topk`
    (`library.py`)."""
    if tracing():
        return _peak_topk_op(conf, k, ksize, float(sigma), float(thresh), border)
    return _peak_topk(conf, k, ksize, sigma, thresh, border)


def _peak_topk(conf, k, ksize, sigma, thresh, border):
    """The wrapper's body: the plain version or the launch."""
    if not thresh > _NEG:
        raise ValueError(f"peak_topk: thresh={thresh} must exceed {_NEG}")
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
        n_scratch = b * p * scratch_plan(dev.index, h, w)[0]
        scratch = (torch.empty(n_scratch, dtype=torch.float32, device=dev)
                   if n_scratch else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            conf.data_ptr(), b, h, w, p, *conf.stride(),
            ctypes.addressof(taps_c), len(taps), float(thresh), k, int(zero),
            xy.data_ptr(), raw.data_ptr(), sval.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"peak_topk kernel failed: CUDA error {rc}")
    peak_topk.launches += 1
    return xy, raw, sval


peak_topk.launches = 0  # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def scratch_plan(device: int, h: int, w: int) -> tuple[int, bool]:
    """(float32 elements of device scratch, survivor lists there too) that
    the kernel needs for each h x w plane on CUDA device `device`: (0,
    False) where a plane fits shared memory; the lists go to the scratch
    above about 115,000 pixels. Asked of the library once a (device, h,
    w)."""
    fn = build.load("peak_topk").hp_peak_topk_scratch
    fn.argtypes = _SCRATCH_SIG
    fn.restype = ctypes.c_int
    n, lists = ctypes.c_int64(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(h, w, ctypes.byref(n), ctypes.byref(lists))
    if rc != 0:
        raise RuntimeError(f"peak_topk: sizing its scratch failed: CUDA error {rc}")
    return int(n.value), bool(lists.value)


def _peak_topk_fake(conf, k, *args):
    b, _, _, p = conf.shape
    return (conf.new_empty((b, p, k, 2), dtype=torch.float32),
            conf.new_empty((b, p, k), dtype=torch.float32),
            conf.new_empty((b, p, k), dtype=torch.float32))


_peak_topk_op = define(
    "peak_topk", "(Tensor conf, int k, int ksize, float sigma, float thresh, str border) "
    "-> (Tensor, Tensor, Tensor)",
    lambda *args: tuple(t.contiguous() for t in _peak_topk(*args)), _peak_topk_fake)


def peak_candidates_plain(
    conf: torch.Tensor, ksize: int = 5, sigma: float = 0.75,
    thresh: float = 0.05, neg: float = _NEG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """conf [B, H, W, P] float32 -> (ranked [B, P, H, W], smoothed
    [B, P, H, W]): the zero-border smooth, and the smoothed value at the
    pixels that survive NMS, threshold and tie-break, `neg` elsewhere
    (`fused_peak_candidates`' semantics)."""
    x = conf.permute(0, 3, 1, 2).to(torch.float32)
    sm, is_peak = _smooth_nms(x, _taps(ksize, sigma), thresh, zero=True)
    return torch.where(is_peak, sm, neg), sm


def peak_candidates(
    conf: torch.Tensor, ksize: int = 5, sigma: float = 0.75,
    thresh: float = 0.05, neg: float = _NEG,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`peak_candidates_plain`'s contract. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which raises if it cannot run.
    `conf` may be a strided view (the decoder passes conf[..., :P]). On the
    card a map too wide for a band of 4 of its rows to fit a block's shared
    memory (W above about 3,600) raises. Traced, the operator
    `hyperpose::peak_candidates` (`library.py`)."""
    if tracing():
        return _peak_candidates_op(conf, ksize, float(sigma), float(thresh), float(neg))
    return _peak_candidates(conf, ksize, sigma, thresh, neg)


def _peak_candidates(conf, ksize, sigma, thresh, neg):
    """The wrapper's body: the plain version or the launch."""
    if conf.device.type == "cpu":
        return peak_candidates_plain(conf, ksize, sigma, thresh, neg)
    if conf.device.type != "cuda":
        raise ValueError(f"peak_candidates: unsupported device {conf.device}")
    taps = _taps(ksize, sigma)
    if conf.ndim != 4 or conf.dtype != torch.float32:
        raise TypeError(
            f"peak_candidates: conf must be float32 [B,H,W,P], got "
            f"{conf.dtype} {tuple(conf.shape)}"
        )
    b, h, w, p = conf.shape
    ranked = torch.empty((b, p, h, w), dtype=torch.float32, device=conf.device)
    smoothed = torch.empty_like(ranked)
    taps_c = (ctypes.c_float * len(taps))(*taps)
    lib = build.load("peak_topk")
    fn = lib.hp_peak_candidates
    fn.argtypes = _CAND_SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(conf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            conf.data_ptr(), b, h, w, p, *conf.stride(),
            ctypes.addressof(taps_c), len(taps), float(thresh), float(neg),
            ranked.data_ptr(), smoothed.data_ptr(), stream,
        )
    if rc == 1:  # cudaErrorInvalidValue
        raise ValueError(
            f"peak_candidates: conf {tuple(conf.shape)} with ksize {ksize}: no "
            f"band of its rows fits a block's shared memory")
    if rc != 0:
        raise RuntimeError(f"peak_candidates kernel failed: CUDA error {rc}")
    peak_candidates.launches += 1
    return ranked, smoothed


peak_candidates.launches = 0  # kernel launches since the count was last set to 0


def _peak_candidates_fake(conf, *args):
    b, h, w, p = conf.shape
    return (conf.new_empty((b, p, h, w), dtype=torch.float32),
            conf.new_empty((b, p, h, w), dtype=torch.float32))


_peak_candidates_op = define(
    "peak_candidates", "(Tensor conf, int ksize, float sigma, float thresh, float neg) "
    "-> (Tensor, Tensor)",
    lambda *args: tuple(t.contiguous() for t in _peak_candidates(*args)),
    _peak_candidates_fake)
