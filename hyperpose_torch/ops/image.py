"""Image ops shared by the decoder and the engine, in PyTorch and numpy.

Counterpart of `hyperpose_tpu/ops/image.py` (reference:
src/post_process.hpp:56-102 smooth/same_max_pool_3x3, src/data.cpp:53-69
non_scaling_resize). The device ops take NHWC tensors like their JAX
counterparts. The host ops are numpy only: the serving path needs no OpenCV.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    # Matches cv2.getGaussianKernel: symmetric, normalized to sum 1.
    half = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def smooth_planes(x: torch.Tensor, taps, border: str = "reflect") -> torch.Tensor:
    """Separable smooth of [N, C, H, W] planes with the 1-D `taps`.

    border="reflect" is reflect-101 (cv2.GaussianBlur's default, and
    `jnp.pad(mode="reflect")`); "zero" fills outside the plane with 0, as the
    Pallas peak kernel does. Taps are summed centre first, then the pairs at
    distance 1, 2, ...: the CUDA peak kernel adds them in the same order, so
    the two agree bit for bit.
    """
    taps = [float(t) for t in taps]
    r = len(taps) // 2
    h, w = x.shape[-2:]
    mode = {"reflect": "reflect", "zero": "constant"}[border]

    xp = F.pad(x, (0, 0, r, r), mode=mode)
    sm_v = taps[r] * xp[..., r:r + h, :]
    for i in range(1, r + 1):
        sm_v = sm_v + taps[r - i] * xp[..., r - i:r - i + h, :]
        sm_v = sm_v + taps[r + i] * xp[..., r + i:r + i + h, :]
    xp = F.pad(sm_v, (r, r, 0, 0), mode=mode)
    sm = taps[r] * xp[..., r:r + w]
    for i in range(1, r + 1):
        sm = sm + taps[r - i] * xp[..., r - i:r - i + w]
        sm = sm + taps[r + i] * xp[..., r + i:r + i + w]
    return sm


def gaussian_smooth_nhwc(
    x: torch.Tensor, ksize: int = 17, sigma: float = 3.0
) -> torch.Tensor:
    """Depthwise separable Gaussian blur on [B, H, W, C], reflect-101 borders
    (reference: src/post_process.hpp:56-70 `smooth`, sigma=3)."""
    if ksize <= 1:
        return x
    taps = _gaussian_kernel_1d(ksize, sigma)
    return smooth_planes(x.permute(0, 3, 1, 2), taps).permute(0, 2, 3, 1)


def same_max_pool_3x3_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool that pads with -inf (reference:
    src/post_process.hpp:73-102, src/cudnn_kernel_pool.hpp:9-62)."""
    pooled = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=1, padding=1)
    return pooled.permute(0, 2, 3, 1)


def yuv420_to_rgb(yuv_u8: torch.Tensor) -> torch.Tensor:
    """Planar I420 [B, H*3/2, W] uint8 -> RGB float32 [B, H, W, 3] in 0..255.

    Device half of the compressed infeed: video-range BT.601 with nearest
    chroma upsampling, as cv2.COLOR_YUV2RGB_I420.
    """
    b, h15, w = yuv_u8.shape
    h = (h15 * 2) // 3
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even H,W; got {h}x{w}")
    f = yuv_u8.to(torch.float32)
    y = f[:, :h, :]
    u = f[:, h:h + h // 4, :].reshape(b, h // 2, w // 2)
    v = f[:, h + h // 4:, :].reshape(b, h // 2, w // 2)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) - 128.0
    yv = 1.164 * (y - 16.0)
    r = yv + 1.596 * v
    g = yv - 0.813 * v - 0.391 * u
    bch = yv + 2.018 * u
    return torch.stack([r, g, bch], dim=-1).clamp(0.0, 255.0)


# -- host side (numpy) --------------------------------------------------------

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS
_ONE = 1 << _COEF_BITS


def _axis_taps(src: int, dst: int):
    """Source index pair and 11-bit weight for each output position along one
    axis: half-pixel centres, clamped at the edges."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * float(src) / float(dst) - 0.5
    f = np.clip(f, 0.0, float(src - 1))
    i0 = np.minimum(f.astype(np.int64), max(src - 2, 0))
    i1 = np.minimum(i0 + 1, src - 1)
    wt = ((f - i0) * float(_ONE) + 0.5).astype(np.int64)
    return i0, i1, wt


def resize_bilinear(image: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image with half-pixel centres.

    Two separable passes in 11-bit fixed point with one final rounding, the
    arithmetic of the JAX package's native resize
    (`hyperpose_tpu/runtime/native/hp_runtime.cpp` hp_resize_into_batch), so
    both packages feed their networks the same bytes. It agrees with
    cv2.resize(INTER_LINEAR) to within one grey level.
    """
    oh, ow = out_hw
    sh, sw = image.shape[:2]
    x0, x1, wx = _axis_taps(sw, ow)
    y0, y1, wy = _axis_taps(sh, oh)
    img = image.astype(np.int64)
    wx = wx[None, :, None]
    rows = img[:, x0] * (_ONE - wx) + img[:, x1] * wx        # [sh, ow, C]
    wy = wy[:, None, None]
    out = (rows[y0] * (_ONE - wy) + rows[y1] * wy
           + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


def letterbox_resize(
    image: np.ndarray, target_hw: tuple[int, int]
) -> tuple[np.ndarray, float, float]:
    """Aspect-preserving resize onto a black canvas.

    Returns (canvas, ratio_x, ratio_y) where ratio_* is the fraction of the
    canvas covered by content (reference: src/data.cpp:53-69
    non_scaling_resize, include/hyperpose/utility/human.hpp:44-58
    resume_ratio).
    """
    th, tw = target_hw
    h, w = image.shape[:2]
    scale = min(tw / w, th / h)
    nw = min(max(1, int(np.floor(w * scale + 0.5))), tw)
    nh = min(max(1, int(np.floor(h * scale + 0.5))), th)
    canvas = np.zeros((th, tw, image.shape[2]), dtype=image.dtype)
    canvas[:nh, :nw] = resize_bilinear(image, (nh, nw))
    return canvas, nw / tw, nh / th


def rgb_to_yuv420(rgb_u8: np.ndarray) -> np.ndarray:
    """Host RGB [H,W,3] uint8 -> planar I420 [H*3/2, W] uint8: the producer
    half of the compressed infeed (video-range BT.601; chroma sampled at the
    top-left pixel of each 2x2 block)."""
    h, w = rgb_u8.shape[:2]
    f = rgb_u8.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.257 * r + 0.504 * g + 0.098 * b + 16.0
    u = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
    v = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    u2 = u[0::2, 0::2]
    v2 = v[0::2, 0::2]
    out[h:h + h // 4] = np.clip(u2 + 0.5, 0, 255).astype(
        np.uint8).reshape(h // 4, w)
    out[h + h // 4:] = np.clip(v2 + 0.5, 0, 255).astype(
        np.uint8).reshape(h // 4, w)
    return out
