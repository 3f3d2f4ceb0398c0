"""Image ops shared by the decoder and the engine, in PyTorch and numpy.

Counterpart of `hyperpose_tpu/ops/image.py` (reference:
src/post_process.hpp:56-102 smooth/same_max_pool_3x3, src/data.cpp:53-69
non_scaling_resize). The device ops take NHWC tensors like their JAX
counterparts. The host ops are numpy only: the serving path needs no OpenCV.
`resize_nhwc` is `jax.image.resize` on NHWC tensors (nearest, bilinear,
cubic); `jax_resize_cubic`, its cubic, is the evaluator's map
upsample, as in the JAX evaluator.
"""
from __future__ import annotations

import contextlib
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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, on |distance| (torch's
    bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - x)


# jax.image.resize's kernels by method name
_KERNELS = {"bilinear": _triangle, "cubic": _keys_cubic}


def resize_weights(n_in: int, n_out: int, kernel=_keys_cubic) -> np.ndarray:
    """[n_in, n_out] float64 weights of one axis of `jax.image.resize`
    with `kernel` (`jax.image.scale_and_translate`'s weight matrix,
    antialias on): half-pixel centres; when downsampling the kernel is
    widened by n_in / n_out (the antialiasing that `F.interpolate` lacks);
    taps outside the input are dropped and each column is divided by the
    sum of the rest (torch clamps at the edge instead)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = kernel(dist / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """`resize_weights` of `jax.image.resize(..., "cubic")`."""
    return resize_weights(n_in, n_out, _keys_cubic)


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, method: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    w = resize_weights(n_in, n_out, _KERNELS[method]).astype(np.float32)
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Input index of each output index of `jax.image.resize(...,
    "nearest")`: floor((i + 0.5) * n_in / n_out) in float32, as JAX
    computes it."""
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(f / np.float32(n_out)).astype(np.int64)


@contextlib.contextmanager
def no_tf32():
    """Float32 convs and matmuls in float32 inside the block (TF32 off for
    cuDNN and cuBLAS, PyTorch's cuDNN default being TF32), the flags as
    they were after it."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def resize_nhwc(x: torch.Tensor, out_hw: tuple[int, int],
                method: str = "bilinear") -> torch.Tensor:
    """[B, H, W, C] resized to [B, *out_hw, C] as `jax.image.resize(x, (B,
    *out_hw, C), method)` resizes it (the counterpart of
    `hyperpose_tpu/ops/image.py` `resize_nhwc`), on the device of `x`.
    "nearest" reads input floor((i + 0.5) * in / out) (`nearest_indices`);
    "bilinear" (the default) and "cubic" are a contraction of each axis
    with its `resize_weights` matrix in x's dtype,
    H first, then W, with TF32 off. These antialias on downscale, as JAX's
    default `antialias=True` does, which `F.interpolate` does not. An axis
    whose size does not change is left alone, as JAX leaves it."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if method == "nearest":
        if oh != h:
            x = x[:, torch.from_numpy(nearest_indices(h, oh)).to(x.device)]
        if ow != w:
            x = x[:, :, torch.from_numpy(nearest_indices(w, ow)).to(x.device)]
        return x
    if method not in _KERNELS:
        raise ValueError(f"resize_nhwc: unknown method {method!r}; one of "
                         f"{['nearest', *_KERNELS]}")
    with no_tf32():
        if oh != h:
            x = torch.einsum("bhwc,hy->bywc", x,
                             _resize_matrix(h, oh, method, x.dtype, x.device))
        if ow != w:
            x = torch.einsum("bywc,wx->byxc", x,
                             _resize_matrix(w, ow, method, x.dtype, x.device))
    return x


def jax_resize_cubic(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] float32 resized to [B, *out_hw, C] as
    `jax.image.resize(x, (B, *out_hw, C), "cubic")` resizes it (not
    `F.interpolate(mode="bicubic")`: see `resize_weights`): `resize_nhwc`
    with "cubic"."""
    return resize_nhwc(x, out_hw, "cubic")


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
