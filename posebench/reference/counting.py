"""The chip's peaks and the least time a kernel's work could take on it
(bytes read and written once at the memory's rate, or the operations at
the peak of their type, whichever is larger): the yardstick of the
roofline shares. The bounds are copied from the port's chip smoke script
(`conv1_pool`, `peak_topk`)."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
H100_BYTES_PER_S = 3.35e12
H100_BF16_OPS_PER_S = 989e12
H100_F32_OPS_PER_S = 67e12


def conv1_pool_bound_s(b: int, h: int, w: int) -> float:
    """The fused stem's block_1 + pool1 on a bf16 batch of `b` images of
    h x w: 2 x b x h x (w/2) x 384 x 128 operations on the tensor cores; its
    input (b, h, w/2, 128) read and its output (b, h/2, w/2, 64) written
    once, 2 bytes each."""
    q = w // 2
    ops = 2 * b * h * q * 384 * 128
    nbytes = 2 * (b * h * q * 128 + b * (h // 2) * q * 64)
    return max(nbytes / H100_BYTES_PER_S, ops / H100_BF16_OPS_PER_S)


def peak_topk_bound_s(b: int, h: int, w: int, parts: int = 18, k: int = 16,
                      ksize: int = 5) -> float:
    """The decoder's peak search on `b` float32 confidence maps of h x w and
    `parts` planes: the planes read once and K slots of (x, y, raw, smoothed)
    written, 4 bytes each; a separable smooth, the 3x3 NMS and plateau
    compares a pixel and the sub-pixel fit a slot in float32 (the compare
    per survivor of the top-K is left out: it depends on the maps, and
    leaving it out only lowers the bound)."""
    r = ksize // 2
    nbytes = 4 * (b * h * w * parts + b * parts * k * 4)
    ops = b * parts * (h * w * (2 * (4 * r + 1) + 16) + 10 * k)
    return max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)
