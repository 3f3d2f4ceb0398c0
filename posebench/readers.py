"""The arithmetic the per-layer readers share: shares of the chip's peak
and of a kernel's roofline, from the traced slice's summary. Every share is
in percent; a reader that finds nothing to read returns None, and the
harness leaves its metric out of the line."""
from __future__ import annotations

from posebench.reference import counting
from posebench.trace import kernel_calls


def device_idle(s: dict):
    if s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(s: dict, passes: int = 1):
    """The conv operations of the useful frames finished in the slice
    (`passes` 3 for a training step's forward and backward), over the
    slice's wall and the bf16 peak."""
    if not s.get("frames_useful") or s["window_s"] <= 0:
        return None
    ops = passes * s["frames_useful"] * s["conv_ops_per_frame"]
    return 100.0 * ops / (s["window_s"] * counting.H100_BF16_OPS_PER_S)


def roofline(s: dict, kernel: str, bound_s: float):
    """`kernel`'s calls in the slice times its bound, over their device
    time."""
    calls, secs = kernel_calls(s, kernel)
    if not calls or secs <= 0:
        return None
    return 100.0 * calls * bound_s / secs


def conv1_pool_roofline(s: dict):
    h, w = s["input_hw"]
    return roofline(s, "conv1_pool_bf16_kernel", counting.conv1_pool_bound_s(s["batch"], h, w))


def peak_topk_roofline(s: dict):
    h, w = s["input_hw"]
    return roofline(s, "peak_topk_kernel", counting.peak_topk_bound_s(s["batch"], h // 8, w // 8))


def batch_fill(s: dict):
    """Frames finished in the slice over the steps the device ran there, a
    step counted by the decoder's one `peak_topk_kernel` launch."""
    steps, _ = kernel_calls(s, "peak_topk_kernel")
    if not steps:
        return None
    return s["frames_done"] / steps


def host_enqueue_ms(s: dict):
    spans = s.get("host_enqueue_s") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
