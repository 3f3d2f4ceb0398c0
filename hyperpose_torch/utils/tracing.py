"""Lightweight tracing: named scopes + torch.profiler integration.

Counterpart of `hyperpose_tpu/utils/tracing.py` (reference: src/trace.hpp:3-16;
instrumented sites src/tensorrt.cpp:368-399, src/paf.cpp:302,337). Scopes are
cheap wall-clock accumulators that also open a
`torch.profiler.record_function` range, so they show up in profiler traces;
`device_profile` records a `torch.profiler` trace of a block.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_enabled = False
_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def scope(name: str):
    """Named timing scope; no-op unless tracing is enabled
    (mirrors WITH_TRACE gating, reference: CMakeLists.txt:23-26)."""
    if not _enabled:
        yield
        return
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                _totals[name] += dt
                _counts[name] += 1


def report() -> dict[str, dict[str, float]]:
    with _lock:
        return {
            k: {"total_s": _totals[k], "count": _counts[k],
                "mean_ms": 1000.0 * _totals[k] / max(_counts[k], 1)}
            for k in sorted(_totals)
        }


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()


@contextlib.contextmanager
def device_profile(logdir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where a GPU is present: the device's kernels) and write it to
    `logdir` as a Chrome trace, `trace.json`; the profiler is yielded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
