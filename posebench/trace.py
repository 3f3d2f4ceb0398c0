"""The traced slice: `torch.profiler` (CPU and CUDA activity) over a steady
part of the window, reduced in memory to what the per-layer readers and the
`breakdown` need. No trace file is written."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


class TracedSlice:
    """Profile from `start()` to `stop()`, then `summary()`. `host` adds the
    host's activity (every operator), which costs the host several
    microseconds a call."""

    def __init__(self, device="cuda", host: bool = True):
        self.cuda = torch.device(device).type == "cuda"
        self.host = host or not self.cuda
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """{"window_s", "busy_s", "kernels": {name: [calls, seconds]},
        "device_ops": top 10 [name, seconds], "idle_gaps": top 10 [what the
        host was doing, seconds of device idle under it]}."""
        device, host = [], []
        for ev in self.prof.profiler.kineto_results.events():
            start, dur = _ns(ev, "start"), _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((start, start + dur, ev.name()))
            else:
                host.append((start, start + dur, ev.name()))
        device.sort()
        host.sort()
        kernels = defaultdict(lambda: [0, 0.0])
        for s, e, name in device:
            kernels[name][0] += 1
            kernels[name][1] += (e - s) * 1e-9
        merged = []
        for s, e, _ in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) * 1e-9
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)
        starts = [h[0] for h in host]
        by_host = defaultdict(float)
        for length, s, e in gaps[:2000]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(-1, i - 400), -1):
                hs, he, name = host[j]
                if he >= mid and (best is None or he - hs < best[0]):
                    best = (he - hs, name)
            by_host[best[1] if best else "(no host op)"] += length * 1e-9
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {
            "window_s": self.t1 - self.t0,
            "busy_s": busy,
            "kernels": dict(kernels),
            "device_ops": [[name, secs] for name, (_, secs) in top],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:10],
        }


def kernel_calls(summary: dict, needle: str) -> tuple[int, float]:
    """(calls, seconds) of the device kernels whose name contains `needle`."""
    calls, secs = 0, 0.0
    for name, (n, s) in summary["kernels"].items():
        if needle in name:
            calls, secs = calls + n, secs + s
    return calls, secs


class WindowTrace:
    """The traced run's two slices of the window: `metrics`, device activity
    alone, so that the host keeps its own pace, from a quarter into the
    window, which the per-layer metrics and the busiest device operations
    are read from; and `host`, host and device activity, from 0.6 into the
    window, which names what the host was doing in each idle gap."""

    def __init__(self, device, seconds: float, length: float):
        length = min(length, 0.2 * seconds)
        self.metrics = TracedSlice(device, host=False)
        self.host = TracedSlice(device, host=True)
        self.plan = [[self.metrics, 0.25 * seconds, length, "idle"],
                     [self.host, 0.6 * seconds, 0.5 * length, "idle"]]
        # The profiler's first start in a process sets up CUPTI, which takes
        # a second or more: do it here, in set-up, not in the window.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                    + ([torch.profiler.ProfilerActivity.CUDA]
                                       if self.metrics.cuda else [])):
            torch.zeros(1, device=device) + 1

    def tick(self, elapsed: float) -> None:
        """Start or stop a slice as `elapsed` seconds of the window pass: each
        runs `length` seconds from its own start."""
        for entry in self.plan:
            sl, start, length, state = entry
            if state == "idle" and elapsed >= start:
                sl.start()
                entry[3] = "on"
            elif state == "on" and time.perf_counter() - sl.t0 >= length:
                sl.stop()
                entry[3] = "done"

    def close(self) -> None:
        for entry in self.plan:
            if entry[3] == "on":
                entry[0].stop()
                entry[3] = "done"

    @property
    def t0(self) -> float:
        return self.metrics.t0

    @property
    def t1(self) -> float:
        return self.metrics.t1

    def summary(self) -> dict:
        s = self.metrics.summary()
        if self.host.prof is not None:
            s["idle_gaps"] = self.host.summary()["idle_gaps"]
        return s
