"""Spans of the port's host path and device work, on the profiler's clock.

Counterpart of `hyperpose_tpu/utils/tracing.py` (reference: src/trace.hpp:3-16;
instrumented sites src/tensorrt.cpp:368-399, src/paf.cpp:302,337).

    with tracing.span("engine/step", device=self.device, frames=b):
        ...

A span records its name, an id, its parent's id (a stack per thread), the
thread, the host start and end, and the counts it was given; with `device`
a CUDA device (or True), also a pair of timing events on the stream current
at its start, resolved only when the spans are read: its device wall, which
includes the bubbles in which the card waited on the span's own launches.

Spans are off by default: a span then costs a check of module state and
records nothing (no event, no profiler range). They are on after
`enable()`, and while a `torch.profiler` session is active in the process
(`torch.autograd.profiler._is_profiler_enabled`), so a profiled slice of a
run records its spans with no change to the caller. They never open a
`record_function` range: with CUDA activity on, PyTorch puts such a range on
the device timeline, where a trace reader would count it as device work.
A span is a no-op while `torch.compile` or `torch.export` traces, and while
the current CUDA stream captures a graph.

Records go into a bounded buffer, grouped by period: a period holds the
spans that started in one profiler session (this module counts the
sessions through the hook `torch.autograd.profiler` calls at each start),
or, outside a session, between two `enable()` calls. A full buffer drops
spans and counts them (`periods()`); `report()` still counts their host
time. Host times are kept on the clock
the profiler stamps its events with (Unix-epoch nanoseconds): the hot path
reads `perf_counter_ns`, and each period keeps one offset to that clock.

`device_profile(logdir)` profiles a block and puts each idle gap of the
device down to the innermost span open on the host at its midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16
OUTSIDE = "(outside spans)"

_enabled = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_size = 0
_sessions = 0                   # profiler sessions started (`_count_sessions`)
_enables = 0                    # enable() calls
_periods: dict[tuple, "_Period"] = {}    # by key, in the order they opened
_period_ids = itertools.count(1)
_totals: dict[str, list[int]] = {}   # name -> [count, total_ns, self_ns]
_event_pool: list = []
_resolve_lock = threading.Lock()


_OFF = contextlib.nullcontext()


def _count_sessions() -> None:
    """Count each profiler session at its start: PyTorch calls the module
    function `_run_on_profiler_start` then, and keeps no id of a session."""
    start = getattr(_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "hyperpose_counts_sessions", False):
        return

    def on_start():
        global _sessions
        _sessions += 1
        start()

    on_start.hyperpose_counts_sessions = True
    _profiler._run_on_profiler_start = on_start


_count_sessions()


def _clock_offset() -> int:
    """Profiler clock minus `perf_counter_ns`, from the tightest of a few
    paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Period:
    __slots__ = ("id", "key", "profiler", "offset_ns", "records", "dropped")

    def __init__(self, key: tuple):
        self.id = next(_period_ids)
        self.key = key
        self.profiler = key[0] == "profiler"
        self.offset_ns = _clock_offset()
        self.records: list[_Span] = []
        self.dropped = 0


def _take_event():
    return _event_pool.pop() if _event_pool else torch.cuda.Event(enable_timing=True)


def _wants_events(device) -> bool:
    if device is True:
        return torch.cuda.is_initialized()
    if not device:
        return False
    return torch.device(device).type == "cuda"


def _inert() -> bool:
    """Whether spans must not record here: while compiling or exporting,
    and while the current CUDA stream captures a graph."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


class _Span:
    __slots__ = ("name", "device", "counts", "id", "parent", "thread", "start_ns", "end_ns",
                 "child_ns", "events", "stream", "period", "kept", "device_ms")

    def __init__(self, name: str, device, counts: dict):
        self.name, self.device, self.counts = name, device, counts
        self.period = None

    def __enter__(self):
        global _size
        if _inert():
            return self
        key = ("profiler", _sessions) if _profiler._is_profiler_enabled else ("enable", _enables)
        with _lock:
            period = _periods.get(key)
            if period is None:
                period = _periods[key] = _Period(key)
            self.kept = _size < CAPACITY
            if self.kept:
                _size += 1
                period.records.append(self)
            else:
                period.dropped += 1
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.period = period
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        self.child_ns = 0
        self.device_ms = None
        self.events = None
        if self.kept and _wants_events(self.device):
            self.stream = torch.cuda.current_stream()
            self.events = (_take_event(), _take_event())
            self.events[0].record(self.stream)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.period is None:
            return False
        end = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        stack = _local.stack
        stack.pop()
        dur = end - self.start_ns
        if stack:
            stack[-1].child_ns += dur
        off = self.period.offset_ns
        self.start_ns += off
        self.end_ns = end + off
        with _lock:
            tot = _totals.get(self.name)
            if tot is None:
                tot = _totals[self.name] = [0, 0, 0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - self.child_ns
        return False

    def device_wall_ms(self):
        """The device wall of the span in ms (waits for its end event), or
        None for a host span."""
        with _resolve_lock:
            if self.events is not None:
                start, end = self.events
                end.synchronize()
                self.device_ms = start.elapsed_time(end)
                _event_pool.extend(self.events)
                self.events = None
        return self.device_ms


def span(name: str, device=False, **counts):
    """A context manager that records a span named `name` while spans are on
    (module docstring). `device`: True, or the device the span's work runs
    on, for a device wall where that is a CUDA device. `counts`: numbers
    (or lists of numbers) kept with the span."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, device, counts)
    return _OFF


def active() -> bool:
    """Whether a span opened now would record (to skip work that only feeds
    a span's counts)."""
    return _enabled or _profiler._is_profiler_enabled


def enable(on: bool = True) -> None:
    """Spans on (or off) outside any profiler session; the spans after it
    outside one go into a new period."""
    global _enabled, _enables
    with _lock:
        _enabled = bool(on)
        _enables += 1


def reset() -> None:
    """Forget every span, period and total."""
    global _size
    with _lock:
        for p in _periods.values():
            for r in p.records:
                if r.events is not None and hasattr(r, "end_ns"):
                    _event_pool.extend(r.events)
                    r.events = None
        _periods.clear()
        _totals.clear()
        _size = 0


def periods() -> list[dict]:
    """The periods in order: {"period", "profiler" (a profiler session, or
    `enable()`), "spans" (kept), "dropped", "names" (of the kept spans)}."""
    with _lock:
        return [{"period": p.id, "profiler": p.profiler, "spans": len(p.records),
                 "dropped": p.dropped, "names": sorted({r.name for r in p.records})}
                for p in _periods.values()]


def _record(r: _Span) -> dict:
    host = (r.end_ns - r.start_ns) / 1e6
    return {"name": r.name, "id": r.id, "parent": r.parent, "thread": r.thread,
            "period": r.period.id, "start_ns": r.start_ns, "end_ns": r.end_ns,
            "host_ms": host, "self_ms": host - r.child_ns / 1e6,
            "device_ms": r.device_wall_ms(), "counts": dict(r.counts)}


def spans(period: int | None = None, name: str | None = None, after_id: int = 0) -> list[dict]:
    """The kept records of closed spans, in the order they ended: of one
    `period` (every period where None), of one `name`, with ids above
    `after_id`. Each: name, id, parent, thread, period, start_ns, end_ns
    (the profiler's clock), host_ms, self_ms (host less the children's),
    device_ms (None for a host span) and counts. Reading resolves the
    device walls, waiting for their events."""
    with _lock:
        chosen = [p for p in _periods.values() if period is None or p.id == period]
        recs = [r for p in chosen for r in p.records
                if hasattr(r, "end_ns") and (name is None or r.name == name) and r.id > after_id]
    recs.sort(key=lambda r: r.end_ns)
    return [_record(r) for r in recs]


def mean_ms(name: str, period: int, what: str = "host"):
    """The mean `what` ("host", "self" or "device") wall in ms of the spans
    named `name` in `period`, or None where there is none to read."""
    vals = [s[f"{what}_ms"] for s in spans(period, name)]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def report() -> dict[str, dict[str, float]]:
    """By span name: total_s, count, mean_ms, self_ms (mean host time less
    the children's) over every span since `reset()`, dropped ones included,
    and for device spans device_ms (the mean device wall of the kept ones)."""
    with _lock:
        totals = {k: list(v) for k, v in _totals.items()}
    device: dict[str, list[float]] = {}
    for s in spans():
        if s["device_ms"] is not None:
            device.setdefault(s["name"], []).append(s["device_ms"])
    out = {}
    for k in sorted(totals):
        n, total, self_ns = totals[k]
        out[k] = {"total_s": total / 1e9, "count": n, "mean_ms": total / 1e6 / max(n, 1),
                  "self_ms": self_ns / 1e6 / max(n, 1)}
        if k in device:
            out[k]["device_ms"] = sum(device[k]) / len(device[k])
    return out


# -- device profile ---------------------------------------------------------------


def idle_by_span(busy: list, spans_: list, t0: int, t1: int) -> dict:
    """Device idle within [t0, t1] (ns), each gap put down to the innermost
    span (the shortest one) open at its midpoint, `OUTSIDE` where none is.
    busy: (start, end) of the device's work; spans_: (start, end, name).
    Returns {"window_s", "busy_s", "idle_s", "by_span": {name: s}}."""
    merged: list[list[int]] = []
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in busy):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    ordered = sorted(spans_)
    starts = [s for s, _, _ in ordered]
    by_span: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        best = None
        for a, b, name in ordered[:bisect.bisect_right(starts, mid)]:
            if b >= mid and (best is None or b - a < best[0]):
                best = (b - a, name)
        key = best[1] if best else OUTSIDE
        by_span[key] = by_span.get(key, 0.0) + (e - s) / 1e9
    busy_s = sum(e - s for s, e in merged) / 1e9
    return {"window_s": (t1 - t0) / 1e9, "busy_s": busy_s, "idle_s": (t1 - t0) / 1e9 - busy_s,
            "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]))}


def _device_intervals(prof) -> list[tuple[int, int]]:
    """(start, end) ns of the kernels, copies and sets on the device in a
    finished profile; user annotations left out."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(ev, "is_user_annotation", lambda: False)():
            continue
        start = int(ev.start_ns())
        out.append((start, start + int(ev.duration_ns())))
    return out


def _add_span_track(path: str, records: list[dict]) -> None:
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = "hyperpose_torch spans"
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}})
    for r in records:
        args = dict(r["counts"], id=r["id"], parent=r["parent"])
        if r["device_ms"] is not None:
            args["device_ms"] = r["device_ms"]
        events.append({"ph": "X", "cat": "span", "name": r["name"], "pid": pid,
                       "tid": r["thread"], "ts": (r["start_ns"] - base) / 1e3,
                       "dur": (r["end_ns"] - r["start_ns"]) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def device_profile(logdir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity where a GPU is present: the device's kernels) and write to
    `logdir`: `trace.json`, a Chrome trace with the block's spans as a track
    of their own, and `idle_by_span.json`, the device's idle seconds within
    the block by the innermost span open at each gap's midpoint
    (`idle_by_span`). The profiler is yielded."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        session = ("profiler", _sessions)
        t0 = time.perf_counter_ns()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    with _lock:
        block = _periods.get(session)
    records = spans(block.id) if block is not None else []
    offset = block.offset_ns if block is not None else _clock_offset()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path, records)
    idle = idle_by_span(_device_intervals(prof) if cuda else [],
                        [(r["start_ns"], r["end_ns"], r["name"]) for r in records],
                        t0 + offset, t1 + offset)
    with open(os.path.join(logdir, "idle_by_span.json"), "w") as f:
        json.dump(idle, f, indent=1)
