"""Training metrics (reference: hyperpose/Model/metrics.py:4-81). A copy of
`hyperpose_tpu/train/metrics.py`."""
from __future__ import annotations

import time
from collections import defaultdict


class AvgMetric:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.total += float(value)
        self.count += 1

    def result(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self):
        self.total, self.count = 0.0, 0


class TimeMetric:
    def __init__(self):
        self.last = time.time()

    def elapsed(self) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        return dt


class MetricManager:
    """Rolling means keyed by name + wall-clock reporting
    (reference: metrics.py:31-81)."""

    def __init__(self):
        self.metrics: dict[str, AvgMetric] = defaultdict(AvgMetric)
        self.timer = TimeMetric()

    def update(self, name: str, value):
        self.metrics[name].update(value)

    def update_dict(self, values: dict):
        for k, v in values.items():
            self.update(k, v)

    def report_train(self, reset: bool = True) -> str:
        parts = [
            f"{name}={m.result():.5f}" for name, m in sorted(self.metrics.items())
        ]
        if reset:
            for m in self.metrics.values():
                m.reset()
        return " ".join(parts)

    def report_timing(self, n_steps: int = 1) -> str:
        dt = self.timer.elapsed()
        return f"{dt:.2f}s ({dt / max(n_steps, 1) * 1000:.1f} ms/step)"
