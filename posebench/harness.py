"""One run of one cell: resolve the cell's files by name, run its traffic
driver, read the per-layer metrics, and print the result line.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own, found by name:

    configs/<config>.json     the model, its sizes, dtype and weights
    traffic/<traffic>.json    the mix's parameters; "driver" names the
                              generator (drivers/<driver>.py) that reads them
    limits/<cell>.json        the limit of each number the output check
                              compares
    metrics/<metric>.py       `read(summary)` of one per-layer metric
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hyperpose_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its files, under `root` (the
    checkout) and `bench` (the benchmark's folder, `root/posebench`)."""

    def __init__(self, name: str, root: Path, bench: Path | None = None):
        self.root = Path(root)
        self.bench = Path(bench) if bench is not None else self.root / "posebench"
        spec = read_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"posebench: no workload {name!r} in BENCHMARK.json")
        self.spec, self.workload, self.name = spec, cells[name], name
        self.config = read_json(self.bench / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(self.bench / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = read_json(self.bench / "limits" / f"{name}.json")
        self.chips = int(self.workload["chips"])

    def metric_names(self, kind: str) -> list[str]:
        """The cell's end-to-end (`kind` "end_to_end") or per-layer metrics."""
        if kind == "end_to_end":
            return [m["name"] for m in self.spec["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        e2e = set(self.metric_names("end_to_end"))
        return [m["name"] for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def metric(self, name: str) -> dict:
        return next(m for m in self.spec["end_to_end"] + self.spec["per_layer"] if m["name"] == name)

    def reader(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py", f"posebench_metric_{name}")

    def reference(self):
        """The plain reference network of the configuration."""
        return importlib.import_module(f"posebench.reference.{self.config['reference']}")

    def driver(self):
        return importlib.import_module(f"posebench.drivers.{self.traffic['driver']}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, out: dict, trace: bool) -> dict:
    """The contract's last line from a driver's output."""
    checks = out["checks"]
    correct = all(v <= lim for v, lim in checks.values())
    if trace:
        summary = out["summary"]
        metrics = {}
        for name in cell.metric_names("per_layer"):
            value = cell.reader(name).read(summary)
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.metric(name)["unit"]}
    else:
        metrics = {name: {"value": out["metrics"][name], "unit": cell.metric(name)["unit"]}
                   for name in cell.metric_names("end_to_end")}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dict(out["device"])}
    if trace:
        line["device"].update(busy_s=out["summary"]["busy_s"], window_s=out["summary"]["window_s"])
        line["breakdown"] = {"device_ops": out["summary"]["device_ops"],
                             "idle_gaps": out["summary"]["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return finite(line)


def finite(obj):
    """`obj` with every NaN or infinite number as None, so that the line is
    JSON; a check that reads None has failed (`correct` is false)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def print_checks(checks: dict) -> None:
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: str | None = None) -> dict | None:
    """One run of `cell` on `device`: the driver, the per-layer readers, the
    checks on standard error, then the look at the loaded modules; returns
    the result line, or None (with the reason on standard error) where a
    module of JAX or of the JAX package is loaded by then."""
    out = cell.driver().run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                            t_start=t_start, control=control)
    line = result_line(cell, out, trace)
    print_checks(out["checks"])
    bad = forbidden_modules()
    if bad:
        print(f"posebench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return None
    return line
