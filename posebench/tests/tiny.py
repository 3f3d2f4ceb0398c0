"""A small copy of the benchmark's cells for CPU tests: the same files under
a temporary root, each configuration at a small input size and each mix at
a small batch, so a whole run of a driver fits in a few seconds here."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from posebench import harness  # noqa: E402

HW = {"lwopenpose-tinyvgg": [160, 192], "openpose-vgg19": [112, 160]}
TRAFFIC = {
    "offline": {"batch": 2, "pool": 4, "staged_batches": 2, "warmup_steps": 2,
                "checked_steps": 2, "trace_slice_s": 0.4},
    "live": {"cameras": 8, "fps": 5, "batch": 2, "pool": 4, "checked_frames": 6,
             "settle_s": 0.4, "drain_s": 20, "trace_slice_s": 0.4},
    "train": {"batch": 2, "batches": 4, "checked_steps": 3, "trace_slice_s": 0.4},
}


LIVE = "openpose-vgg19.live-cams"


def tiny_tree(root: Path) -> Path:
    """Copy BENCHMARK.json and the benchmark's data files under `root`, cut
    to small sizes, with the live-camera cell whose files are kept for a
    later PR (`live_cell.json`: its entries) added; returns the copy's
    benchmark folder."""
    bench = root / "posebench"
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    live = json.loads((Path(__file__).parent / "live_cell.json").read_text())
    if LIVE not in {w["name"] for w in spec["workloads"]}:
        spec["configs"].append(live["config"])
        spec["workloads"].append(live["workload"])
        spec["end_to_end"][1:1] = live["end_to_end"]
        spec["per_layer"] += live["per_layer"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "posebench" / sub, bench / sub)
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["input_hw"] = HW[cfg["name"]]
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(TRAFFIC[mix["driver"]])
        path.write_text(json.dumps(mix))
    return bench


def cell(name: str, bench: Path) -> harness.Cell:
    """A cell of the tiny tree; its configurations' files (the committed
    checkpoint) are read from the repository."""
    c = harness.Cell(name, bench.parent, bench)
    c.root = REPO
    return c


def run(c: harness.Cell, seed: int = 3_000_000_019, seconds: float = 1.0,
        trace: bool = False, control=None) -> dict | None:
    """One run of the cell on the CPU, as `run.py` makes it on the card
    (None where `run.py` would print no result)."""
    import torch

    torch.set_num_threads(2)
    line = harness.run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(), control)
    return None if line is None else json.loads(json.dumps(line, allow_nan=False))
