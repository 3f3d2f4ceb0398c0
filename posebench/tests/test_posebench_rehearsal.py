"""Each traffic driver's whole run, on the CPU at a small size, ends in a
well-formed result line; and a cell, configuration, traffic mix, limits
and per-layer metric added as new files and entries alone are found and
run, with no file of the benchmark edited."""
from __future__ import annotations

import json

import pytest

from tiny import LIVE, REPO, cell, run, tiny_tree

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]] + [LIVE]


def _well_formed(line: dict, c, trace: bool):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] >= 0
    names = c.metric_names("per_layer" if trace else "end_to_end")
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    for name, m in line["metrics"].items():
        assert m["unit"] == c.metric(name)["unit"] and isinstance(m["value"], (int, float))
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(c.limits)
    for k, v in line["checks"].items():
        assert v["limit"] == c.limits[k]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_runs_on_the_cpu_to_a_well_formed_line(workload, trace, tmp_path):
    c = cell(workload, tiny_tree(tmp_path))
    line = run(c, trace=trace)
    _well_formed(line, c, trace)


def test_a_cell_added_as_new_files_and_entries_alone_runs(tmp_path):
    bench = tiny_tree(tmp_path)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "lwopenpose-tinyvgg.json").read_text())
    cfg.update(name="lwopenpose-tinyvgg-small", input_hw=[96, 128])
    (bench / "configs" / "lwopenpose-tinyvgg-small.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "offline-b32.json").read_text())
    (bench / "traffic" / "offline-b3.json").write_text(json.dumps({**mix, "batch": 3}))
    name = "lwopenpose-tinyvgg-small.offline-b3"
    (bench / "limits" / f"{name}.json").write_text(
        (bench / "limits" / "lwopenpose-tinyvgg.offline-b32.json").read_text())
    (bench / "metrics" / "kernels_a_step.offline-b3.py").write_text(
        "def read(summary):\n    return float(len(summary['kernels']))\n")
    spec["configs"].append({"name": cfg["name"], "source": "https://arxiv.org/abs/1811.12004",
                            "file": "posebench/configs/lwopenpose-tinyvgg-small.json",
                            "reduced": [], "why": "the flagship at a smaller input"})
    spec["workloads"].append({"name": name, "config": cfg["name"], "traffic": "offline-b3",
                              "chips": 1, "why": "a cell made of data files alone"})
    next(m for m in spec["end_to_end"] if m["name"] == "fps")["workloads"].append(name)
    spec["per_layer"].append({"name": "kernels_a_step.offline-b3", "unit": "kernels",
                              "better": "lower", "source": "device_trace", "layer": "device",
                              "moves": "fps", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cell(name, bench)
    assert c.traffic["batch"] == 3 and c.config["input_hw"] == [96, 128]
    line = run(c, trace=True)
    _well_formed(line, c, True)
    assert "kernels_a_step.offline-b3" in line["metrics"]
