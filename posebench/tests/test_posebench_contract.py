"""BENCHMARK.json against the benchmark's contract, and every cell against
its files."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "posebench/run.py"]
    assert SPEC["paths"] == ["posebench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time_with_24_cells():
    per_run = SPEC["run_seconds"] + 60
    total = (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200
    assert total <= 43200


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_all_names()),
                         ids=lambda v: v if isinstance(v, str) else v["name"])
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if group == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in entry["reduced"]) and len(entry["reduced"]) <= 16
        assert entry["file"].startswith("posebench/") and (REPO / entry["file"]).is_file()
    elif group == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
        assert entry["chips"] in (1, 4)
    else:
        extra = {"bound"} if group == "end_to_end" else {"layer", "moves"}
        assert METRIC_KEYS | extra <= set(entry) <= METRIC_KEYS | extra | {"workloads"}
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in cells:
        reported = [m["name"] for m in SPEC["end_to_end"] if w in m.get("workloads", [w])]
        assert "setup_s" in reported and len(reported) >= 2, w


def test_every_config_is_used_and_four_chip_cells_are_few():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in SPEC["per_layer"]), w


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    from posebench import harness

    cell = harness.Cell(workload, REPO)
    assert cell.config["name"] == cell.workload["config"]
    assert (REPO / "posebench" / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert (REPO / "posebench" / "reference" / f"{cell.config['reference']}.py").is_file()
    spec_cfg = next(c for c in SPEC["configs"] if c["name"] == cell.workload["config"])
    assert cell.config["reduced"] == spec_cfg["reduced"]
    for name in cell.metric_names("per_layer"):
        assert callable(cell.reader(name).read)
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert cell.driver().run is not None
