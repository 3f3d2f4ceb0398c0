"""The cell openpose-vgg19.offline-b32 on the CPU at a small size: it
resolves to its files and readers; a whole traced run ends in a
well-formed, correct line that holds the three readers of the model's own
spans (`openpose/backbone`, `openpose/stages`); and a run whose answer is
shifted by a pixel is not correct."""
from __future__ import annotations

import gc

import pytest

from test_posebench_rehearsal import _well_formed
from tiny import REPO, cell, run, tiny_tree
from posebench import harness
from posebench.reference import counting, openpose_vgg19_ops

CELL = "openpose-vgg19.offline-b32"
SPAN_READERS = ("backbone_device_ms.vgg19", "stages_device_ms.vgg19", "stages_mfu.vgg19")


def test_the_cell_resolves_to_its_files_and_readers():
    c = harness.Cell(CELL, REPO)
    assert (c.config["name"], c.workload["traffic"], c.chips) == ("openpose-vgg19", "offline-b32", 1)
    assert c.traffic["batch"] == 32 and c.config["input_hw"] == [368, 656]
    assert c.metric_names("end_to_end") == ["fps", "setup_s"]
    names = c.metric_names("per_layer")
    assert set(SPAN_READERS) <= set(names)
    # VGG19 has no fused stem; the enqueue clock of drivers/offline.py is not read here.
    assert "conv1_pool_roofline" not in names and "host_enqueue_ms.offline" not in names
    assert all(callable(c.reader(n).read) for n in names)
    assert set(c.limits) == {"maps_rel_err", "skeleton_gap"}


def test_a_traced_run_reads_the_model_spans(tmp_path, monkeypatch):
    from hyperpose_torch.utils import tracing

    # The CPU has no device wall: each span's host wall stands in for it, so
    # that the readers' arithmetic runs on the spans the run recorded.
    mean_ms = tracing.mean_ms
    monkeypatch.setattr(tracing, "mean_ms", lambda name, period, what="host": mean_ms(
        name, period, "host" if what == "device" else what))
    c = cell(CELL, tiny_tree(tmp_path))
    before = {p["period"] for p in tracing.periods()}
    try:
        line = run(c, trace=True)
    finally:
        gc.unfreeze()
    _well_formed(line, c, True)
    assert line["correct"] is True, line["checks"]
    assert set(SPAN_READERS) <= set(line["metrics"])
    metrics_slice = next(p["period"] for p in tracing.periods()
                         if p["period"] not in before and p["profiler"])
    b = c.traffic["batch"]
    stages = tracing.spans(metrics_slice, "openpose/stages")
    assert stages and all(s["counts"] == {"stages": 6, "frames": b} for s in stages)
    backbone_ms = mean_ms("openpose/backbone", metrics_slice, "host")
    stages_ms = mean_ms("openpose/stages", metrics_slice, "host")
    got = {k: line["metrics"][k]["value"] for k in SPAN_READERS}
    assert got["backbone_device_ms.vgg19"] == pytest.approx(backbone_ms)
    assert got["stages_device_ms.vgg19"] == pytest.approx(stages_ms)
    ops = b * openpose_vgg19_ops.stage_operations(*c.config["input_hw"])
    assert got["stages_mfu.vgg19"] == pytest.approx(
        100 * ops / (stages_ms * 1e-3 * counting.H100_BF16_OPS_PER_S))


def test_a_shifted_answer_is_not_correct(tmp_path):
    try:
        line = run(cell(CELL, tiny_tree(tmp_path)), control="shifted_answer")
    finally:
        gc.unfreeze()
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["skeleton_gap"]["value"] > line["checks"]["skeleton_gap"]["limit"]
