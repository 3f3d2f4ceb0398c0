"""The port's spans (`hyperpose_torch/utils/tracing.py`) on the CPU:

- off, a span records nothing, makes no CUDA event and opens no profiler
  range;
- inside a `torch.profiler` session spans record with no `enable()`, with
  their parents, counts, self time and periods, on the profiler's clock;
- the buffer is bounded and counts what it drops;
- the engine's, the trainer's and the stream's spans, and the export of an
  engine with spans on;
- `device_profile`'s span track and its idle time by span;
- two traced runs of the benchmark's CPU rehearsal in one process each read
  the spans of their own `metrics` slice.
"""
import gc
import json
import logging
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_stream import _FakeEngine
from test_torch_train import _batch, _configs, _lw_vggtiny_p
from torch_parity import FLAGSHIP_NPZ
from hyperpose_torch.models.backbones import VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.runtime.stream import StreamProcessor
from hyperpose_torch.train.trainer import Trainer, make_optimizer
from hyperpose_torch.utils import tracing
from hyperpose_torch.utils.topology import COCO_TOPOLOGY

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def _tiny_engine(hw=(64, 72)):
    return PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=hw,
                      max_batch_size=1, device="cpu")


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_spans_record_nothing_and_touch_no_profiler_or_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not tracing.active()
    with tracing.span("a", device=True, frames=3):
        with tracing.span("b", device=torch.device("cuda")):
            pass
    eng = _tiny_engine()
    eng.infer_batch_device(np.zeros(eng.input_batch_shape(), np.uint8))
    assert tracing.spans() == [] and tracing.periods() == [] and tracing.report() == {}


def test_spans_record_inside_a_profiler_session_with_parents_counts_and_periods():
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
        with tracing.span("outer", images=4, waits=[1.0, 2.0]):
            with tracing.span("inner"):
                time.sleep(0.002)
            with tracing.span("inner"):
                time.sleep(0.002)
            time.sleep(0.003)
    with profile(activities=[ProfilerActivity.CPU]):     # no span between the sessions
        with tracing.span("second"):
            pass
    first, second = tracing.periods()
    assert first["profiler"] and second["profiler"]
    assert (first["spans"], first["dropped"], first["names"]) == (3, 0, ["inner", "outer"])
    assert (second["spans"], second["names"]) == (1, ["second"])
    recs = _by_name(tracing.spans(first["period"]))
    (outer,), inner = recs["outer"], recs["inner"]
    assert outer["parent"] is None and outer["counts"] == {"images": 4, "waits": [1.0, 2.0]}
    assert [r["parent"] for r in inner] == [outer["id"]] * 2
    assert all(r["device_ms"] is None for r in inner + [outer])
    children = sum(r["host_ms"] for r in inner)
    assert outer["self_ms"] == pytest.approx(outer["host_ms"] - children, abs=1e-9)
    assert outer["self_ms"] >= 2.5 and children >= 3.5
    assert all(outer["start_ns"] <= r["start_ns"] < r["end_ns"] <= outer["end_ns"] for r in inner)
    rep = tracing.report()
    assert set(rep) == {"outer", "inner", "second"}
    assert rep["inner"]["count"] == 2
    assert rep["outer"]["self_ms"] == pytest.approx(outer["self_ms"], rel=1e-6)
    assert rep["outer"]["mean_ms"] == pytest.approx(outer["host_ms"], rel=1e-6)
    assert "device_ms" not in rep["outer"]
    assert tracing.spans(second["period"])[0]["name"] == "second"


def test_enable_records_outside_a_profiler_and_reset_forgets():
    tracing.enable()
    with tracing.span("x"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("x"):
            pass
    with tracing.span("x"):
        pass
    assert [(p["profiler"], p["spans"]) for p in tracing.periods()] == [
        (False, 2), (True, 1)]
    tracing.enable(False)
    with tracing.span("x"):
        pass
    assert tracing.report()["x"]["count"] == 3
    tracing.reset()
    assert tracing.spans() == [] and tracing.report() == {}


def test_a_full_buffer_drops_and_counts_what_does_not_fit(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("s"):
            pass
    (p,) = tracing.periods()
    assert (p["spans"], p["dropped"]) == (3, 2)
    assert len(tracing.spans()) == 3
    assert tracing.report()["s"]["count"] == 5


def test_spans_are_on_the_profiler_s_clock():
    torch.set_num_threads(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("add"):
            torch.zeros(64) + 1
    (rec,) = tracing.spans(name="add")
    adds = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::add"]
    assert len(adds) == 1
    start = adds[0].start_ns()
    end = start + adds[0].duration_ns()
    slack = 20_000
    assert rec["start_ns"] - slack <= start and end <= rec["end_ns"] + slack


def test_engine_step_holds_network_and_decode():
    eng = _tiny_engine()
    tracing.enable()
    eng.infer_batch_device(np.zeros(eng.input_batch_shape(), np.uint8))
    recs = _by_name(tracing.spans())
    assert set(recs) == {"engine/step", "engine/network", "engine/decode"}
    (step,), (net,), (dec,) = recs["engine/step"], recs["engine/network"], recs["engine/decode"]
    assert step["counts"] == {"frames": 1}
    assert net["parent"] == dec["parent"] == step["id"]
    assert net["end_ns"] <= dec["start_ns"]
    assert all(r["device_ms"] is None for r in (step, net, dec))   # no device walls on the CPU


def test_engine_save_exports_with_spans_on(tmp_path):
    eng = _tiny_engine()
    tracing.enable()
    paths = eng.save(str(tmp_path / "eng"))
    assert Path(paths["executable"]).is_file() and Path(paths["weights"]).is_file()
    assert tracing.spans() == []        # nothing records while torch.export traces
    fn = PoseEngine.load_executable(paths["executable"])
    x = torch.zeros(eng.input_batch_shape(), dtype=torch.uint8)
    got = fn(x)
    want = eng.infer_batch_device(x)
    np.testing.assert_array_equal(got[4].numpy(), want.valid.numpy())


def test_trainer_step_yields_the_five_trainer_spans(tmp_path):
    hw, out_hw = (64, 80), (8, 10)
    _, pcfg = _configs(tmp_path, "LightweightOpenpose", hw, out_hw)
    tr = Trainer(pcfg, _lw_vggtiny_p(), np.asarray(COCO_TOPOLOGY.limbs), device="cpu")
    tr.optimizer = make_optimizer(pcfg, tr.params)
    batch = _batch(4, hw, out_hw, 19)
    tracing.enable()
    tr.step(batch)
    recs = _by_name(tracing.spans())
    assert set(recs) == {"trainer/step", "trainer/forward", "trainer/loss", "trainer/backward",
                         "trainer/optimizer"}
    (step,) = recs["trainer/step"]
    assert step["counts"] == {"images": 2, "graphed": 0}     # the CPU step is eager
    phases = [recs[k][0] for k in ("trainer/forward", "trainer/loss", "trainer/backward",
                                   "trainer/optimizer")]
    assert all(r["parent"] == step["id"] for r in phases)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(phases, phases[1:]))
    assert step["self_ms"] < step["host_ms"]


class _SlowEngine(_FakeEngine):
    def infer_batch_device(self, batch):
        time.sleep(0.01)
        return super().infer_batch_device(batch)


def test_stream_dispatch_spans_fill_sums_to_the_frames(caplog):
    tracing.enable()
    sp = StreamProcessor(_SlowEngine(), queue_capacity=8)
    with caplog.at_level(logging.INFO, logger="hyperpose_torch.stream"):
        sp.add_queue_monitor(interval_ms=20)
        frames = (np.full((48, 64, 3), i, np.uint8) for i in range(30))
        assert [r.index for r in sp.process(frames)] == list(range(30))
        sp._monitor.join(timeout=1.0)
    recs = _by_name(tracing.spans())
    dispatch, emit = recs["stream/dispatch"], recs["stream/emit"]
    bmax = _FakeEngine.max_batch_size
    assert sum(r["counts"]["fill"] for r in dispatch) == 30
    assert all(r["counts"]["padded"] == bmax - r["counts"]["fill"] for r in dispatch)
    assert all(len(r["counts"]["queue_wait_ms"]) == r["counts"]["fill"] for r in dispatch)
    assert all(w >= 0 for r in dispatch for w in r["counts"]["queue_wait_ms"])
    assert sum(r["counts"]["frames"] for r in emit) == 30
    assert any("dispatch_fill=" in m and "queue_wait_ms p50=" in m for m in caplog.messages)


def test_idle_by_span_puts_each_gap_down_to_the_innermost_span():
    busy = [(10, 20), (15, 30), (50, 60), (95, 120)]
    spans_ = [(0, 45, "step"), (35, 45, "step/decode")]
    got = tracing.idle_by_span(busy, spans_, 0, 100)
    # device busy [10, 30], [50, 60], [95, 100]; idle [0, 10], [30, 50], [60, 95]
    assert got["window_s"] == pytest.approx(100e-9)
    assert got["busy_s"] == pytest.approx(35e-9)
    assert got["idle_s"] == pytest.approx(65e-9)
    assert got["by_span"] == pytest.approx({"step": 10e-9, "step/decode": 20e-9,
                                            tracing.OUTSIDE: 35e-9})
    assert tracing.idle_by_span([], [], 0, 10)["by_span"] == pytest.approx(
        {tracing.OUTSIDE: 10e-9})


def test_device_profile_writes_the_span_track_and_idle_by_span(tmp_path):
    logdir = tmp_path / "prof"
    with tracing.device_profile(str(logdir)):
        with tracing.span("block", n=1):
            with tracing.span("block/inner"):
                torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    trace = json.loads((logdir / "trace.json").read_text())
    track = [e for e in trace["traceEvents"]
             if e.get("pid") == "hyperpose_torch spans" and e.get("ph") == "X"]
    assert sorted(e["name"] for e in track) == ["block", "block/inner"]
    mm = next(e for e in trace["traceEvents"] if e.get("name") == "aten::mm")
    inner = next(e for e in track if e["name"] == "block/inner")
    assert inner["ts"] - 20 <= mm["ts"] and mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"] + 20
    idle = json.loads((logdir / "idle_by_span.json").read_text())
    assert idle["window_s"] == pytest.approx(idle["busy_s"] + idle["idle_s"])
    assert sum(idle["by_span"].values()) == pytest.approx(idle["idle_s"])


def test_two_traced_rehearsal_runs_each_read_their_own_metrics_slice(tmp_path):
    bench_tests = str(REPO / "posebench" / "tests")
    if bench_tests not in sys.path:
        sys.path.insert(0, bench_tests)
    from tiny import cell, tiny_tree
    from posebench import harness

    c = cell("lwopenpose-tinyvgg.offline-b32", tiny_tree(tmp_path))
    # The run's two threads, as `run.py` sets them; restored after, since the
    # tests that share this process compare single-threaded results bit for bit.
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    seen, readings = [], []
    try:
        for seed in (3_000_000_019, 2_147_483_659):
            before = {p["period"] for p in tracing.periods()}
            out = c.driver().run(c, seed=seed, seconds=1.0, trace=True, device="cpu",
                                 t_start=time.perf_counter())
            line = harness.result_line(c, out, True)
            new = [p for p in tracing.periods() if p["period"] not in before]
            assert [p["profiler"] for p in new] == [True, True]      # metrics, then host
            seen.append(new[0]["period"])
            readings.append(line["metrics"])
    finally:
        gc.unfreeze()
        torch.set_num_threads(threads)
    assert seen[0] != seen[1]
    for period, metrics in zip(seen, readings):
        for name, span, wall in (("engine_host_ms.offline", "engine/step", "host"),
                                 ("decode_host_ms.offline", "engine/decode", "host")):
            assert metrics[name]["unit"] == "ms"
            assert metrics[name]["value"] == pytest.approx(tracing.mean_ms(span, period, wall))
        # no device wall on the CPU: the device metrics are left out
        assert "network_device_ms.offline" not in metrics
        assert "decode_device_ms.offline" not in metrics
