"""The port's stream runtime and its native host library, mirroring
tests/test_stream.py, plus the pipeline around a real (small, CPU)
`PoseEngine`, whose results must equal `engine.inference` frame by frame.

Tolerances: the stream and `inference` feed the network the same bytes (the
native resize and the numpy one are bit-exact), so decoded humans agree to
float32 roundoff of the batched forward: coords atol 1e-5, scores atol 1e-4.
"""
import ctypes
import threading
import time

import numpy as np
import pytest

from torch_parity import FLAGSHIP_NPZ, SYNTH_NPZ, flagship_flat
from hyperpose_torch.models.backbones import (
    VggTiny, VggTinyFusedStem, remap_vggtiny_to_fused,
)
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
from hyperpose_torch.ops.image import letterbox_resize, resize_bilinear
from hyperpose_torch.ops.kernels.build import BUILD_DIR
from hyperpose_torch.runtime import native
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.runtime.stream import StreamProcessor, _PyQueue, _make_queue
from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights


def _need_native():
    if native.get_lib() is None:
        pytest.skip(f"native runtime unavailable: {native.build_error}")


def test_native_library_builds_beside_the_package():
    _need_native()
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libhp_runtime-")
    assert not list(native._SRC.parent.glob("*.so"))


def test_native_queue_order_and_close():
    q = _make_queue(16)
    results = []

    def consumer():
        while True:
            try:
                results.extend(q.dump(4, timeout_ms=300))
            except EOFError:
                return

    t = threading.Thread(target=consumer)
    t.start()
    for i in range(50):
        q.push(i)
    time.sleep(0.2)
    q.close()
    t.join(timeout=5)
    assert results == list(range(50))


def test_py_queue_fallback_semantics():
    q = _PyQueue(4)
    for i in range(4):
        q.push(i)
    assert q.dump(10, timeout_ms=100) == [0, 1, 2, 3]
    q.close()
    with pytest.raises(EOFError):
        q.dump(1, timeout_ms=50)


def test_queue_falls_back_to_python_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    q = _make_queue(4)
    assert isinstance(q, _PyQueue)
    sp = StreamProcessor(_FakeEngine(), queue_capacity=8)
    assert not sp.native
    assert [r.index for r in sp.process(iter([np.zeros((8, 8, 3), np.uint8)] * 3))] \
        == [0, 1, 2]


class _FakeEngine:
    """Minimal engine stand-in (reference analog: BUILD_FAKE backend)."""

    input_hw = (32, 32)
    max_batch_size = 4

    def infer_batch_device(self, batch):
        import types

        b = batch.shape[0]
        return types.SimpleNamespace(
            coords=np.zeros((b, 2, 18, 2), np.float32),
            part_scores=np.zeros((b, 2, 18), np.float32),
            part_valid=np.zeros((b, 2, 18), bool),
            scores=np.zeros((b, 2), np.float32),
            valid=np.zeros((b, 2), bool),
        )


class _RecordingEngine(_FakeEngine):
    """Fake engine that records every dispatched batch."""

    def __init__(self):
        self.batches = []

    def infer_batch_device(self, batch):
        self.batches.append(np.asarray(batch).copy())
        return super().infer_batch_device(batch)


def test_stream_pipeline_ordered():
    sp = StreamProcessor(_FakeEngine(), queue_capacity=8)
    frames = (np.full((48, 64, 3), i, np.uint8) for i in range(30))
    assert [r.index for r in sp.process(frames)] == list(range(30))
    assert sp.frames_out == 30


def test_stream_batch_fill_tops_up_to_full():
    engine = _RecordingEngine()
    sp = StreamProcessor(engine)
    assert sp.input_q.stats()["capacity"] >= 2 * engine.max_batch_size
    frames = (np.full((48, 64, 3), i + 1, np.uint8) for i in range(32))
    results = list(sp.process(frames))
    assert [r.index for r in results] == list(range(32))
    fills = [int((b.reshape(b.shape[0], -1) != 0).any(axis=1).sum())
             for b in engine.batches]
    assert sum(fills) == 32
    assert all(f == engine.max_batch_size for f in fills[:-1])


def test_stream_low_latency_skips_topup():
    engine = _RecordingEngine()
    sp = StreamProcessor(engine)

    def slow_frames():
        for i in range(6):
            time.sleep(0.03)
            yield np.full((48, 64, 3), i + 1, np.uint8)

    t0 = time.perf_counter()
    results = list(sp.process(slow_frames(), low_latency=True))
    dt = time.perf_counter() - t0
    assert [r.index for r in results] == list(range(6))
    assert len(engine.batches) >= 3
    assert dt < 1.0


def test_stream_frames_bgr_swaps_for_device():
    engine = _RecordingEngine()
    sp = StreamProcessor(engine, queue_capacity=8)
    bgr = np.zeros((48, 64, 3), np.uint8)
    bgr[..., 0], bgr[..., 1], bgr[..., 2] = 30, 20, 10  # B,G,R
    results = list(sp.process(iter([bgr]), frames_bgr=True))
    assert len(results) == 1 and results[0].frame_is_bgr
    np.testing.assert_array_equal(results[0].frame, bgr)
    seen = engine.batches[0][0]
    assert (seen[..., 0] == 10).all() and (seen[..., 2] == 30).all()


def test_prep_frame_is_the_numpy_resize(monkeypatch):
    """The native resize and the numpy fallback give the same bytes, BGR
    swap included."""
    sp = StreamProcessor(_FakeEngine(), queue_capacity=8)
    frame = np.random.default_rng(1).integers(0, 256, (50, 70, 3), np.uint8)
    for bgr in (False, True):
        sp._frames_bgr = bgr
        want = resize_bilinear(frame, (32, 32))
        want = want[..., ::-1] if bgr else want
        np.testing.assert_array_equal(sp._prep_frame(frame), want)
        monkeypatch.setattr(native, "get_lib", lambda: None)
        np.testing.assert_array_equal(sp._prep_frame(frame), want)
        monkeypatch.undo()
    sp.shutdown()


def test_process_video_writer_thread(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for i in range(10):
        w.write(np.full((48, 64, 3), i * 20, np.uint8))
    w.release()
    sp = StreamProcessor(_RecordingEngine(), queue_capacity=8)
    out = str(tmp_path / "out.mp4")
    stats = sp.process_video(src, out, topology=COCO_TOPOLOGY)
    assert stats["frames"] == 10
    cap = cv2.VideoCapture(out)
    assert cap.isOpened()
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 10


def test_stream_monitor_runs():
    sp = StreamProcessor(_FakeEngine(), queue_capacity=8)
    sp.add_queue_monitor(interval_ms=50)
    frames = (np.zeros((48, 64, 3), np.uint8) for _ in range(10))
    assert len(list(sp.process(frames))) == 10
    sp._monitor.join(timeout=1.0)
    assert not sp._monitor.is_alive()


def test_native_resize_matches_numpy():
    """Bit-exact with the numpy resize and letterbox the engine uses."""
    _need_native()
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (97, 203, 3), np.uint8)
    batch = np.zeros((2, 64, 48, 3), np.uint8)
    assert native.resize_into_batch(img, batch, 0) == (1.0, 1.0)
    np.testing.assert_array_equal(batch[0], resize_bilinear(img, (64, 48)))
    rx, ry = native.resize_into_batch(img, batch, 1, keep_ratio=True)
    canvas, prx, pry = letterbox_resize(img, (64, 48))
    np.testing.assert_array_equal(batch[1], canvas)
    assert abs(rx - prx) < 1e-6 and abs(ry - pry) < 1e-6
    up = np.zeros((1, 128, 256, 3), np.uint8)
    native.resize_into_batch(img, up, 0, swap_rb=True)
    np.testing.assert_array_equal(up[0], resize_bilinear(img, (128, 256))[..., ::-1])
    native.resize_into_batch(np.full((1, 1, 3), 77, np.uint8), up, 0)
    assert (up[0] == 77).all()


def test_native_batcher_copy():
    _need_native()
    lib = native.get_lib()
    src = np.arange(4 * 6 * 3, dtype=np.uint8).reshape(4, 6, 3)
    dst = np.zeros((2, 4, 6, 3), np.uint8)
    lib.hp_copy_into_batch(src.ctypes.data_as(ctypes.c_char_p), 4, 6,
                           dst.ctypes.data_as(ctypes.c_char_p), 1, 4, 6)
    np.testing.assert_array_equal(dst[1], src)
    assert dst[0].sum() == 0
    small = np.zeros((1, 2, 3, 3), np.uint8)
    lib.hp_copy_into_batch(src.ctypes.data_as(ctypes.c_char_p), 4, 6,
                           small.ctypes.data_as(ctypes.c_char_p), 0, 2, 3)
    np.testing.assert_array_equal(small[0, 0, 0], src[0, 0])
    np.testing.assert_array_equal(small[0, 1, 2], src[2, 4])


def test_native_pool_runs_tasks():
    _need_native()
    pool = native.NativePool(2)
    results = []
    lock = threading.Lock()
    for i in range(32):
        def task(i=i):
            with lock:
                results.append(i)
        pool.enqueue(task)
    pool.wait()
    assert sorted(results) == list(range(32))
    pool.close()


def test_stream_reorders_shuffled_preproc():
    rng = np.random.default_rng(3)
    sp = StreamProcessor(_FakeEngine(), n_preproc=3)
    orig_prep = sp._prep_frame

    def jittered(frame):
        time.sleep(float(rng.uniform(0, 0.004)))
        return orig_prep(frame)

    sp._prep_frame = jittered
    frames = []
    for i in range(60):
        f = np.zeros((32, 32, 3), np.uint8)
        f[0, 0, 0] = i % 251
        frames.append(f)
    out = list(sp.process(iter(frames)))
    assert [r.index for r in out] == list(range(60))
    assert [int(r.frame[0, 0, 0]) for r in out] == [i % 251 for i in range(60)]


# -- around a real engine ------------------------------------------------------

def _engine(stem: str, **kw):
    if stem == "fused":
        model = LightWeightOpenPose(backbone=VggTinyFusedStem)
        weights = remap_vggtiny_to_fused(flagship_flat())
    else:
        model, weights = LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ
    return PoseEngine(model, weights, input_hw=(96, 112), max_batch_size=2,
                      device="cpu", **kw)


def _assert_humans_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g.parts) == sorted(w.parts)
        assert g.score == pytest.approx(w.score, abs=1e-4)
        for p, part in w.parts.items():
            assert (g.parts[p].x, g.parts[p].y) == pytest.approx(
                (part.x, part.y), abs=1e-5)


@pytest.mark.parametrize("stem,fmt", [("plain", "rgb8"), ("fused", "rgb8"),
                                      ("plain", "yuv420")])
def test_stream_over_engine_equals_inference(stem, fmt):
    """Ordered results through the packed device step, each equal to
    `engine.inference` on that frame alone."""
    engine = _engine(stem, input_format=fmt)
    rng = np.random.default_rng(0)
    synth = np.load(SYNTH_NPZ)["rgb"]
    frames = [synth] + [rng.integers(0, 256, (60, 80, 3), np.uint8) for _ in range(4)]
    sp = StreamProcessor(engine, queue_capacity=8)
    out = list(sp.process(iter(frames)))
    assert [r.index for r in out] == list(range(5))
    assert len(out[0].humans) >= 1
    for r, frame in zip(out, frames):
        assert r.frame is frame
        _assert_humans_equal(r.humans, engine.inference([frame])[0])


def test_stream_low_latency_over_engine():
    engine = _engine("plain")
    sp = StreamProcessor(engine, queue_capacity=8)
    frames = [np.zeros((40, 40, 3), np.uint8)] * 3
    out = list(sp.process(iter(frames), low_latency=True))
    assert [r.index for r in out] == [0, 1, 2]
    want = engine.inference([frames[0]])[0]
    for r in out:
        _assert_humans_equal(r.humans, want)


def test_stream_shutdown_stops_its_threads():
    sp = StreamProcessor(_engine("plain"), queue_capacity=8)
    gen = sp.process(iter([np.zeros((40, 40, 3), np.uint8)] * 6))
    next(gen)
    gen.close()
    assert all(not t.is_alive() for t in sp._threads)
    assert sp._pool is None


def test_stream_serves_a_pifpaf_engine_in_order():
    """A fused-decode engine (17 parts in the packed layout, learnt by
    warmup) behind the stream: ordered results, each equal to `inference`
    on that frame alone."""
    model = Pifpaf()
    engine = PoseEngine(model, random_flax_weights(model, seed=11),
                        input_hw=(64, 96), max_batch_size=2, device="cpu",
                        topology=PIFPAF_TOPOLOGY,
                        fused_decode=pifpaf_fused_decode(model))
    engine.warmup()
    assert engine._out_p == 17
    rng = np.random.default_rng(4)
    frames = [np.load(SYNTH_NPZ)["rgb"]] + [
        rng.integers(0, 256, (60, 80, 3), np.uint8) for _ in range(4)]
    sp = StreamProcessor(engine, queue_capacity=8)
    out = list(sp.process(iter(frames)))
    assert [r.index for r in out] == list(range(5))
    assert sum(len(r.humans) for r in out) > 0
    for r, frame in zip(out, frames):
        assert r.frame is frame
        assert all(max(h.parts) < 17 for h in r.humans)
        _assert_humans_equal(r.humans, engine.inference([frame])[0])
