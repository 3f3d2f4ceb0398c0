"""Streaming inference runtime: ordered frames -> skeletons pipeline.

Counterpart of `hyperpose_tpu/runtime/stream.py` (reference:
include/hyperpose/stream/stream.hpp:18-416, src/stream.cpp:18-183): the
stage graph read -> preprocess -> greedy batch -> network + decode -> write,
with the network *and* the decoder on the device per batch, and the host
stages handing frames through the port's native C++ bounded queues
(`runtime/native`), so ordering is FIFO by construction.

    stream = StreamProcessor(engine)
    stream.add_queue_monitor(1000)
    for frame_result in stream.process(frames):
        ...

Three changes from the JAX package: the host resize is the native one (or
the numpy `resize_bilinear`, byte for byte the same) instead of OpenCV, which
the GPU's machine lacks; the device stage hands the port's
`PoseEngine._step_packed` a tensor on the engine's device and copies the
result back without blocking, into pinned memory on a CUDA device; and
`process_video` (which reads and writes video) keeps its lazy OpenCV import.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Iterator

import numpy as np
import torch

from ..ops.image import resize_bilinear, rgb_to_yuv420
from ..utils import tracing
from ..utils.human import Human, SkeletonBatch, draw_humans

logger = logging.getLogger("hyperpose_torch.stream")


@dataclasses.dataclass
class FrameResult:
    index: int
    frame: np.ndarray
    """Original frame as supplied by the source. RGB unless the pipeline ran
    with frames_bgr=True (headless process_video does), in which case it is
    BGR — check `frame_is_bgr` before drawing/saving."""
    humans: list[Human]
    frame_is_bgr: bool = False


class _PyQueue:
    """Pure-Python fallback with the NativeQueue interface."""

    def __init__(self, capacity: int):
        import queue

        self._q = queue.Queue(maxsize=capacity)
        self._closed = threading.Event()
        self.pushed = 0
        self.popped = 0

    def push(self, obj) -> bool:
        while not self._closed.is_set():
            try:
                self._q.put(obj, timeout=0.2)
                self.pushed += 1
                return True
            except Exception:
                continue
        return False

    def dump(self, max_items: int, timeout_ms: int = -1) -> list:
        import queue as qm

        items = []
        try:
            items.append(self._q.get(
                timeout=None if timeout_ms < 0 else timeout_ms / 1000
            ))
        except qm.Empty:
            if self._closed.is_set() and self._q.empty():
                raise EOFError from None
            return []
        while len(items) < max_items:
            try:
                items.append(self._q.get_nowait())
            except qm.Empty:
                break
        self.popped += len(items)
        return items

    def pop(self, timeout_ms: int = -1):
        return self.dump(1, timeout_ms)[0]

    def close(self):
        self._closed.set()

    def stats(self) -> dict:
        return {
            "size": self._q.qsize(), "capacity": self._q.maxsize,
            "pushed": self.pushed, "popped": self.popped,
            "closed": self._closed.is_set(),
        }


def _make_queue(capacity: int):
    try:
        from .native import NativeQueue

        return NativeQueue(capacity)
    except Exception:
        return _PyQueue(capacity)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


class StreamProcessor:
    """Ordered, overlapped stream inference around a PoseEngine.

    Stage threads (reference: build_internal_running_graph,
    stream.hpp:260-275):
      reader   -> input_queue   (decoded RGB frames)
      preproc  -> resized_queue (model-input uint8 frames + original)
      device   -> result_queue  (greedy-batched network + decode)
    Results are consumed in order from the caller's thread.
    """

    def __init__(self, engine, queue_capacity: int | None = None,
                 n_preproc: int | None = None):
        # Queues must hold at least two full device batches so the engine's
        # batch size is actually reachable (a 64-slot queue in front of a
        # 128-frame batch would cap every dispatch at half fill and pad the
        # rest with zeros).
        if queue_capacity is None:
            queue_capacity = max(64, 2 * engine.max_batch_size)
        if n_preproc is None:
            n_preproc = max(1, min(4, (os.cpu_count() or 2) - 1))
        self.engine = engine
        self.n_preproc = n_preproc
        self.input_q = _make_queue(queue_capacity)
        self.resized_q = _make_queue(queue_capacity)
        self.result_q = _make_queue(queue_capacity)
        self._threads: list[threading.Thread] = []
        self._pool = None  # native affinity-pinned worker pool (preproc)
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self._frames_bgr = False
        self._low_latency = False
        self.frames_in = 0
        self.frames_out = 0

    @property
    def native(self) -> bool:
        """Whether the stage queues are the native C++ ones."""
        return not isinstance(self.input_q, _PyQueue)

    # -- stages --------------------------------------------------------------

    def _reader(self, frames: Iterator[np.ndarray]):
        idx = 0
        for frame in frames:
            if self._stop.is_set():
                break
            self.input_q.push((idx, frame))
            idx += 1
            self.frames_in = idx
        self.input_q.close()

    def _prep_frame(self, frame: np.ndarray) -> np.ndarray:
        """Resize one frame to the model input and encode it into the
        engine's infeed layout. The BGR->RGB swap of headless video is folded
        into the native resize (or made on the small frame), so no
        full-resolution channel swap is ever paid."""
        from .native import resize_into_batch

        h, w = self.engine.input_hw
        small = np.empty((1, h, w, 3), np.uint8)
        if resize_into_batch(frame, small, 0, swap_rb=self._frames_bgr) is None:
            small[0] = resize_bilinear(frame, (h, w))
            if self._frames_bgr:
                small[0] = small[0, ..., ::-1]
        if getattr(self.engine, "input_format", "rgb8") == "yuv420":
            return rgb_to_yuv420(small[0])
        return small[0]

    def _preproc_loop(self):
        """One preprocess worker: pull decoded frames, emit infeed-ready
        frames. N of these run concurrently (native affinity-pinned pool
        when available) — the reference's per-stage worker threads
        (src/stream.cpp:68-112, src/thread_pool.cpp:39-68). Order is
        restored at the consumer (reorder buffer keyed by frame index)."""
        while not self._stop.is_set():
            try:
                items = self.input_q.dump(4, timeout_ms=200)
            except EOFError:
                break
            for idx, frame in items:
                resized = self._prep_frame(frame)
                self.resized_q.push((idx, frame, resized, time.perf_counter_ns()))

    def _start_preproc(self):
        """Launch the preproc workers on the native pool (Python threads
        when the native runtime is unavailable)."""
        remaining = [self.n_preproc]
        lock = threading.Lock()

        def worker():
            try:
                self._preproc_loop()
            except BaseException:
                # A dead worker drops the frames it had popped (the reorder
                # buffer skips the gap at EOF); surface it loudly instead
                # of letting the pool trampoline swallow the traceback.
                logger.exception("stream preproc worker died")
            finally:
                with lock:
                    remaining[0] -= 1
                    last = remaining[0] == 0
                if last:
                    self.resized_q.close()

        try:
            from .native import NativePool

            self._pool = NativePool(self.n_preproc, pin_affinity=True)
            for _ in range(self.n_preproc):
                self._pool.enqueue(worker)
        except Exception:
            self._pool = None
            for _ in range(self.n_preproc):
                t = threading.Thread(target=worker, daemon=True)
                t.start()
                self._threads.append(t)

    def _device_worker(self):
        bmax = self.engine.max_batch_size
        use_packed = hasattr(self.engine, "_step_packed")
        shape_fn = getattr(self.engine, "input_batch_shape", None)
        if shape_fn is not None:
            batch_shape = shape_fn()
        else:
            h, w = self.engine.input_hw
            batch_shape = (bmax, h, w, 3)
        device = torch.device(getattr(self.engine, "device", "cpu"))
        cuda = device.type == "cuda"
        # Double-buffered staging: while batch k is in flight on the device,
        # batch k+1 fills the other buffer (no per-dispatch allocation).
        # Pinned on a CUDA device, so both copies run without blocking; a
        # buffer is refilled only after its batch's result came back.
        bufs = [torch.zeros(batch_shape, dtype=torch.uint8, pin_memory=cuda)
                for _ in range(2)]
        buf_i = 0

        def dispatch(items):
            # Span `stream/dispatch`: the batch's fill, its padding and each
            # frame's wait from its push into resized_q to here.
            waits = ([(time.perf_counter_ns() - t) / 1e6 for *_, t in items]
                     if tracing.active() else [])
            with tracing.span("stream/dispatch", fill=len(items), padded=bmax - len(items),
                              queue_wait_ms=waits):
                return _dispatch(items)

        def _dispatch(items):
            nonlocal buf_i
            staged = bufs[buf_i]
            buf_i ^= 1
            batch_buf = staged.numpy()
            for i, (_, _, resized, _) in enumerate(items):
                batch_buf[i] = resized
            if len(items) < bmax:
                batch_buf[len(items):] = 0
            if not use_packed:
                return self.engine.infer_batch_device(batch_buf)
            packed = self.engine._step_packed(staged.to(device, non_blocking=cuda))
            if not cuda:
                return packed, None
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

        def emit(items, pending):
            with tracing.span("stream/emit", frames=len(items)):
                if use_packed:
                    host, done = pending
                    if done is not None:
                        done.synchronize()
                    sk = self.engine.unpack_skeletons(host.numpy())
                else:
                    d = pending
                    sk = SkeletonBatch(*(_to_numpy(getattr(d, f)) for f in (
                        "coords", "part_scores", "part_valid", "scores", "valid")))
                for i, (idx, frame, *_) in enumerate(items):
                    self.result_q.push(FrameResult(
                        idx, frame, sk.to_humans(i),
                        frame_is_bgr=self._frames_bgr,
                    ))

        # Double-buffered dispatch: batch k+1 is in flight while batch k's
        # (single, packed) device->host copy completes, hiding the transfer
        # behind compute (replaces the reference's stage overlap via parser
        # replica threads, stream.hpp:347-385).
        # Greedy batching with a short fill window: a dispatch costs a
        # full engine batch of device work whatever its fill, so after
        # taking what's available, top up for <=50 ms toward a FULL batch
        # (reference analog: dump-whatever-is-there, stream.hpp:326-345).
        # Live sources (camera, imshow) instead run low-latency: dispatch
        # whatever arrived, no top-up wait.
        min_fill = 1 if self._low_latency else bmax
        in_flight: tuple | None = None
        closed = False
        while not closed:
            try:
                items = self.resized_q.dump(bmax, timeout_ms=200)
            except EOFError:
                break
            if items and len(items) < min_fill:
                deadline = time.perf_counter() + 0.05
                while len(items) < min_fill and time.perf_counter() < deadline:
                    try:
                        items.extend(self.resized_q.dump(
                            bmax - len(items), timeout_ms=10
                        ))
                    except EOFError:
                        closed = True
                        break
            if not items:
                if in_flight is not None:
                    emit(*in_flight)
                    in_flight = None
                continue
            pending = dispatch(items)
            if in_flight is not None:
                emit(*in_flight)
            in_flight = (items, pending)
        if in_flight is not None:
            emit(*in_flight)
        self.result_q.close()

    # -- public API ----------------------------------------------------------

    def process(
        self, frames: Iterator[np.ndarray], frames_bgr: bool = False,
        low_latency: bool = False,
    ) -> Iterator[FrameResult]:
        """Run the pipeline over an iterator of RGB frames; yields ordered
        FrameResults. frames_bgr=True accepts BGR frames (cv2 native) and
        swaps channels on the small resized frame instead — FrameResult
        .frame is then BGR too (and flagged frame_is_bgr). low_latency=True
        skips the batch top-up window: right for live sources whose frame
        rate can never fill a large batch inside the window.

        Results are yielded strictly in frame order: the N concurrent
        preproc workers may locally shuffle frames, so a reorder buffer
        keyed by frame index restores FIFO here (the reference guarantees
        the same ordering via its single-writer stage graph,
        stream.hpp:82-87)."""
        self._frames_bgr = frames_bgr
        self._low_latency = low_latency
        self._threads = [
            threading.Thread(target=self._reader, args=(frames,), daemon=True),
            threading.Thread(target=self._device_worker, daemon=True),
        ]
        for t in self._threads:
            t.start()
        self._start_preproc()
        reorder: dict[int, FrameResult] = {}
        next_idx = 0
        try:
            while True:
                try:
                    result = self.result_q.pop(timeout_ms=1000)
                except TimeoutError:
                    if not any(t.is_alive() for t in self._threads):
                        break
                    continue
                except EOFError:
                    break
                reorder[result.index] = result
                while next_idx in reorder:
                    self.frames_out += 1
                    yield reorder.pop(next_idx)
                    next_idx += 1
            # Flush any tail still in the buffer (only possible if the
            # stream was cut mid-flight; indices then have gaps).
            for idx in sorted(reorder):
                self.frames_out += 1
                yield reorder.pop(idx)
        finally:
            # Runs on normal EOF and when the caller abandons the generator
            # (GeneratorExit) — stage threads and the native pool are torn
            # down either way.
            self.shutdown()

    def process_video(
        self, source: str, output: str | None = None,
        topology=None, limit: int | None = None,
        alpha: float = 1.0, imshow: bool = False,
        low_latency: bool | None = None,
    ) -> dict:
        """Video file/camera end-to-end (reference: examples/cli.cpp stream
        mode + write_to VideoWriter, src/stream.cpp:114-147). Needs OpenCV
        to read and write video.

        low_latency defaults to True for live sources (camera index or
        imshow display) — the batch top-up window would otherwise add up to
        50 ms/batch waiting for frames a 30 fps camera can't deliver."""
        import cv2

        is_camera = isinstance(source, int) or (
            isinstance(source, str) and source.isdigit()
        )
        if low_latency is None:
            low_latency = is_camera or imshow
        if is_camera and isinstance(source, str):
            source = int(source)
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            raise IOError(f"cannot open video source {source}")
        fps_in = cap.get(cv2.CAP_PROP_FPS) or 30

        # Frames stay BGR (cv2-native) end to end: the preproc workers fold
        # the channel swap into the resize, the writer draws with BGR colors
        # and writes directly — no full-resolution cvtColor in the loop.

        def frames():
            n = 0
            while limit is None or n < limit:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame
                n += 1
            cap.release()

        # Draw + encode runs on its own thread so the (CPU-heavy) render
        # path overlaps device batches instead of serializing the consumer
        # loop (the reference overlaps this via its pipeline stage threads,
        # stream.hpp:260-275). imshow stays on the consumer thread (GUI
        # calls are not thread-safe in cv2).
        import queue as _qm

        writer_q: _qm.Queue | None = None
        writer_thread = None
        writer_error: list[BaseException] = []
        if output is not None:

            def _writer_loop():
                writer = None
                try:
                    while True:
                        item = writer_q.get()
                        if item is None:
                            break
                        frame, humans = item
                        if topology is not None:
                            frame = draw_humans(frame, humans, topology,
                                                alpha=alpha, bgr=True)
                        if writer is None:
                            hh, ww = frame.shape[:2]
                            writer = cv2.VideoWriter(
                                output, cv2.VideoWriter_fourcc(*"mp4v"),
                                fps_in, (ww, hh),
                            )
                            if not writer.isOpened():
                                raise IOError(
                                    f"cannot open video writer for {output}"
                                )
                        writer.write(frame)
                except BaseException as e:  # surface to the consumer loop
                    writer_error.append(e)
                    # Drain so a blocked producer put() never deadlocks.
                    while True:
                        try:
                            if writer_q.get_nowait() is None:
                                break
                        except _qm.Empty:
                            break
                finally:
                    if writer is not None:
                        writer.release()

            writer_q = _qm.Queue(maxsize=256)
            writer_thread = threading.Thread(target=_writer_loop,
                                             daemon=True)
            writer_thread.start()

        def _writer_put(item):
            """put with a liveness check: a dead writer thread must fail the
            run, not block the pipeline forever on a full queue."""
            while True:
                if writer_error:
                    raise RuntimeError(
                        "stream writer thread failed"
                    ) from writer_error[0]
                try:
                    writer_q.put(item, timeout=1.0)
                    return
                except _qm.Full:
                    if not writer_thread.is_alive():
                        raise RuntimeError(
                            "stream writer thread died with a full queue"
                        ) from (writer_error[0] if writer_error else None)

        t0 = time.perf_counter()
        n_humans = 0
        try:
            for result in self.process(frames(), frames_bgr=True,
                                       low_latency=low_latency):
                if writer_q is not None:
                    _writer_put((result.frame, result.humans))
                if imshow:
                    out_frame = result.frame
                    if topology is not None:
                        out_frame = draw_humans(
                            out_frame, result.humans, topology, alpha=alpha,
                            bgr=True,
                        )
                    cv2.imshow("hyperpose-torch", out_frame)
                    cv2.waitKey(1)
                n_humans += len(result.humans)
        finally:
            if writer_q is not None:
                try:
                    _writer_put(None)
                except RuntimeError:
                    pass
                writer_thread.join(timeout=120)
        if writer_error:
            raise RuntimeError(
                f"stream writer failed; {output} is incomplete"
            ) from writer_error[0]
        dt = time.perf_counter() - t0
        return {
            "frames": self.frames_out,
            "seconds": dt,
            "fps": self.frames_out / dt if dt > 0 else 0.0,
            "total_humans": n_humans,
        }

    def add_queue_monitor(self, interval_ms: int = 1000):
        """Periodic queue-size logging (reference: add_queue_monitor,
        src/stream.cpp:149-167). While spans are on (`utils/tracing.py`),
        each line also gives, over the interval just ended, the mean fill
        of the `stream/dispatch` spans and the median and 95th percentile
        of their frames' queue waits."""

        def monitor():
            last_out = -1
            stalled_for = 0
            last_span = 0
            while not self._stop.is_set():
                time.sleep(interval_ms / 1000)
                dispatch = ""
                if tracing.active():
                    recs = tracing.spans(name="stream/dispatch", after_id=last_span)
                    if recs:
                        last_span = max(r["id"] for r in recs)
                        fill = np.mean([r["counts"]["fill"] for r in recs])
                        waits = [w for r in recs for w in r["counts"]["queue_wait_ms"]]
                        p50, p95 = np.percentile(waits, [50, 95]) if waits else (0.0, 0.0)
                        dispatch = (f" dispatch_fill={fill:.2f}"
                                    f" queue_wait_ms p50={p50:.3f} p95={p95:.3f}")
                logger.info(
                    "stream monitor: input=%s resized=%s results=%s "
                    "in=%d out=%d%s",
                    self.input_q.stats()["size"],
                    self.resized_q.stats()["size"],
                    self.result_q.stats()["size"],
                    self.frames_in, self.frames_out, dispatch,
                )
                # Stall watchdog (the reference only logs sizes;
                # src/stream.cpp:149-167): flag a pipeline that stops
                # making progress while work remains queued.
                if self.frames_out == last_out and (
                    self.input_q.stats()["size"]
                    or self.resized_q.stats()["size"]
                ):
                    stalled_for += 1
                    if stalled_for >= 5:
                        dead = [
                            i for i, t in enumerate(self._threads)
                            if not t.is_alive()
                        ]
                        logger.warning(
                            "stream STALLED for %d intervals (dead stage "
                            "threads: %s)", stalled_for, dead,
                        )
                else:
                    stalled_for = 0
                last_out = self.frames_out

        self._monitor = threading.Thread(target=monitor, daemon=True)
        self._monitor.start()

    def shutdown(self):
        """Clean shutdown (reference: ~basic_stream_manager,
        src/stream.cpp:169-183)."""
        self._stop.set()
        for q in (self.input_q, self.resized_q, self.result_q):
            q.close()
        for t in self._threads:
            t.join(timeout=2.0)
        if self._pool is not None:
            # Pool workers exit when their input queue drains to EOF; free
            # joins them (native hp_pool_free).
            self._pool.close()
            self._pool = None
