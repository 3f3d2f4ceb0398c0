"""Live cameras: an open loop into `StreamProcessor.process(frames,
low_latency=True)` on an engine of batch `batch`.

`cameras` cameras each send a frame every 1 / `fps` seconds, each from its
own phase, drawn from the seed; frames are at the engine's input size,
cycled from a pool of `pool` seeded scenes. The stream's reader pulls each
frame when it is due, so a stall makes later frames wait; each frame is
timed from when it was due to when its `FrameResult` reached the caller.
The window holds the frames due in `seconds` after `settle_s` seconds of
traffic; a frame due in the window whose result has not come back
`drain_s` seconds after the window closed counts as failed.

`checked_frames` frames of the window, drawn from the seed, are unique
scenes (a second stream of the same generator), so the step that served
each can be found by its pixels: their delivered skeletons and the maps of
their step are checked (module docstring of `serving`).
"""
from __future__ import annotations

import statistics
import sys
import threading
import time

import numpy as np
import torch

from posebench import program
from posebench.drivers import serving
from posebench.trace import WindowTrace


def schedule(rng, cameras: int, fps: float, until: float) -> np.ndarray:
    """Due times (seconds from the first camera's start) of every frame
    before `until`, in due order, with their camera: [N, 2]. The cameras'
    phases are spread evenly over a frame interval and dealt to the cameras
    in an order drawn from the seed, so every seed offers the same arrivals
    (drawn phases that bunch up or spread out moved the latency's median
    by a third from seed to seed)."""
    phase = rng.permutation(cameras) / (cameras * fps)
    rows = []
    for c in range(cameras):
        t = phase[c] + np.arange(int(np.ceil((until - phase[c]) * fps))) / fps
        rows.append(np.stack([t, np.full_like(t, c)], 1))
    out = np.concatenate(rows)
    return out[np.argsort(out[:, 0], kind="stable")]


class _Ring:
    """The last few steps the stream dispatched: their input batch, the
    network's maps and the packed skeletons, with the time each was
    dispatched (references to the step's own tensors, no copy)."""

    def __init__(self, engine, recorder, size: int = 8):
        self.lock = threading.Lock()
        self.steps, self.size = [], size
        self.recorder = recorder
        inner = engine._step_packed

        def step_packed(images_u8):
            t = time.perf_counter()
            packed = inner(images_u8)
            # On the CPU the stream hands over its staging buffer itself,
            # which it refills; on the card a fresh device copy.
            kept = images_u8.clone() if images_u8.device.type == "cpu" else images_u8
            with self.lock:
                self.steps.append((t, kept, self.recorder.take(), packed))
                del self.steps[:-self.size]
            return packed

        engine._step_packed = step_packed

    def since(self, t: float) -> list:
        with self.lock:
            return [s for s in self.steps if s[0] >= t]


def _delivered(humans) -> list:
    return [(float(h.score), {int(k): (float(p.x), float(p.y), float(p.score))
                              for k, p in h.parts.items()}) for h in humans]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: str | None = None) -> dict:
    p = cell.traffic
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 13])
    marks = serving.Marks(t_start, device)
    flax_w = serving.cell_weights(cell, seed, device)
    marks("weights")
    engine = program.build_engine(cell.config, flax_w, int(p["batch"]), device)
    marks("engine")
    pool = serving.frame_pool(cell, seed, int(p["pool"]))
    probes = serving.frame_pool(cell, seed, int(p["checked_frames"]), stream=1)
    marks("frames")
    engine = serving.control_engine(engine, control, pool[:int(p["batch"])])
    engine.warmup()
    serving.freeze_heap()
    recorder = serving.MapRecorder(engine.model)
    ring = _Ring(engine, recorder)
    stream = program.stream_processor(engine)

    fps, settle = float(p["fps"]), float(p["settle_s"])
    sched = schedule(rng, int(p["cameras"]), fps, settle + seconds)
    in_window = np.nonzero(sched[:, 0] >= settle)[0]
    probe_at = {int(k): j for j, k in enumerate(
        np.sort(rng.choice(in_window, size=min(len(in_window), len(probes)), replace=False)))}
    order = np.resize(rng.permutation(len(pool)), len(sched))
    late = np.zeros(len(sched))
    t_first = [0.0]

    def frames():
        t_first[0] = time.perf_counter() + 0.05
        for k in range(len(sched)):
            due = t_first[0] + sched[k, 0]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[k] = time.perf_counter() - due
            j = probe_at.get(k)
            yield pool[order[k]] if j is None else probes[j]

    arrive = np.full(len(sched), np.nan)
    delivered, snapshots = {}, {}
    slices = WindowTrace(device, seconds, float(p["trace_slice_s"])) if trace else None
    setup_s = None
    for res in stream.process(frames(), low_latency=True):
        now = time.perf_counter()
        arrive[res.index] = now
        j = probe_at.get(res.index)
        if j is not None:
            delivered[j] = _delivered(res.humans)
            snapshots[j] = ring.since(t_first[0] + sched[res.index, 0])
        elapsed = now - (t_first[0] + settle)
        if setup_s is None and elapsed >= 0:
            setup_s = t_first[0] + settle - t_start
            marks("settle")
            marks.report()
        if trace and elapsed >= 0:
            slices.tick(elapsed)
        if elapsed > seconds + float(p["drain_s"]):
            break
    if trace:
        slices.close()
    stream.shutdown()
    recorder.close()

    due = t_first[0] + sched[in_window, 0]
    got = arrive[in_window]
    ok = ~np.isnan(got)
    lat_ms = 1e3 * (got[ok] - due[ok])
    lw = late[in_window]
    print(f"generator late: mean {1e3 * lw.mean():.4f} ms, p99 {1e3 * np.quantile(lw, 0.99):.4f} ms, "
          f"max {1e3 * lw.max():.4f} ms over {len(lw)} frames", file=sys.stderr, flush=True)
    q = statistics.quantiles(lat_ms, n=100, method="inclusive") if len(lat_ms) > 1 else [np.nan] * 99
    missing = int((~ok).sum())
    out = {"attempted": int(len(in_window)), "failed": missing,
           "metrics": {"latency_p50_ms": float(np.median(lat_ms)) if len(lat_ms) else float("nan"),
                       "latency_p95_ms": float(q[94]), "setup_s": setup_s},
           "device": serving.device_info(device)}
    if trace:
        summary = slices.summary()
        done = int(((arrive >= slices.t0) & (arrive <= slices.t1)).sum())
        summary.update(frames_done=done, frames_useful=done, batch=int(p["batch"]),
                       input_hw=tuple(cell.config["input_hw"]),
                       conv_ops_per_frame=serving.conv_ops_per_frame(cell, device))
        out["summary"] = summary
    del engine, stream, ring
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, flax_w, probes, delivered, snapshots, device)
    checks["frames_missing"] = (missing, cell.limits["frames_missing"])
    out["checks"] = checks
    return out


def check(cell, flax_w, probes, delivered: dict, snapshots: dict, device) -> dict:
    """Each checked frame's step found by its pixels; its maps against the
    reference network, its delivered skeletons against the reference decode
    of those maps. A checked frame whose step is not found fails."""
    lim = cell.limits
    rows, found = [], []
    for j in sorted(delivered):
        want = torch.as_tensor(probes[j], device=device)
        hit = None
        for _, images, maps, _packed in snapshots.get(j, []):
            for r in range(images.shape[0]):
                if torch.equal(images[r], want):
                    hit = (maps[0][r], maps[1][r])
        if hit is None:
            print(f"checked frame {j}: its step was not found", file=sys.stderr, flush=True)
            return {"maps_rel_err": (float("nan"), lim["maps_rel_err"]),
                    "skeleton_gap": (1.0, lim["skeleton_gap"])}
        rows.append(hit)
        found.append(j)
    if not found:
        return {"maps_rel_err": (float("nan"), lim["maps_rel_err"]),
                "skeleton_gap": (1.0, lim["skeleton_gap"])}
    conf = torch.stack([r[0] for r in rows])
    paf = torch.stack([r[1] for r in rows])
    ref_conf, ref_paf = serving.reference_maps(cell, flax_w, probes[found], device)
    err = serving.maps_rel_err(conf, paf, ref_conf, ref_paf)
    dec = serving.decode_program_maps(conf, paf, device)
    gaps = [serving.humans_gap(delivered[j], serving.humans_of(dec, i)) for i, j in enumerate(found)]
    people = sum(len(delivered[j]) for j in found)
    print(f"checked {len(found)} frames, {people} people", file=sys.stderr, flush=True)
    return {"maps_rel_err": (err, lim["maps_rel_err"]),
            "skeleton_gap": (float(np.max(gaps)), lim["skeleton_gap"])}
