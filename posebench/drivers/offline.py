"""Batched offline serving: a closed loop on `PoseEngine.infer_batch_device`.

Batches of `batch` frames at the engine's input size, cycled from
`staged_batches` pinned host batches drawn from a pool of `pool` seeded
scenes; each step's skeletons are copied back into pinned host buffers
behind an event, with `in_flight` steps enqueued at once, so the host's
enqueue of the next step overlaps the device's work on this one. `fps`
counts the frames whose skeletons are back on the host by the end of the
window, over the window.

Traffic parameters: batch, in_flight, pool, staged_batches, warmup_steps,
checked_steps (the steps of the window whose output is checked, a uniform
sample drawn from the seed), trace_slice_s.
"""
from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from posebench import program
from posebench.drivers import serving
from posebench.trace import WindowTrace

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


class _Step:
    __slots__ = ("index", "event", "host", "maps", "enqueue_s", "done_t", "skeletons")


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: str | None = None) -> dict:
    p = cell.traffic
    b, cuda = int(p["batch"]), torch.device(device).type == "cuda"
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 11])
    marks = serving.Marks(t_start, device)
    flax_w = serving.cell_weights(cell, seed, device)
    marks("weights")
    engine = program.build_engine(cell.config, flax_w, b, device)
    marks("engine")
    pool = serving.frame_pool(cell, seed, int(p["pool"]))
    marks("frames")
    order = np.resize(rng.permutation(len(pool)), (int(p["staged_batches"]), b))
    staged = [torch.from_numpy(pool[o]) for o in order]
    if cuda:
        staged = [t.pin_memory() for t in staged]
    engine = serving.control_engine(engine, control, pool[order[0]])
    recorder = serving.MapRecorder(engine.model)
    slots = [None] * (int(p["in_flight"]) + 1)

    def enqueue(i: int, keep_maps: bool) -> _Step:
        st = _Step()
        st.index, st.maps, st.done_t, st.skeletons = i, None, None, None
        t0 = time.perf_counter()
        d = engine.infer_batch_device(staged[i % len(staged)])
        st.enqueue_s = time.perf_counter() - t0
        maps = recorder.take()
        st.maps = maps if keep_maps else None
        fields = [getattr(d, f) for f in FIELDS]
        slot = i % len(slots)
        if slots[slot] is None:
            slots[slot] = [torch.empty(f.shape, dtype=f.dtype, pin_memory=cuda) for f in fields]
        st.host = slots[slot]
        for h, f in zip(st.host, fields):
            h.copy_(f, non_blocking=cuda)
        st.event = torch.cuda.Event() if cuda else None
        if cuda:
            st.event.record()
        return st

    def finish(st: _Step, keep: bool) -> None:
        if st.event is not None:
            st.event.synchronize()
        st.done_t = time.perf_counter()
        if keep:
            st.skeletons = {f: h.numpy().copy() for f, h in zip(FIELDS, st.host)}

    pending = collections.deque()
    for i in range(int(p["warmup_steps"])):
        pending.append(enqueue(i, False))
        if len(pending) >= int(p["in_flight"]):
            finish(pending.popleft(), False)
    while pending:
        finish(pending.popleft(), False)
    serving.sync(device)
    marks("warm-up")
    serving.freeze_heap()
    setup_s = time.perf_counter() - t_start
    marks.report()

    n_keep = int(p["checked_steps"])
    kept: dict[int, _Step] = {}
    done: list[_Step] = []
    slice_ = WindowTrace(device, seconds, float(p["trace_slice_s"])) if trace else None
    t0 = time.perf_counter()
    t_end = t0 + seconds
    i, n = int(p["warmup_steps"]), 0
    while True:
        # A uniform sample of the window's steps (reservoir of n_keep).
        keep = n < n_keep or rng.integers(0, n + 1) < n_keep
        if keep and n >= n_keep:
            kept.pop(list(kept)[int(rng.integers(0, n_keep))])
        st = enqueue(i, keep)
        if keep:
            kept[i] = st
        pending.append(st)
        i, n = i + 1, n + 1
        if len(pending) >= int(p["in_flight"]):
            old = pending.popleft()
            finish(old, old.index in kept)
            done.append(old)
        now = time.perf_counter()
        if trace:
            slice_.tick(now - t0)
        if now >= t_end:
            break
    if trace:
        slice_.close()
    while pending:
        old = pending.popleft()
        finish(old, old.index in kept)
        done.append(old)
    recorder.close()

    frames_done = sum(b for st in done if st.done_t <= t_end)
    out = {"attempted": n * b, "failed": 0,
           "metrics": {"fps": frames_done / seconds, "setup_s": setup_s},
           "device": serving.device_info(device)}
    if trace:
        summary = slice_.summary()
        in_slice = [st for st in done if slice_.t0 <= st.done_t <= slice_.t1]
        enq = [st.enqueue_s for st in done if slice_.t0 <= st.done_t <= slice_.t1]
        summary.update(
            frames_done=len(in_slice) * b, frames_useful=len(in_slice) * b,
            host_enqueue_s=enq, conv_ops_per_frame=serving.conv_ops_per_frame(cell, device), batch=b,
            input_hw=tuple(cell.config["input_hw"]))
        out["summary"] = summary
    del engine, staged
    if cuda:
        torch.cuda.empty_cache()
    out["checks"] = check(cell, flax_w, pool, order, kept, device)
    return out


def check(cell, flax_w, pool, order, kept: dict, device) -> dict:
    """The output check of the kept steps (module docstring of `serving`)."""
    steps = sorted(kept.values(), key=lambda st: st.index)
    frames = np.concatenate([pool[order[st.index % len(order)]] for st in steps])
    conf = torch.cat([st.maps[0] for st in steps])
    paf = torch.cat([st.maps[1] for st in steps])
    ref_conf, ref_paf = serving.reference_maps(cell, flax_w, frames, device)
    err = serving.maps_rel_err(conf, paf, ref_conf, ref_paf)
    dec = serving.decode_program_maps(conf, paf, device)
    got = {f: np.concatenate([st.skeletons[f] for st in steps]) for f in FIELDS}
    gaps = [serving.humans_gap(serving.humans_of(got, j), serving.humans_of(dec, j))
            for j in range(len(frames))]
    people = sum(len(serving.humans_of(got, j)) for j in range(len(frames)))
    print(f"checked {len(frames)} frames of {len(steps)} steps, {people} people",
          file=sys.stderr, flush=True)
    lim = cell.limits
    return {"maps_rel_err": (err, lim["maps_rel_err"]),
            "skeleton_gap": (float(np.max(gaps)), lim["skeleton_gap"])}
