"""Training: `Trainer.step` of the port in a closed loop, fed a pool of
`batches` batches of `batch` seeded scenes in the form `TrainPipeline`
yields (uint8 images, keypoints in the model's 19-row layout with the neck
as the shoulders' midpoint, their visibility, the don't-care mask at the
output size, zero on crowds, and the people's boxes), `in_flight` steps
enqueued at once. `train_images_per_s` counts the images of the steps
finished by the end of the window, over the window.

Set-up builds one trainer from the configuration's weights and drives it
through its first `checked_steps` steps, through the same call and feed as
the window, on batches that all differ; the same trainer then runs the
window, and after its close `checked_steps` more steps from the state the
window left. Each stage ("first_steps" from the weights and a fresh Adam,
"after_window" from the trainer's parameters and Adam's moments and count
at the close) is held to the plain reference's steps from the same state on
the same batches, by those of these numbers that the cell's limits name
(the others are printed as readings; PERF.md says why each is or is not
compared):
  maps_rel_err   the stage's first train-mode forward, the final confidence
                 and PAF maps of the batch against the reference's (relative
                 L2 over the batch; a batch the step left images out of
                 reads 1);
  grad_rel_err   the stage's first gradient as the optimizer got it (the
                 change of Adam's first moment over 1 - b1) against the
                 reference's: the relative L2 of the difference at the
                 median leaf, of those the update_gap rule keeps;
  update_gap     at the median leaf, the gap between the norms of the
                 parameters' change over the stage and the reference's,
                 over the larger of the reference leaf's norm and the median
                 leaf's, leaving out leaves whose reference gradient is
                 under a thousandth of the median leaf's (they move by
                 round-off); a step that leaves its state unchanged reads 1;
  loss_gap       the largest relative gap of a step's loss over the stage.
Besides, the gradient by the norms of the worst and the median leaf and
by the relative difference over all leaves, and the change by the worst
leaf with the share of its entries that moved the other way, are printed
beside them.
"""
from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np
import torch

from posebench import program, scenes, weights
from posebench.drivers import serving
from posebench.reference.common import Arith, to_torch
from posebench.reference import train as ref_train
from posebench.trace import WindowTrace

MISSING = -1000.0
# Model row -> COCO17 joint; -1 is the neck, the midpoint of the shoulders.
OPENPOSE_FROM_COCO17 = (0, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3)


def train_batches(seed: int, n: int, batch: int, hw, max_people: int = 8) -> list:
    """`n` batches of seeded scenes in `TrainPipeline`'s form."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 2])
    h, w = hw
    sizes = iter(scenes.scene_sizes(rng, n * batch))
    out = []
    for _ in range(n):
        imgs = np.zeros((batch, h, w, 3), np.uint8)
        kpts = np.full((batch, max_people, 19, 2), MISSING, np.float32)
        valid = np.zeros((batch, max_people, 19), bool)
        mask = np.ones((batch, h // 8, w // 8, 1), np.float32)
        bbxs = np.zeros((batch, max_people, 4), np.float32)
        for i in range(batch):
            people, crowds = [], []
            imgs[i] = scenes.render_scene(rng, hw, *next(sizes), people=people, crowds=crowds)
            for m, j in enumerate(people[:max_people]):
                seen = (j[:, 0] >= 0) & (j[:, 0] < w) & (j[:, 1] >= 0) & (j[:, 1] < h)
                for row, src in enumerate(OPENPOSE_FROM_COCO17):
                    if src >= 0 and seen[src]:
                        kpts[i, m, row], valid[i, m, row] = j[src], True
                    elif src == -1 and seen[5] and seen[6]:
                        kpts[i, m, row], valid[i, m, row] = (j[5] + j[6]) / 2.0, True
                if valid[i, m].any():
                    lo, hi = kpts[i, m][valid[i, m]].min(0), kpts[i, m][valid[i, m]].max(0)
                    bbxs[i, m] = (lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1])
            for x0, y0, cw, ch in crowds:
                mask[i, y0 // 8:(y0 + ch) // 8 + 1, x0 // 8:(x0 + cw) // 8 + 1] = 0.0
        out.append({"images": imgs, "kpts": kpts, "valid": valid, "mask": mask, "bbxs": bbxs})
    return out


def _norm_gaps(got: dict, want: dict, keys) -> dict:
    """Per leaf: |norm(got) - norm(want)| over the larger of norm(want) and
    the median leaf's norm(want). NaN stays NaN."""
    gn = {k: float(np.linalg.norm(np.asarray(got[k], np.float64))) for k in keys}
    wn = {k: float(np.linalg.norm(np.asarray(want[k], np.float64))) for k in keys}
    med = float(np.median(list(wn.values())))
    return {k: abs(gn[k] - wn[k]) / max(wn[k], med) for k in keys}


def _worst(gaps: dict) -> tuple:
    key = max(gaps, key=lambda k: gaps[k] if np.isfinite(gaps[k]) else np.inf)
    return float(np.max(list(gaps.values()))), key


def _flax(key: str, t: torch.Tensor) -> np.ndarray:
    """A reference tensor in the flax layout the program's leaves come in
    (conv kernels HWIO)."""
    t = t.detach().cpu()
    return (t.permute(2, 3, 1, 0) if key.endswith("kernel") and t.ndim == 4 else t).numpy()


def _as_program(steps: dict) -> dict:
    """Reference steps (the control's) in the form of the program's."""
    return {"losses": steps["losses"], "maps": steps["maps"], **{
        k: {key: _flax(key, v) for key, v in steps[k].items()} for k in ("grads", "start", "end")}}


def compare(prog: dict, ref: dict, stage: str = "") -> dict:
    """The compared numbers of the module docstring from the program's
    (losses, maps, grads, start, end) and the reference's steps of one
    stage; the other readings go to standard error."""
    g_ref = {k: _flax(k, v) for k, v in ref["grads"].items()}
    norms = {k: float(np.linalg.norm(v)) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    moving = [k for k in g_ref if norms[k] >= 1e-3 * med]
    d_ref = {k: _flax(k, ref["end"][k] - ref["start"][k]) for k in g_ref}
    d_prog = {k: np.asarray(prog["end"][k], np.float64) - np.asarray(prog["start"][k], np.float64)
              for k in g_ref}
    flat_p = np.concatenate([np.asarray(prog["grads"][k], np.float64).ravel() for k in g_ref])
    flat_r = np.concatenate([g_ref[k].astype(np.float64).ravel() for k in g_ref])
    grad_all = float(np.linalg.norm(flat_p - flat_r) / np.linalg.norm(flat_r))
    conf, paf = prog["maps"]
    ref_conf, ref_paf = ref["maps"]
    if conf.shape[0] < ref_conf.shape[0]:
        maps_err = 1.0
    else:
        maps_err = serving.maps_rel_err(conf, paf, ref_conf, ref_paf)
    change_gaps = _norm_gaps(d_prog, d_ref, moving)
    update_worst, update_leaf = _worst(change_gaps)
    update_gap = float(np.median(list(change_gaps.values())))
    moved = d_ref[update_leaf] != 0
    flips = float(np.mean(np.sign(d_prog[update_leaf][moved]) != np.sign(d_ref[update_leaf][moved])))
    grad_gaps = _norm_gaps(prog["grads"], g_ref, list(g_ref))
    grad_gap, grad_leaf = _worst(grad_gaps)
    leaf_diff = [float(np.linalg.norm(np.asarray(prog["grads"][k], np.float64) - g_ref[k])
                       / max(np.linalg.norm(g_ref[k]), 1e-30)) for k in moving]
    grad_err = float(np.median(leaf_diff))
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    print(f"readings {stage}: loss gap by step {losses!r} (program {prog['losses']!r}, reference "
          f"{ref['losses']!r}); the gradient's norms by the worst leaf {grad_gap!r} "
          f"({grad_leaf}), by the median leaf {float(np.median(list(grad_gaps.values())))!r}, "
          f"relative difference over all leaves {grad_all!r}; "
          f"the change's norms by the worst leaf {update_worst!r} ({update_leaf}, "
          f"{int(moved.sum())} entries, {flips!r} of them moved the other way)",
          file=sys.stderr, flush=True)
    loss_gap = max(losses) if losses else float("nan")
    if len(losses) != len(ref["losses"]):
        update_gap = loss_gap = float("nan")
    return {"maps_rel_err": maps_err, "grad_rel_err": grad_err, "update_gap": update_gap,
            "loss_gap": loss_gap}


def reference_steps(cell, flax_w, state, batches, device, arith=None, loss_rows=None) -> dict:
    """The plain reference's steps on `batches` from `state` (the program's
    at the window's close, or None: the configuration's weights and zero
    moments), the configuration's statistics beside its parameters."""
    c, t = cell.config, cell.config["train"]
    h, w = c["input_hw"]
    start = dict(flax_w)
    moments, count = None, 0
    if state is not None:
        start.update(state["params"])
        moments = {k: to_torch(state[k], device) for k in ("mu", "nu")}
        count = state["count"]
    return ref_train.train_steps(cell.reference(), to_torch(start, device), batches,
                                 (h, w), (h // 8, w // 8), float(t["lr"]),
                                 float(t["weight_decay"]), arith, device, moments, count, loss_rows)


def program_steps(trainer, batches: list, first: int, n: int) -> dict:
    """`n` steps of the trainer on the pool's batches from `first` on, with
    what the check compares: the losses, the first step's maps and gradient
    (from the change of Adam's first moment), the parameters before and
    after, and the trainer's state before them."""
    state = program.trainer_state(trainer)
    recorder = serving.MapRecorder(trainer.model)
    out = {"state": state, "start": state["params"], "losses": []}
    for j in range(n):
        m = trainer.step(batches[(first + j) % len(batches)])
        out["losses"].append(float(m["total_loss"]))
        if j == 0:
            mu = program.trainer_state(trainer)["mu"]
            out["grads"] = {k: (mu[k].astype(np.float64) - ref_train.B1 * state["mu"][k])
                            / (1.0 - ref_train.B1) for k in mu}
            out["maps"] = tuple(t.detach().float() for t in recorder.take())
    recorder.close()
    out["end"] = program.trainer_state(trainer)["params"]
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: str | None = None) -> dict:
    p, c = cell.traffic, cell.config
    b, n_check = int(p["batch"]), int(p["checked_steps"])
    cuda = torch.device(device).type == "cuda"
    marks = serving.Marks(t_start, device)
    flax_w = weights.make_weights(c["weights"], cell.reference().param_shapes(), seed,
                                  device, str(cell.root))
    batches = train_batches(seed, int(p["batches"]), b, tuple(c["input_hw"]))
    marks("weights, batches")
    model_dir = os.path.join(str(cell.root), "build", "posebench", "train")
    trainer = program.build_trainer(c, flax_w, b, device, model_dir)
    marks("trainer")
    first = program_steps(trainer, batches, 0, n_check)
    serving.sync(device)
    marks("first steps")
    serving.freeze_heap()
    setup_s = time.perf_counter() - t_start
    marks.report()

    in_flight = int(p["in_flight"])
    slices = WindowTrace(device, seconds, float(p["trace_slice_s"])) if trace else None
    pending, done = collections.deque(), []
    t0 = time.perf_counter()
    t_end, i, n = t0 + seconds, n_check, 0
    while True:
        trainer.step(batches[i % len(batches)])
        ev = torch.cuda.Event() if cuda else None
        if cuda:
            ev.record()
        pending.append(ev)
        i, n = i + 1, n + 1
        if len(pending) >= in_flight:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
            done.append(time.perf_counter())
        now = time.perf_counter()
        if trace:
            slices.tick(now - t0)
        if now >= t_end:
            break
    if trace:
        slices.close()
    while pending:
        ev = pending.popleft()
        if ev is not None:
            ev.synchronize()
        done.append(time.perf_counter())
    done = np.asarray(done)
    after = program_steps(trainer, batches, i, n_check)
    out = {"attempted": n, "failed": 0,
           "metrics": {"train_images_per_s": float((done <= t_end).sum()) * b / seconds,
                       "setup_s": setup_s},
           "device": serving.device_info(device)}
    if trace:
        summary = slices.summary()
        steps = int(((done >= slices.t0) & (done <= slices.t1)).sum())
        summary.update(frames_done=steps * b, frames_useful=steps * b, batch=b,
                       input_hw=tuple(c["input_hw"]),
                       conv_ops_per_frame=serving.conv_ops_per_frame(cell, device))
        out["summary"] = summary
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    stages = {"first_steps": (first, None, 0), "after_window": (after, after["state"], i)}
    out["checks"] = check(cell, flax_w, batches, stages, n_check, device, control)
    return out


def check(cell, flax_w, batches, stages: dict, n_check: int, device, control) -> dict:
    """Each stage's compared numbers, each with its limit. With `control`
    the reference takes the stage's steps in the program's place from the
    same state: its conv operands rounded to `control` (float8_e4m3fn, the
    precision below the configuration's bfloat16), or, with "half_batch",
    its loss and gradient over the first half of each batch (a fault)."""
    checks = {}
    t0 = time.perf_counter()
    for name, (prog, state, first) in stages.items():
        fed = [batches[(first + j) % len(batches)] for j in range(n_check)]
        ref = reference_steps(cell, flax_w, state, fed, device)
        if control == "half_batch":
            prog = _as_program(reference_steps(cell, flax_w, state, fed, device,
                                               loss_rows=max(1, len(fed[0]["images"]) // 2)))
        elif control is not None:
            prog = _as_program(reference_steps(cell, flax_w, state, fed, device,
                                               Arith(round_to=getattr(torch, control))))
        print(f"losses {name}: program {prog['losses']}, reference {ref['losses']}",
              file=sys.stderr, flush=True)
        for k, v in compare(prog, ref, name).items():
            if f"{name}.{k}" in cell.limits:
                checks[f"{name}.{k}"] = (v, cell.limits[f"{name}.{k}"])
            else:
                print(f"reading {name}.{k}: {v!r} (not compared)", file=sys.stderr, flush=True)
    print(f"reference s: {time.perf_counter() - t0:.3f}", file=sys.stderr, flush=True)
    return checks
