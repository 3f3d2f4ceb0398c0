"""What the serving drivers share: the cell's engine and frames, the record
of the network's outputs on the timed path, and the output check.

The check compares what the timed path produced in two stages, because the
decode of bf16 maps and of float32 maps may differ by a part near a
threshold however sound both are:
  maps_rel_err   the last stage's confidence and PAF maps of the checked
                 frames against the plain float32 reference network on the
                 same frames (relative L2 over all of them);
  skeleton_gap   the skeletons the caller received for that frame against
                 the plain reference decode of the program's own maps
                 (1 where the humans or their parts differ, else the largest
                 difference of a coordinate, part score or human score).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from posebench import scenes, weights
from posebench.reference import decode as ref_decode
from posebench.reference.common import Arith, conv_operations, exact_float32, to_torch


class Marks:
    """Set-up seconds by stage, printed on standard error."""

    def __init__(self, t_start: float, device):
        self.last, self.parts = t_start, []
        self("imports")
        if torch.device(device).type == "cuda":
            torch.zeros(1, device=device)
            self("cuda")

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{what} {now - self.last:.3f}")
        self.last = now

    def report(self) -> None:
        print("set-up s: " + ", ".join(self.parts), file=sys.stderr, flush=True)


def freeze_heap() -> None:
    """Collect, then move every object set-up made to the interpreter's
    permanent generation, so that a full collection in the window scans
    only what the window makes: on the card a full collection of set-up's
    heap took 125-156 ms, a stall whose timing, not the program's work,
    decided a live cell's tail."""
    gc.collect()
    gc.freeze()


def device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cell_weights(cell, seed: int, device) -> dict:
    ref = cell.reference()
    return weights.make_weights(cell.config["weights"], ref.param_shapes(), seed, device, str(cell.root))


def conv_ops_per_frame(cell, device) -> int:
    """The conv operations of one frame, counted on the reference network."""
    ref = cell.reference()
    h, w = cell.config["input_hw"]
    return conv_operations(ref.forward, ref.param_shapes(), (1, h, w, 3), device)


def shift_one_answer(engine):
    """A fault for the output check's readings: the engine's step moves the
    first frame's skeletons one input pixel to the right."""
    step = engine._step

    def shifted(images):
        d = step(images)
        shift = torch.zeros(d.coords.shape, device=d.coords.device)
        shift[0, ..., 0] = 1.0 / engine.input_hw[1]
        d.coords = d.coords + shift
        return d

    engine._step = shifted
    return engine


def control_engine(engine, control: str | None, calibration_u8):
    """The engine a serving run times: the program's own, its int8 path
    (`control` "int8", the configuration's control), or with one answer
    shifted (`control` "shifted_answer", a fault)."""
    if control is None:
        return engine
    if control == "int8":
        from posebench import program

        return program.int8_engine(engine, calibration_u8)
    if control == "shifted_answer":
        return shift_one_answer(engine)
    raise ValueError(f"unknown control {control!r}")


class MapRecorder:
    """A forward hook on the port's network that keeps the last call's
    final-stage maps (references to the tensors the step made, no copy)."""

    def __init__(self, module):
        self.last = None
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, _module, _args, out):
        self.last = (out["conf_map"], out["paf_map"])

    def take(self):
        got, self.last = self.last, None
        return got

    def close(self):
        self.handle.remove()


def reference_maps(cell, flax_weights: dict, frames_u8: np.ndarray, device, arith=None,
                   block: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain reference network's final conf and PAF maps [N, h, w, C],
    float32 on `device`, in blocks of `block` frames."""
    ref = cell.reference()
    w = to_torch(flax_weights, device)
    confs, pafs = [], []
    with torch.no_grad(), exact_float32():
        for i in range(0, len(frames_u8), block):
            x = torch.as_tensor(frames_u8[i:i + block], device=device).to(torch.float32) / 255.0
            out = ref.forward(w, x, arith or Arith())
            confs.append(out["conf_map"].float())
            pafs.append(out["paf_map"].float())
    return torch.cat(confs), torch.cat(pafs)


def maps_rel_err(conf, paf, ref_conf, ref_paf) -> float:
    """||program - reference|| / ||reference|| over the final conf and PAF
    maps of all the checked frames together. (The largest over single frames
    swung from seed to seed by twice, with the frame that read it.)"""
    got = torch.cat([conf.float().flatten(), paf.float().flatten()])
    want = torch.cat([ref_conf.flatten(), ref_paf.flatten()]).to(got.device)
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def decode_program_maps(conf, paf, device) -> dict:
    """The plain reference decode of maps the program made."""
    with torch.no_grad(), exact_float32():
        return ref_decode.paf_decode(conf.to(device).float(), paf.to(device).float())


def humans_of(sk: dict, b: int) -> list:
    """Frame `b` of decoded fields as [(score, {part: (x, y, score)})], valid
    humans in slot order."""
    out = []
    for h in np.nonzero(sk["valid"][b])[0]:
        parts = {int(p): (float(sk["coords"][b, h, p, 0]), float(sk["coords"][b, h, p, 1]),
                          float(sk["part_scores"][b, h, p]))
                 for p in np.nonzero(sk["part_valid"][b, h])[0]}
        out.append((float(sk["scores"][b, h]), parts))
    return out


def humans_gap(got: list, want: list) -> float:
    """1.0 where the humans or their parts differ; else the largest
    difference of a coordinate (image units), a part score or a human score
    (relative to max(1, |score|)). NaN stays NaN, and fails every limit."""
    if len(got) != len(want):
        return 1.0
    diffs = [0.0]
    for (gs, gp), (ws, wp) in zip(got, want):
        if set(gp) != set(wp):
            return 1.0
        diffs.append(abs(gs - ws) / max(1.0, abs(ws)))
        for p, (x, y, s) in wp.items():
            gx, gy, gsc = gp[p]
            diffs += [abs(gx - x), abs(gy - y), abs(gsc - s)]
    return float(np.max(diffs))


def frame_pool(cell, seed: int, n: int, stream: int = 0) -> np.ndarray:
    return scenes.scene_pool(seed, n, tuple(cell.config["input_hw"]), stream)
