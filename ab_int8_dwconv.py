#!/usr/bin/env python3
"""A/B timing of the port's int8 depthwise convs and serving steps across checkouts, on one NVIDIA GPU.

    python3 ab_int8_dwconv.py [--rounds N] DIR [DIR ...]

Each DIR is the root of a checkout of the port (a directory that holds
`hyperpose_torch/`; `.` is this one). Each DIR runs in a process of its own,
which imports that checkout's `hyperpose_torch` (and builds its kernels into
DIR/build/) and, on the int8 steps of three of `chip_smoke.py`'s served models
(LW-MobilenetDilated, MobileNet-Thin, MobileNet-Small: seeded random weights,
bf16 activations, `quantize_engine` calibrated on the batch, 368x432, batch 8)
and on the bf16 MobilenetV1 and MobilenetV2 backbones, times:

- every depthwise `Int8Conv2d` forward, as each checkout runs it, per set and
  per distinct shape: device ms of one CUDA graph of the convs, beside the
  fused path's bound (`chip_smoke._dw_work`);
- each of the three int8 steps (`PoseEngine.infer_batch_device`), and the
  flagship's bf16 step (TinyVGG Lightweight-OpenPose on its checkpoint, the
  plain stem): host-clock median and p80 of 50 synced calls, and its
  network's device ms and kernels from a trace of 5 calls.

The DIRs run in the order given, then in reverse, N rounds in all (A B, B A,
A B, ...), so that a drift of the host's speed over the call shows as a
spread between rounds rather than as a difference between checkouts. Each
process prints one JSON line; the last line is the medians over the rounds
per DIR. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import hyperpose_torch  # noqa: F401  (this checkout's, before chip_smoke's path)

    assert os.path.dirname(os.path.abspath(hyperpose_torch.__file__)) == os.path.join(
        tree, "hyperpose_torch"), hyperpose_torch.__file__
    import numpy as np
    import torch
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.quant import quantize_engine

    sys.path.insert(1, HERE)
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    frames = cs._frames(cs.seeded_rng())
    batch = torch.from_numpy(np.stack([resize_bilinear(f, cs.INPUT_HW) for f in frames])).cuda()
    from hyperpose_torch.runtime.engine import PoseEngine

    sets, steps = {}, {}
    flagship = PoseEngine(*cs._stem_model("plain", torch.bfloat16), max_batch_size=cs.BATCH,
                          device="cuda")
    for name, make in (
            ("flagship_bf16", lambda: flagship),
            *((spec.name, lambda spec=spec: quantize_engine(
                spec.engine(cs.served_weights(spec), torch.bfloat16), [batch]))
              for spec in (cs.LW_MOBILENET, cs.MBTHIN_OPENPOSE, cs.MBSMALL_OPENPOSE))):
        eng = make()
        eng.warmup()

        def network():
            return eng.model(batch.to(torch.bfloat16) / 255.0)

        with torch.inference_mode():
            if name != "flagship_bf16":
                sets[name] = [(c, x) for c, x in cs._record_int8_inputs(eng.model, network)
                              if c.depthwise]
            step_ms, step_p80 = cs.wall_ms(lambda: eng.infer_batch_device(batch))
            busy, kernels = cs.device_busy(network)
        steps[name] = {"step_ms": step_ms, "step_p80_ms": step_p80,
                       "network_device_ms": busy, "network_kernels": kernels}
        del eng
        torch.cuda.empty_cache()
    del flagship
    for name in ("MobilenetV1", "MobilenetV2"):
        sets[name] = [(c, x) for _, c, x in cs.backbone_dw_convs(name, frames)]
    out = {"tree": tree, "card": torch.cuda.get_device_name(0), "steps": steps, "sets": {}}
    with torch.inference_mode():
        for name, convs in sets.items():
            groups = {}
            for c, x in convs:
                key = (*x.shape[2:], x.shape[1], c.kernel_size[0], c.stride[0], c.padding[0],
                       c.dilation[0])
                groups.setdefault(key, []).append((c, x))
            out["sets"][name] = {
                "convs": len(convs),
                "ms": cs.device_ms(lambda: [c(x) for c, x in convs], reps=2, replays=3),
                **cs._dw_work(convs),
                "shapes": [{"h_w_c_k_stride_pad_dil": key, "convs": len(g),
                            "ms": cs.device_ms(lambda: [c(x) for c, x in g], reps=2,
                                               replays=3), **cs._dw_work(g)}
                           for key, g in groups.items()]}
    return out


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1, help="rounds over the DIRs (default 1)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("dirs", nargs="*")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker))), flush=True)
        return
    if not args.dirs:
        ap.error("give at least one checkout")
    runs = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", d],
                                  stdout=subprocess.PIPE, text=True)
            if proc.returncode != 0:
                sys.exit(f"ab_int8_dwconv: {d} failed (exit {proc.returncode})")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["round"] = r
            print(json.dumps(res), flush=True)
            runs[d].append(res)
    summary = {}
    for d, res in runs.items():
        first = res[0]
        summary[d] = {
            "steps": {m: {k: statistics.median(x["steps"][m][k] for x in res)
                          for k in first["steps"][m]} | {
                          "step_ms_by_round": [x["steps"][m]["step_ms"] for x in res]}
                      for m in first["steps"]},
            "sets_ms": {s: statistics.median(x["sets"][s]["ms"] for x in res)
                        for s in first["sets"]}}
    print(json.dumps({"medians": summary}), flush=True)


if __name__ == "__main__":
    main()
