#!/usr/bin/env python3
"""Eager against loaded serving steps of the port, on one NVIDIA GPU.

    python3 ab_loaded_step.py [--rounds N]

Builds two of the engines of `chip_smoke.py`'s `facade_cli` phase through the
CLI's `build_engine` at 368x432, batch 8, bf16: the flagship (TinyVGG
Lightweight-OpenPose on its checkpoint) and the default Lightweight-OpenPose
(MobilenetDilated, seeded weights) quantized to int8 on the batch
(`quantize_engine`). It saves each (`PoseEngine.save`) and times, N rounds in
alternating order (eager then loaded, loaded then eager, ...):

- the eager step (`PoseEngine.infer_batch_device`) and the program loaded in
  this process (`PoseEngine.load_executable`): host-clock median and p80 of
  50 synced calls each (`chip_smoke.wall_ms`);
- the program loaded in a fresh process (`chip_smoke.py --loaded`), once a
  round.

Then where each one's host time goes: `cProfile` of 20 calls, own seconds a
call summed by where the function lives (`where`); and the host cost of one
operator call: `int8_quantize` on the int8 step's smallest quantize input,
called as an eager step calls it (the wrapper's body) and as a loaded
program does (`torch.ops.hyperpose.int8_quantize`), microseconds a call over
2000 calls synced at the end.

Prints one JSON line per engine. Imports no JAX.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def where(filename: str, name: str) -> str:
    """The group of a profiled function, by the file it lives in."""
    if filename == "~":
        return "C calls (ATen ops, tensor methods)"
    for part, group in (("hyperpose_torch/ops/kernels", "kernel wrappers"),
                        ("hyperpose_torch", "port (models, decode, engine)"),
                        ("torch/_ops.py", "operator calls (torch._ops)"),
                        ("eval_with_key", "program forward (generated)"),
                        ("torch/fx", "torch.fx"),
                        ("torch/export", "torch.export"),
                        ("_pytree", "pytree"),
                        ("torch/nn/modules", "nn.Module calls")):
        if part in filename:
            return group
    return "other Python"


def host_profile(fn, calls: int = 20) -> dict:
    """Own seconds a call by group, and the eight costliest functions."""
    import torch

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    groups, funcs = {}, []
    for (filename, line, name), (_, ncalls, tottime, _, _) in stats.items():
        g = where(filename, name)
        groups[g] = groups.get(g, 0.0) + 1e3 * tottime / calls
        funcs.append((1e3 * tottime / calls, ncalls / calls,
                      f"{os.path.basename(filename)}:{line}({name})"))
    funcs.sort(reverse=True)
    return {"ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top": [{"ms": ms, "calls": n, "fn": f} for ms, n, f in funcs[:8]]}


def dispatch_us(x, inv_s: float, cp: int, calls: int = 2000) -> dict:
    """Microseconds a call of `int8_quantize` on x: the wrapper's body (an
    eager call) and the registered operator (a loaded program's call)."""
    import torch
    from hyperpose_torch.ops.kernels import int8_gemm

    out = {}
    for key, call in (("direct", lambda: int8_gemm._int8_quantize(x, inv_s, cp, None)),
                      ("operator", lambda: torch.ops.hyperpose.int8_quantize(
                          x, inv_s, cp, None))):
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        out[key] = 1e6 * (time.perf_counter() - t0) / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4, help="rounds (default 4)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from hyperpose_torch import cli, quant
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.runtime.engine import PoseEngine

    if not torch.cuda.is_available():
        sys.exit("ab_loaded_step: torch.cuda.is_available() is false: this needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    frames = cs._frames(cs.seeded_rng())
    batch = torch.from_numpy(np.stack([resize_bilinear(f, cs.INPUT_HW) for f in frames])).cuda()
    size = dict(h=cs.INPUT_HW[0], w=cs.INPUT_HW[1], max_batch_size=cs.BATCH, keep_ratio=False,
                input_format="rgb8", device="cuda")
    tmp = tempfile.mkdtemp(prefix="hp_loaded_")
    for key, model, backbone, weights, int8 in (
            ("flagship_bf16", "LightweightOpenpose", "Vggtiny",
             os.path.join(HERE, "weights", "flagship_tinyvgg.npz"), False),
            ("int8_lw", "LightweightOpenpose", "Default", None, True)):
        eng, _ = cli.build_engine(argparse.Namespace(model=model, backbone=backbone,
                                                     weights=weights, **size))
        if int8:
            eng = quant.quantize_engine(eng, [batch])
        eng.warmup()
        t0 = time.perf_counter()
        exe = eng.save(os.path.join(tmp, key))["executable"]
        save_s = time.perf_counter() - t0
        eager = eng.infer_batch_device(batch)
        io = os.path.join(tmp, f"{key}_io.npz")
        np.savez(io, batch=batch.cpu().numpy(),
                 **{f: getattr(eager, f).cpu().numpy() for f in cs.FIELDS})
        loaded = PoseEngine.load_executable(exe)
        for f, g in zip(cs.FIELDS, loaded(batch)):
            cs.check(torch.equal(g, getattr(eager, f)), f"{key}: loaded {f} differs")
        steps = {"eager": lambda: eng.infer_batch_device(batch), "loaded": lambda: loaded(batch)}
        rounds = []
        for r in range(args.rounds):
            row = {}
            for side in (("eager", "loaded") if r % 2 == 0 else ("loaded", "eager")):
                row[side] = cs.wall_ms(steps[side])
            proc = subprocess.run([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                                   "--loaded", exe, io], capture_output=True, text=True,
                                  timeout=600, cwd=HERE)
            cs.check(proc.returncode == 0, f"{key}: fresh process failed:\n{proc.stderr[-3000:]}")
            fresh = json.loads(proc.stdout.strip().splitlines()[-1])
            row["fresh"] = (fresh["step_ms"], fresh["step_p80_ms"])
            rounds.append(row)
        out = {"engine": key, "card": card, "save_s": save_s, "rounds": rounds}
        out["host_profile"] = {side: host_profile(fn) for side, fn in steps.items()}
        if int8:
            with torch.inference_mode():
                seen = cs._record_int8_inputs(eng.model, lambda: eng.model(
                    batch.to(torch.bfloat16) / 255.0))
                conv, x = min(((c, x) for c, x in seen if not c.depthwise),
                              key=lambda cx: cx[1].numel())
                out["dispatch_us"] = {"input": list(x.shape),
                                      **dispatch_us(x, float(conv.inv_s),
                                                    int(conv.w_taps.shape[-1]))}
        print(json.dumps(out), flush=True)
        del eng, loaded, steps
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
