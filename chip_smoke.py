#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`hyperpose_torch/`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from `hyperpose_torch/csrc/`, holds each against
its plain PyTorch version at the flagship shapes and times both, decodes
painted two-person maps on the card and on the CPU, then drives the serving
path (`PoseEngine` on the flagship TinyVGG Lightweight-OpenPose weights at
368x432, batch 8) and checks that it went through both kernels and finds the
two people of the committed synthetic frame. Every phase prints one line;
any failure exits non-zero before the result line. The last line is
`{"ok": true, "device": {...}}`. It needs a CUDA device and exits non-zero
without one; it imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
FEAT_HW = (46, 54)           # 368x432 input / 8
BATCH = 8


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def call_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean time of one eager call in steady state, as its caller sees it:
    CUDA events around `iters` back-to-back calls. For a small kernel this
    is the host's launch cost, not the device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Device time of one call: `reps` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events, so no host launch cost
    enters. Inputs stay in L2 between calls, as on the main path."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def wall_ms(fn, iters: int = 50, warmup: int = 3) -> tuple[float, float]:
    """(median, 80th percentile) host-clock ms of one call that ends in a
    device synchronize, over `iters` calls (at 50, ten lie beyond p80)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), float(np.percentile(times, 80))


def device_busy(fn, iters: int = 5) -> tuple[float, float]:
    """(device ms, kernels launched) per call, summed over every kernel in a
    torch.profiler trace of `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    return total_us / 1e3 / iters, sum(e.count for e in kernels) / iters


# -- a numpy copy of tests/test_paf_decode.py:11-56 ----------------------------

def make_synthetic_maps(people, limbs, h=46, w=54, n_parts=18, n_limbs=19,
                        sigma=1.5):
    """Paint Gaussian blobs at keypoints and unit vectors along limbs."""
    conf = np.zeros((h, w, n_parts + 1), np.float32)
    paf = np.zeros((h, w, 2 * n_limbs), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for person in people:
        for p, (x, y) in person.items():
            blob = np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / (2 * sigma**2))
            conf[:, :, p] = np.maximum(conf[:, :, p], blob)
        for l, (a, b) in enumerate(limbs):
            a, b = int(a), int(b)
            if a not in person or b not in person:
                continue
            ax, ay = person[a]
            bx, by = person[b]
            vec = np.array([bx - ax, by - ay], np.float32)
            norm = np.linalg.norm(vec)
            if norm < 1e-6:
                continue
            unit = vec / norm
            px = xs - ax
            py = ys - ay
            t = np.clip((px * vec[0] + py * vec[1]) / (norm**2), 0, 1)
            dx = px - t * vec[0]
            dy = py - t * vec[1]
            on_limb = (dx**2 + dy**2) < 2.0**2
            paf[:, :, 2 * l] = np.where(on_limb, unit[0], paf[:, :, 2 * l])
            paf[:, :, 2 * l + 1] = np.where(on_limb, unit[1], paf[:, :, 2 * l + 1])
    conf[:, :, n_parts] = 1.0 - conf[:, :, :n_parts].max(-1)
    return conf, paf


TWO_PEOPLE = [
    {0: (10, 6), 1: (10, 12), 2: (6, 12), 3: (5, 18), 4: (5, 24),
     5: (14, 12), 6: (15, 18), 7: (15, 24), 8: (8, 24), 9: (8, 32),
     10: (8, 40), 11: (12, 24), 12: (12, 32), 13: (12, 40),
     14: (9, 5), 15: (11, 5), 16: (8, 6), 17: (12, 6)},
    {0: (40, 8), 1: (40, 14), 2: (36, 14), 3: (35, 20), 4: (35, 26),
     5: (44, 14), 6: (45, 20), 7: (45, 26), 8: (38, 26), 11: (42, 26)},
]


# -- phases ---------------------------------------------------------------------

def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    card = out[0].strip()
    print(card, flush=True)
    return card


def phase_build() -> None:
    from hyperpose_torch.ops.kernels import build

    t0 = time.perf_counter()
    built = build.build()
    secs = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "bytes smem" in ln]
        for name, log in build.ptxas_log.items()
    }
    emit("build", seconds=secs, built=built, arch="sm_90a", ptxas=ptxas)


def phase_line_gather(rng) -> dict:
    import torch
    from hyperpose_torch.ops.kernels.line_gather import (
        line_gather, line_gather_plain,
    )

    b, l, (h, w), m = BATCH, 19, FEAT_HW, 16 * 16 * 10
    planes = torch.from_numpy(
        rng.standard_normal((b, l, 2, h, w)).astype(np.float32)).cuda()
    ly = torch.from_numpy(rng.integers(0, h, (b, l, m)).astype(np.int32)).cuda()
    lx = torch.from_numpy(rng.integers(0, w, (b, l, m)).astype(np.int32)).cuda()
    err = 0.0
    for bf16 in (True, False):
        got = line_gather(planes, ly, lx, bf16)
        want = line_gather_plain(planes, ly, lx, bf16)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
    check(err == 0.0, f"line_gather differs from its plain version: {err}")

    # The yardstick: one advanced-indexing call computing the same function.
    idx = (torch.arange(b, device="cuda")[:, None, None, None],
           torch.arange(l, device="cuda")[None, :, None, None],
           torch.arange(2, device="cuda")[None, None, :, None],
           ly[:, :, None, :].long(), lx[:, :, None, :].long())
    check(bool(torch.equal(planes[idx], line_gather(planes, ly, lx, False))),
          "advanced indexing disagrees with line_gather(bf16=False)")

    nbytes = 4 * (planes.numel() + ly.numel() + lx.numel() + b * l * 2 * m)
    row = {
        "name": "line_gather", "route": "cuda",
        "source": "hyperpose_torch/csrc/line_gather.cu",
        "replaces": "hyperpose_tpu/ops/pallas/line_gather.py:57",
        "max_abs_err": err,
        "ms": device_ms(lambda: line_gather(planes, ly, lx, True)),
        "plain_ms": device_ms(lambda: line_gather_plain(planes, ly, lx, True)),
        "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": device_ms(lambda: planes[idx]),
    }
    emit("line_gather", shapes=f"planes [{b},{l},2,{h},{w}] f32, idx [{b},{l},{m}]",
         bytes=nbytes, kernel_ms=row["ms"],
         call_ms=call_ms(lambda: line_gather(planes, ly, lx, True)),
         **{k: row[k] for k in (
             "max_abs_err", "plain_ms", "library_ms", "bound_ms")})
    return row


def _peak_maps(rng, limbs):
    """[B, 46, 54, 18] painted maps (two-person scene and random scenes) and
    uniform random maps."""
    scenes = [TWO_PEOPLE]
    for _ in range(BATCH - 1):
        people = []
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(10, 44), rng.uniform(8, 20)
            people.append({
                k: (float(np.clip(cx + rng.uniform(-7, 7), 1, 52)),
                    float(np.clip(cy + rng.uniform(-4, 22), 1, 44)))
                for k in range(18)
            })
        scenes.append(people)
    painted = np.stack([make_synthetic_maps(s, limbs)[0][..., :18] for s in scenes])
    noise = rng.uniform(0, 1, painted.shape).astype(np.float32)
    return {"painted": painted, "random": noise}


def phase_peak_topk(rng, limbs) -> dict:
    import torch
    from hyperpose_torch.ops.kernels.peak_topk import peak_topk, peak_topk_plain

    k, ksize, sigma, thresh = 16, 5, 0.75, 0.05
    err_xy = err_raw = 0.0
    cases = _peak_maps(rng, limbs)
    for name, maps in cases.items():
        conf = torch.from_numpy(maps).cuda()
        for border in ("reflect", "zero"):
            got = peak_topk(conf, k, ksize, sigma, thresh, border)
            want = peak_topk_plain(conf, k, ksize, sigma, thresh, border)
            torch.cuda.synchronize()
            v_got, v_want = got[2] > -5e29, want[2] > -5e29
            check(bool(torch.equal(v_got, v_want)),
                  f"peak_topk {name}/{border}: valid masks differ")
            check(int(v_got.sum()) > 0, f"peak_topk {name}/{border}: no peaks")
            e_xy = float((got[0] - want[0]).abs().max())
            e_raw = float((got[1] - want[1]).abs().max())
            check(e_xy <= 1e-4 and e_raw <= 1e-6,
                  f"peak_topk {name}/{border}: |dxy| {e_xy}, |draw| {e_raw}")
            err_xy, err_raw = max(err_xy, e_xy), max(err_raw, e_raw)

    # Time the production (reflect) mode on a decoder-shaped input: the
    # first 18 channels of a [B, H, W, 19] map, as a strided view.
    painted = cases["painted"]
    full = torch.from_numpy(np.concatenate(
        [painted, painted[..., :1]], axis=-1)).cuda()
    conf = full[..., :18]
    b, h, w, p = conf.shape
    hw, r = h * w, ksize // 2
    nbytes = 4 * (b * h * w * p + b * p * k * 4)
    # smooth: 2 passes of (2r+1) mul + 2r add; NMS and plateau: 8 compares
    # each; K argmax scans of the plane; sub-pixel fit per slot (~10).
    ops = b * p * (hw * (2 * (4 * r + 1) + 16 + k) + 10 * k)
    bound = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)
    row = {
        "name": "peak_topk", "route": "cuda",
        "source": "hyperpose_torch/csrc/peak_topk.cu",
        "replaces": "hyperpose_tpu/ops/pallas/peak_kernel.py:152",
        "max_abs_err": max(err_xy, err_raw),
        "ms": device_ms(lambda: peak_topk(conf, k, ksize, sigma, thresh)),
        "plain_ms": device_ms(
            lambda: peak_topk_plain(conf, k, ksize, sigma, thresh), reps=10),
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / H100_BYTES_PER_S
        >= ops / H100_F32_OPS_PER_S else "operations",
        "library_ms": None,
    }
    emit("peak_topk", shapes=f"conf [{b},{h},{w},{p}] f32 view, K={k}",
         bytes=nbytes, operations=ops, max_abs_err_xy=err_xy,
         call_ms=call_ms(lambda: peak_topk(conf, k, ksize, sigma, thresh)),
         max_abs_err_raw=err_raw, kernel_ms=row["ms"], **{k_: row[k_] for k_ in (
             "plain_ms", "library_ms", "bound_ms", "bound_by")})
    return row


def phase_decode(limbs) -> None:
    import torch
    from hyperpose_torch.ops.paf_decode import PafDecoderConfig, paf_decode_batch

    conf, paf = make_synthetic_maps(TWO_PEOPLE, limbs)
    conf = np.repeat(conf[None], BATCH, axis=0)
    paf = np.repeat(paf[None], BATCH, axis=0)
    cfg = PafDecoderConfig()
    gpu = paf_decode_batch(torch.from_numpy(conf).cuda(),
                           torch.from_numpy(paf).cuda(), cfg)
    cpu = paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf), cfg)
    gpu = {k: v.cpu().numpy() for k, v in vars(gpu).items()}
    cpu = {k: v.numpy() for k, v in vars(cpu).items()}
    humans = gpu["valid"].sum(axis=1)
    check(bool((humans == 2).all()), f"decoder found {humans.tolist()} humans, not 2")
    check(np.array_equal(gpu["valid"], cpu["valid"]), "valid differs from the CPU")
    check(np.array_equal(gpu["part_valid"], cpu["part_valid"]),
          "part_valid differs from the CPU")
    d_coords = float(np.abs(gpu["coords"] - cpu["coords"]).max())
    d_scores = float(np.abs(gpu["scores"] - cpu["scores"]).max())
    check(d_coords <= 1e-5 and d_scores <= 1e-3,
          f"decode vs CPU: |dcoords| {d_coords}, |dscores| {d_scores}")
    emit("decode", humans=humans.tolist(), max_abs_dcoords=d_coords,
         max_abs_dscores=d_scores, tolerance={"coords": 1e-5, "scores": 1e-3})


def phase_end_to_end(rng, card) -> dict:
    import torch
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.ops.kernels.line_gather import line_gather
    from hyperpose_torch.ops.kernels.peak_topk import peak_topk
    from hyperpose_torch.ops.paf_decode import paf_decode_batch
    from hyperpose_torch.runtime.engine import PoseEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
    frame = np.load(os.path.join(
        REPO, "hyperpose_torch", "assets", "synth_000000001601.npz"))["rgb"]
    frames = [frame] + [
        rng.integers(0, 256, (368, 432, 3), dtype=np.uint8)
        for _ in range(BATCH - 1)
    ]
    engine = PoseEngine(LightWeightOpenPose(dtype=torch.float32), weights,
                        max_batch_size=BATCH, device="cuda")
    warm_s = engine.warmup()

    line_gather.launches = 0
    peak_topk.launches = 0
    results = engine.inference(frames)
    launches = {"line_gather": line_gather.launches,
                "peak_topk": peak_topk.launches}
    check(all(n > 0 for n in launches.values()),
          f"the main path skipped a kernel: {launches}")
    scores = [h.score for h in results[0]]
    check(len(scores) == 2, f"synthetic frame: {len(scores)} humans, not 2")
    for res in results:
        for hm in res:
            xy = np.array([(p.x, p.y) for p in hm.parts.values()])
            check(bool(np.isfinite(xy).all() and np.isfinite(hm.score)),
                  "non-finite output")

    # The same frame through the port on the CPU (plain versions, f32).
    cpu = PoseEngine(LightWeightOpenPose(dtype=torch.float32), weights,
                     max_batch_size=1, device="cpu")
    cpu_scores = [h.score for h in cpu.inference([frame])[0]]
    check(len(cpu_scores) == 2, f"CPU run: {len(cpu_scores)} humans")
    d_score = float(np.abs(np.array(scores) - np.array(cpu_scores)).max())
    check(d_score <= 1e-3, f"GPU vs CPU human scores differ by {d_score}")

    batch = np.stack([resize_bilinear(f, (368, 432)) for f in frames])
    timing = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        eng = engine if dtype == torch.float32 else PoseEngine(
            LightWeightOpenPose(dtype=dtype), weights, max_batch_size=BATCH,
            device="cuda")
        x = torch.from_numpy(batch).cuda()
        with torch.inference_mode():
            maps = eng.model(x.to(dtype) / 255.0)
            conf = maps["conf_map"].float()
            paf = maps["paf_map"].float()
        stages = {
            "step": lambda: eng.infer_batch_device(x),
            "network": lambda: eng.model(x.to(dtype) / 255.0),
            "decode": lambda: paf_decode_batch(conf, paf, eng.decoder),
        }
        row = {}
        for stage, fn in stages.items():
            with torch.inference_mode():
                row[f"{stage}_ms"], row[f"{stage}_p80_ms"] = wall_ms(fn)
                busy, kernels = device_busy(fn)
            row[f"{stage}_device_busy_ms"] = busy
            row[f"{stage}_kernels"] = kernels
        out = eng.infer_batch_device(x)
        row.update(frames_per_s=1e3 * BATCH / row["step_ms"],
                   device_idle_share=1.0 - row["step_device_busy_ms"] / row["step_ms"],
                   humans_frame0=int(out.valid[0].sum()))
        timing[name] = row
    emit("end_to_end", card=card, input="368x432", batch=BATCH,
         warmup_s=warm_s, tf32=False, wall_samples=50, scores=scores, cpu_scores=cpu_scores,
         max_abs_dscore=d_score, launches=launches, **timing)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY

    limbs = np.asarray(COCO_TOPOLOGY.limbs)
    rng = np.random.default_rng(0)
    card = phase_card()
    phase_build()
    rows = [phase_line_gather(rng), phase_peak_topk(rng, limbs)]
    phase_decode(limbs)
    launches = phase_end_to_end(rng, card)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
