#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`hyperpose_torch/`) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the eight CUDA kernels from `hyperpose_torch/csrc/` (counting the
tensor-core and TMA instructions in their machine code), holds each against
its plain PyTorch version at the serving shapes and times both (`peak_topk`
at K = 1, 16 and 128, and exactly on edge cases; `stem_gemm`, the stem's
bf16 GEMM, at the TPU probe's strip shape and at ragged row counts),
decodes painted two-person maps on the card and on the CPU (with the default
peak front end and with `use_pallas_peaks`), then drives the flagship serving
path (`PoseEngine` on the flagship TinyVGG Lightweight-OpenPose weights at
368x432, batch 8) in each of the three exact serving forms of the checkpoint
(the plain VggTiny stem, the space-to-depth stem and the fused conv1+pool
stem) in float32 and bf16, and streams 20 frames through `StreamProcessor`
over the bf16 fused-stem engine. Then PifPaf: painted composite fields decode
to the two people on the card and on the CPU, the ResNet50 PifPaf engine
(seeded random weights: the repository has no trained PifPaf checkpoint)
runs at 368x432, batch 8, in float32 and bf16 through `fused_decode`, and
the growth kernel is held against its plain version, and timed, on the
tables of the painted fields and of that network's outputs. Then int8
serving: the int8 GEMM at the TPU int8 probe's shape in both its types
against the library's, and `quantize_engine` (calibrated on the batch) on
each flagship form in f32 and bf16 and on PifPaf in bf16, with the device
time of every int8 conv's two kernels (the quantize pass and the
implicit-GEMM conv) beside their bounds, the unfused path they replace and
the bf16 cuDNN convs of the same layers, every int8 conv of a step equal to
a CPU copy of it on the same input, and the conv kernel held against its
plain version at every shape of the step. Then the Resnet18 family:
painted PoseProposal maps decode to the two people on the card, equal to
the CPU bit for bit, and the PoseProposal engine (384x384, `fused_decode`)
and Lightweight-OpenPose on Resnet18 (368x432, the PAF step), batch 8 on
seeded random weights, run in f32, bf16 and int8 (bf16 activations), each
held against the CPU. Then the rest of the OpenPose family through the same
serving phase, batch 8 on seeded random weights, in f32, bf16 and int8:
Lightweight-OpenPose on its default MobilenetDilated (368x432), CMU
OpenPose on VGG19 with PReLU (368x656, the reference's size), MobileNet-Thin
and MobileNet-Small OpenPose (368x432; Small's maps are 92x108); and the
`int8_dwconv` phase holds the fused quantize-and-depthwise kernel bit for
bit against its plain version, in bf16 and float32, at every depthwise
shape of those four int8 steps and of MobilenetV1 and MobilenetV2 at
368x432, timed per set and per shape beside its bound and cuDNN's bf16
depthwise convs of the same layers. The peak phases include maps with NaN
pixels. Last, `facade_cli`: the port's CLI (`hyperpose_torch.cli.run`) at
368x432, batch 8, bf16, on the flagship checkpoint in operator mode (8
PNG frames; the synthetic frame's 2 people found) and stream mode (a
20-frame mp4), on PifPaf and on the int8 Lightweight-OpenPose
(`--quantize 8`), then `PoseEngine.save` of those three engines and each
program loaded in a fresh process (`--loaded`, an internal mode of this
script): the same kernels launched, the eager step's outputs. Then
`evaluate`: the port's evaluation path (dataset reader, `Evaluator`, the
COCO scorer) on the 100 val scenes of the seed-0 synthetic set, generated
by the port: the committed flagship at 368x432, batch 8, in f32 (its AP
and detections held to the JAX package's, from
tests/fixtures/jax_eval_flagship_synth_val100.json), bf16, int8 and
multiscale, and PifPaf and PoseProposal on 16 scenes against the same
evaluation on the CPU; `peak_topk` is also held against its plain version
on the evaluator's larger maps (92x108 to 184x216, beyond a block's shared
memory). Last, `train`: the port's training step (the flagship at 368x432,
batch 8, from a seeded `TrainPipeline` batch of a synthetic train set):
step 1 against the CPU in f32 and against a float64 step, 100 steps on one
batch in f32 and bf16 (timed), the trained npz served and scored, a
checkpoint resumed bit for bit, the entry point
`hyperpose_torch.tools.train --synthetic` for 2 steps and resumed for 2
more, and one step each of PoseProposal, PifPaf and domain adaptation
against the CPU; training launches none of the kernels. Then `pretrain`
(VggTiny's classifier pretraining at 224x224, batch 32, on a synthetic
twin: step 1 against the CPU, timed f32 and bf16 steps, `single_pretrain`
for 100 steps with the scheduled lr / 5, a resume bit for bit, the npz
grafted into the flagship), `parallel` (ranks spawned by this script through
tests/torch_dist_worker.py: 2-rank Sync_sgd at 368x432 against one process
in float64 and float32, NCCL at world size 1, Sync_avg and Pair_avg
against one process standing for the ranks on the card (and, recorded,
against the CPU), the sharded stream engine on 16 bf16 frames with its kernels
launched once per rank, a `device_profile` trace), `tl_import` (the
flagship written in the TensorLayer layout, imported back and served) and
`spatial` (image rows split over ranks: a 2-rank and a 4-rank group on the
card, the flagship's Sync_sgd step at 368x432 against the `parallel`
phase's one process in float64 and float32, the row-sharded stream engine
in bf16 plain, bf16 fused-stem and int8 form against one engine with its
kernels launched on every rank; grouped int8 convs against their plain
version; the export and FLOP-count tools). It checks that each path went
through its kernels.

Every phase prints one line; any failure
exits non-zero before the result line. The last line is
`{"ok": true, "device": {...}}`. It needs a CUDA device and exits non-zero
without one; it imports no JAX.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))  # torch_measures

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12   # float32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bf16 tensor cores, dense
FEAT_HW = (46, 54)           # 368x432 input / 8
# (ksize, sigma) of the peak smooth beside the PAF decoder's 5 / 0.75, whose
# radius the kernel compiles apart: 3 / 0.5 and the JAX evaluator's 9 / 1.5
# take the radius at run time.
OTHER_SMOOTHS = ((3, 0.5), (9, 1.5))
BATCH = 8
INPUT_HW = (368, 432)
FLAGSHIP_SCORES = (17.0187, 8.5840)   # the synthetic frame, f32, both packages
# int8 flagship on the synthetic frame. A last-place difference in the
# float ops between the int8 convs (BatchNorm on another device) flips some
# int8 roundings, and the flips grow through the network until two runs'
# maps differ by about 4-8% of their range, as int8 differs from float: a
# part near the threshold may come or go, and a third, weak human may
# appear. So each person of the float engine must be found (at least half
# its parts, at the same places within 0.01 of the image size), and the
# card's int8 maps must lie within 0.15 of their range of the CPU's, the
# JAX package's own bound between int8 and float (tests/test_quant.py:53).
# That bound is a second check: each int8 conv alone is held exactly to a
# CPU copy of it on the card's input (`_convs_card_vs_cpu`).
INT8_TOL = {"xy": 0.01, "maps": 0.15}


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
    torch.profiler trace of `iters` calls. The trace records the device's
    activity alone: the host's ops add nothing to these sums, and turning
    their events into `key_averages` took most of each trace's time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# -- a numpy copy of tests/test_pifpaf.py:56-111 --------------------------------

def _inv_softplus(y):
    return np.log(np.expm1(np.maximum(y, 1e-4)))


def synth_fields(people, h=46, w=54, stride=8):
    """Raw PifPaf fields (pre-activation NHWC, batch 1) painting the given
    people (dict part -> (x, y) in input pixels)."""
    from hyperpose_torch.utils.topology import PIFPAF_BONES

    p, l = 17, 19
    pif_conf = np.full((h, w, p), -10.0, np.float32)
    pif_vec = np.zeros((h, w, p, 2), np.float32)
    pif_scale = np.full((h, w, p), _inv_softplus(2.0), np.float32)
    paf_conf = np.full((h, w, l), -10.0, np.float32)
    paf_src = np.zeros((h, w, l, 2), np.float32)
    paf_dst = np.zeros((h, w, l, 2), np.float32)
    paf_scale = np.full((h, w, l), _inv_softplus(2.0), np.float32)
    for person in people:
        for k, (x, y) in person.items():
            gx, gy = x / stride, y / stride
            for oy in range(-1, 2):
                for ox in range(-1, 2):
                    cy, cx = int(gy) + oy, int(gx) + ox
                    if 0 <= cy < h and 0 <= cx < w:
                        pif_conf[cy, cx, k] = 8.0
                        pif_vec[cy, cx, k] = (gx - cx, gy - cy)
        for li, (a, b) in enumerate(PIFPAF_BONES):
            a, b = int(a), int(b)
            if a not in person or b not in person:
                continue
            ax, ay = np.array(person[a]) / stride
            bx, by = np.array(person[b]) / stride
            for t in np.linspace(0.2, 0.8, 8):
                cx = int(round(ax + t * (bx - ax)))
                cy = int(round(ay + t * (by - ay)))
                if 0 <= cy < h and 0 <= cx < w:
                    paf_conf[cy, cx, li] = 8.0
                    paf_src[cy, cx, li] = (ax - cx, ay - cy)
                    paf_dst[cy, cx, li] = (bx - cx, by - cy)
    return {
        "pif_conf": pif_conf[None], "pif_vec": pif_vec[None],
        "pif_bmin": np.zeros((1, h, w, p), np.float32),
        "pif_scale": pif_scale[None],
        "paf_conf": paf_conf[None], "paf_src_vec": paf_src[None],
        "paf_dst_vec": paf_dst[None],
        "paf_src_bmin": np.zeros((1, h, w, l), np.float32),
        "paf_dst_bmin": np.zeros((1, h, w, l), np.float32),
        "paf_src_scale": paf_scale[None], "paf_dst_scale": paf_scale[None].copy(),
    }


PIFPAF_TWO_PEOPLE = [
    {i: (80 + 10 * (i % 5), 60 + 18 * (i // 3)) for i in range(17)},
    {i: (280 + 10 * (i % 5), 120 + 18 * (i // 3)) for i in range(17)},
]


def painted_pifpaf_batch(batch=BATCH):
    """[batch] painted two-person fields, frame i shifted by (6i, 3i) px."""
    frames = [synth_fields([{k: (x + 6 * i, y + 3 * i) for k, (x, y) in person.items()}
                            for person in PIFPAF_TWO_PEOPLE]) for i in range(batch)]
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


# -- PoseProposal: painted grid maps ----------------------------------------------

PPN_HW = (384, 384)     # config_ppn: 384x384 -> a 12x12 grid of 32-pixel cells
PPN_PERSON = {          # part -> (x, y) in input pixels, Instance (1) the root
    0: (110, 80), 1: (110, 120), 2: (80, 125), 3: (65, 170), 4: (60, 215),
    5: (140, 125), 6: (155, 170), 7: (160, 215), 8: (95, 210), 9: (92, 275),
    10: (90, 340), 11: (125, 210), 12: (128, 275), 13: (130, 340),
    14: (102, 70), 15: (118, 70), 16: (92, 75), 17: (128, 75)}
PPN_TWO_PEOPLE = [PPN_PERSON, {k: (x + 180, y + 10) for k, (x, y) in PPN_PERSON.items()}]


def paint_ppn(people, grid=(12, 12), in_hw=PPN_HW, n_limbs=17, nei=(9, 9)):
    """PoseProposal maps of one image (batch 1) painting the given people
    (dict part -> (x, y) in input pixels), as the decoder takes them: at
    each part's cell c = i = 0.9, x and y the part's pixel coordinates, w =
    h = 40 pixels; for each limb, e = 0.9 at the offset of the destination's
    cell from the source's (e[l, dy + hnei // 2, dx + wnei // 2, sy, sx]);
    0 elsewhere."""
    from hyperpose_torch.utils.topology import PPN_LIMBS

    (hout, wout), (hnei, wnei), p = grid, nei, 18
    cell_h, cell_w = in_hw[0] / hout, in_hw[1] / wout
    maps = {k: np.zeros((hout, wout, p), np.float32) for k in "cixywh"}
    e = np.zeros((n_limbs, hnei, wnei, hout, wout), np.float32)
    for person in people:
        cells = {k: (int(y // cell_h), int(x // cell_w)) for k, (x, y) in person.items()}
        for k, (x, y) in person.items():
            cy, cx = cells[k]
            for name, v in zip("cixywh", (0.9, 0.9, x, y, 40.0, 40.0)):
                maps[name][cy, cx, k] = v
        for li, (a, b) in enumerate(PPN_LIMBS):
            (sy, sx), (dy, dx) = cells[int(a)], cells[int(b)]
            assert abs(dy - sy) <= hnei // 2 and abs(dx - sx) <= wnei // 2, (a, b)
            e[li, dy - sy + hnei // 2, dx - sx + wnei // 2, sy, sx] = 0.9
    return {**{k: v[None] for k, v in maps.items()}, "e": e[None]}


def painted_ppn_batch(batch=BATCH):
    """[batch] painted two-person PoseProposal maps, frame i's people
    shifted by (4i, 2i) pixels."""
    frames = [paint_ppn([{k: (x + 4 * i, y + 2 * i) for k, (x, y) in person.items()}
                         for person in PPN_TWO_PEOPLE]) for i in range(batch)]
    return {k: np.concatenate([f[k] for f in frames]) for k in frames[0]}


def dense_ppn_maps(seed: int, b: int = 3, levels=None) -> dict:
    """Dense PoseProposal maps on a 12x12 grid (384x384 input) as random
    weights give them: every cell's c near 0.5, above the decoder's 0.2
    thresholds, and x/y/w/h restored to input pixels. With `levels`, c and
    e take only those values, so top-K, the NMS order and the matching
    argmax meet exact ties everywhere."""
    rng = np.random.default_rng(seed)
    m = {k: rng.uniform(0.3, 0.7, (b, 12, 12, 18)).astype(np.float32) for k in "cixywh"}
    if levels is None:
        m["e"] = rng.uniform(0.1, 0.7, (b, 17, 9, 9, 12, 12)).astype(np.float32)
    else:
        m["c"] = rng.choice(np.float32(levels), (b, 12, 12, 18))
        m["e"] = rng.choice(np.float32(levels), (b, 17, 9, 9, 12, 12))
    g = np.arange(12, dtype=np.float32)
    m["x"] = (m["x"] + g[:, None]) * np.float32(32)
    m["y"] = (m["y"] + g[:, None, None]) * np.float32(32)
    m["w"] = m["w"] * np.float32(384)
    m["h"] = m["h"] * np.float32(384)
    return m


def humans_of(d, i):
    """The valid humans of image i of a decode (numpy fields) as (score,
    part_valid, coords, part_scores), sorted by score and coordinates:
    duplicate skeletons of equal score may sit in other slots on two
    devices or in two packages."""
    out = [(d["scores"][i, h], d["part_valid"][i, h], d["coords"][i, h],
            d["part_scores"][i, h]) for h in np.nonzero(d["valid"][i])[0]]
    return sorted(out, key=lambda t: (round(float(t[0]), 3),
                                      tuple(np.round(t[2], 3).ravel())))


def human_deltas(a, b) -> tuple[float, float]:
    """(max |d coords|, max |d human or part score|) between the humans of
    two decodes; raises ValueError unless every image has the same number
    of humans with the same parts."""
    d_xy = d_s = 0.0
    for i in range(a["valid"].shape[0]):
        ha, hb = humans_of(a, i), humans_of(b, i)
        if len(ha) != len(hb):
            raise ValueError(f"image {i}: {len(ha)} vs {len(hb)} humans")
        for (sa, va, ca, pa), (sb, vb, cb, pb) in zip(ha, hb):
            if not np.array_equal(va, vb):
                raise ValueError(f"image {i}: part sets differ")
            d_xy = max(d_xy, float(np.abs(ca - cb).max()))
            d_s = max(d_s, abs(float(sa - sb)), float(np.abs(pa - pb).max()))
    return d_xy, d_s


def find_people(ref, got) -> float | None:
    """Each human of `ref` matched to its own human of `got` that has at
    least half of its parts: the largest |dx| + |dy| over the matched parts,
    or None if some human finds no match. `got` may hold more humans."""
    worst, free = 0.0, list(got)
    for w in ref:
        best = None
        for g in free:
            shared = set(w.parts) & set(g.parts)
            if 2 * len(shared) < len(w.parts):
                continue
            d = max(abs(g.parts[p].x - w.parts[p].x) + abs(g.parts[p].y - w.parts[p].y)
                    for p in shared)
            if best is None or d < best[0]:
                best = (d, g)
        if best is None:
            return None
        worst = max(worst, best[0])
        free.remove(best[1])
    return worst


def _numpy(d) -> dict:
    return {k: v.cpu().numpy() for k, v in vars(d).items()}


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
               if "registers" in ln or "bytes smem" in ln or "entry function" in ln]
        for name, log in build.ptxas_log.items()
    }
    # Tensor-core instructions in each library's machine code: mma.sync is
    # HMMA (float types) or IMMA (integers), wgmma is HGMMA or IGMMA; TMA
    # loads and stores are UTMALDG and UTMASTG.
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    mma = {}
    for name in build.KERNELS:
        sass = subprocess.run(
            [tool, "-sass", str(build.library_path(name))], capture_output=True,
            text=True, timeout=300, check=True).stdout
        mma[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                     for op in ("HMMA", "HGMMA", "IMMA", "IGMMA", "UTMALDG", "UTMASTG")}
    check(mma["conv1_pool"]["HMMA"] > 0,
          f"conv1_pool's machine code has no tensor-core instruction: {mma}")
    check(mma["int8_gemm"]["IGMMA"] > 0 and mma["int8_gemm"]["HGMMA"] > 0,
          f"int8_gemm's machine code lacks IGMMA or HGMMA (wgmma): {mma}")
    sg = mma["stem_gemm"]
    check(sg["HGMMA"] > 0 and sg["HMMA"] == 0 and sg["UTMALDG"] > 0 and sg["UTMASTG"] > 0,
          f"stem_gemm is not on wgmma fed and stored by TMA: {mma}")
    emit("build", seconds=secs, built=built, arch="sm_90a", ptxas=ptxas,
         sass_mma=mma)


def limb_scores_inputs(rng, batch=BATCH, h=FEAT_HW[0], w=FEAT_HW[1], k=16):
    """(paf [B, H, W, 38], peak_xy [B, 18, K, 2], peak_valid [B, 18, K],
    limbs) for the limb scoring at the flagship decode's shape: a random
    field leaning towards positive values (so that many pairs pass), a fifth
    of the peaks invalid, peaks on the plane's corners and edges and beyond
    them by less than a pixel (samples the clamp moves), and coincident
    pairs (zero length) on every fourth limb."""
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY

    limbs = np.asarray(COCO_TOPOLOGY.limbs)
    paf = (0.8 + 0.4 * rng.standard_normal((batch, h, w, 2 * len(limbs)))).astype(np.float32)
    xy = np.stack([rng.uniform(-0.5, w - 0.5, (batch, 18, k)),
                   rng.uniform(-0.5, h - 0.5, (batch, 18, k))], -1).astype(np.float32)
    xy[:, :, 0] = (-0.5, -0.5)
    xy[:, :, 1] = (w - 0.5, h - 0.5)
    xy[:, 0::3, 2] = (w - 1, -0.7)
    for a, b in limbs[::4]:
        xy[:, b, 3] = xy[:, a, 1]
    valid = rng.uniform(size=(batch, 18, k)) < 0.8
    return paf, xy, valid, limbs


def phase_limb_scores() -> dict:
    """limb_scores equal, bit for bit, to its plain version at the flagship
    decode's shape, with the field channels-last and as a view of an NCHW
    tensor, both bf16 modes; timed beside the bytes this run's peaks need.
    Its inputs come from a generator of their own, so that they leave the
    later phases' draws alone."""
    import torch
    from hyperpose_torch.ops.kernels.line_gather import limb_scores, limb_scores_plain
    from torch_measures import limb_scores_work

    paf, xy, valid, limbs = limb_scores_inputs(np.random.default_rng(1))
    field = torch.from_numpy(paf).cuda()
    layouts = {"nhwc": field,
               "nchw_view": field.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)}
    xy, valid = torch.from_numpy(xy).cuda(), torch.from_numpy(valid).cuda()
    err, passed = 0.0, {}
    for (name, f), bf16 in itertools.product(layouts.items(), (True, False)):
        got = limb_scores(f, xy, valid, limbs, bf16=bf16)
        want = limb_scores_plain(f, xy, valid, limbs, bf16=bf16)
        torch.cuda.synchronize()
        ok = want > -5e29
        check(bool(torch.equal(got, want)),
              f"limb_scores {name} bf16={bf16} differs from its plain version: masks equal "
              f"{bool(torch.equal(got > -5e29, ok))}, max |d| on passing pairs "
              f"{float((got - want)[ok].abs().max()) if bool(ok.any()) else 0.0}")
        passed[f"{name}_bf16" if bf16 else name] = int(ok.sum())
        err = max(err, float((got - want).abs().max()))
    check(all(n > 0 for n in passed.values()), f"limb_scores: no passing pair {passed}")

    b, h, w, c = field.shape
    work = limb_scores_work(field.shape, xy, valid, limbs)
    t_bytes, t_ops = work["bytes"] / H100_BYTES_PER_S, work["operations"] / H100_F32_OPS_PER_S
    args = (xy, valid, limbs)
    row = {
        "name": "limb_scores", "route": "cuda",
        "source": "hyperpose_torch/csrc/line_gather.cu",
        "replaces": "hyperpose_tpu/ops/pallas/line_gather.py:57",
        "max_abs_err": err,
        "ms": device_ms(lambda: limb_scores(field, *args)),
        "plain_ms": device_ms(lambda: limb_scores_plain(field, *args), reps=10),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    field_whole = 4 * field.numel() + 4 * xy.numel() + valid.numel() + 4 * b * len(limbs) * 16 * 16
    emit("limb_scores", shapes=f"paf [{b},{h},{w},{c}] f32, peaks [{b},18,16], 19 limbs, "
         f"S=10 -> [{b},19,16,16] f32", passing_pairs=passed, **work,
         kernel_ms=row["ms"],
         call_ms=call_ms(lambda: limb_scores(field, *args)),
         bytes_whole_field=field_whole,
         bound_ms_whole_field=1e3 * field_whole / H100_BYTES_PER_S,
         **{k: row[k] for k in ("max_abs_err", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")})
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


def _decoder_view(maps, device="cuda"):
    """The first P channels of a [B, H, W, P + 1] map on the card, as the
    decoder hands them over: a strided view."""
    import torch

    full = torch.from_numpy(np.concatenate([maps, maps[..., :1]], axis=-1)).to(device)
    return full[..., :maps.shape[-1]]


def peak_topk_cases(maps, device):
    """(name, conf, K) edge cases of the peak top-K beside the serving
    shape, each run in both border modes: K = 1 and 128, K = H*W on a small
    plane, a plane with no survivor, the densest lattice of survivors
    (non-adjacent pixels at even (y, x): 23 x 27 = 621 per 46 x 54 plane,
    more than the kernel's 512 threads) with distinct and with equal values,
    plateaus of equal values, a batch-strided view, and maps with NaN
    pixels (`nan_peak_maps`: no peak with a NaN in its window survives).
    `maps` holds the [B, 46, 54, 18] "painted" and "random" arrays."""
    import torch

    rng = np.random.default_rng(7)
    h, w = FEAT_HW
    lattice = np.zeros((2, h, w, 18), np.float32)
    lattice[:, ::2, ::2] = rng.uniform(0.9, 1.0, lattice[:, ::2, ::2].shape)
    ties = np.zeros((2, h, w, 18), np.float32)
    ties[:, ::2, ::2] = 0.75
    plateaus = np.zeros((1, h, w, 18), np.float32)  # three of them identical
    for y, x, s_ in [(10, 10, 6), (30, 30, 4), (8, 40, 4), (20, 20, 4), (38, 49, 5)]:
        plateaus[0, y:y + s_, x:x + s_] = 0.6
    small = rng.uniform(0, 1, (3, 6, 9, 5)).astype(np.float32)
    cases = [
        ("painted_k1", maps["painted"], 1), ("random_k1", maps["random"], 1),
        ("random_k128", maps["random"], 128), ("lattice_k128", lattice, 128),
        ("lattice_ties_k16", ties, 16), ("lattice_ties_k128", ties, 128),
        ("no_survivor", np.zeros((2, h, w, 18), np.float32), 16),
        ("plateaus", plateaus, 16), ("small_k_hw", small, 6 * 9),
        ("small_sparse_k_hw", np.where(small > 0.9, small, 0).astype(np.float32), 6 * 9),
        ("nan_painted", nan_peak_maps(maps["painted"]), 16),
        ("nan_random", nan_peak_maps(maps["random"]), 16),
    ]
    out = [(name, _decoder_view(m, device), k) for name, m, k in cases]
    full = torch.from_numpy(np.concatenate([maps["random"]] * 2)).to(device)
    out.append(("batch_strided", full[::2], 16))
    return out


def phase_peak_topk(cases) -> dict:
    """peak_topk equal, bit for bit, to its plain version (xy, raw and sval,
    filler slots included) in both border modes on the serving maps and the
    edge cases; timed (first) at K = 1, 16 and 128 on the decoder's input."""
    import torch
    from hyperpose_torch.ops.kernels.peak_topk import (
        _smooth_nms, _taps, peak_topk, peak_topk_plain, scratch_plan,
    )

    k, ksize, sigma, thresh = 16, 5, 0.75, 0.05
    # Time the production (reflect) mode on a decoder-shaped input: the
    # first 18 channels of a [B, H, W, 19] map, as a strided view.
    conf = _decoder_view(cases["painted"])
    b, h, w, p = conf.shape
    hw, r = h * w, ksize // 2
    nbytes = 4 * (b * h * w * p + b * p * k * 4)
    # smooth: 2 passes of (2r+1) mul + 2r add; NMS and plateau: 8 compares
    # each; one compare per survivor to select the top K (the fewest any
    # selection needs); sub-pixel fit per slot (~10).
    _, peaks = _smooth_nms(conf.permute(0, 3, 1, 2), _taps(ksize, sigma), thresh, False)
    survivors = int(peaks.sum())
    ops = b * p * (hw * (2 * (4 * r + 1) + 16) + 10 * k) + survivors
    bound = 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)
    by_k = {kk: device_ms(lambda kk=kk: peak_topk(conf, kk, ksize, sigma, thresh))
            for kk in (1, 16, 128)}
    row = {
        "name": "peak_topk", "route": "cuda",
        "source": "hyperpose_torch/csrc/peak_topk.cu",
        "replaces": "hyperpose_tpu/ops/pallas/peak_kernel.py:152",
        "ms": by_k[16],
        "plain_ms": device_ms(
            lambda: peak_topk_plain(conf, k, ksize, sigma, thresh), reps=10),
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / H100_BYTES_PER_S
        >= ops / H100_F32_OPS_PER_S else "operations",
        "library_ms": None,
    }
    runs = [(name, _decoder_view(maps), k, ksize, sigma) for name, maps in cases.items()]
    runs += [(f"{name}_ksize{ks}", _decoder_view(maps), k, ks, sg)
             for name, maps in cases.items() for ks, sg in OTHER_SMOOTHS]
    runs += [(name, x, kk, ksize, sigma) for name, x, kk in peak_topk_cases(cases, "cuda")]
    eval_maps = eval_peak_maps(cases)
    runs += [(f"{name}_k{kk}_ksize{ks}", _decoder_view(m), kk, ks, sg)
             for name, m in eval_maps.items() for kk in (24, 128)
             for ks, sg in ((ksize, sigma), EVAL_SMOOTH)]
    err = 0.0
    for name, x, kk, ks, sg in runs:
        for border in ("reflect", "zero"):
            got = peak_topk(x, kk, ks, sg, thresh, border)
            want = peak_topk_plain(x, kk, ks, sg, thresh, border)
            torch.cuda.synchronize()
            err = max([err] + [float((g - w_).nan_to_num(0.0).abs().max())
                               for g, w_ in zip(got, want)])
            check(all(_equal_nan(g, w_) for g, w_ in zip(got, want)),
                  f"peak_topk {name}/{border} K={kk}: differs from its plain version: "
                  f"|dxy| {float((got[0] - want[0]).abs().max())}, "
                  f"|draw| {float((got[1] - want[1]).abs().max())}, "
                  f"sval equal {bool(torch.equal(got[2], want[2]))}")
            if name in cases:
                check(int((got[2] > -5e29).sum()) > 0, f"peak_topk {name}/{border}: no peaks")
    row["max_abs_err"] = err
    # The evaluator's decode: K 24, ksize 9, sigma 1.5, reflect, on painted
    # maps upsampled 2x (92x108, in shared memory), to 120x160 (a 480x640
    # input: the planes in scratch) and to 344x344 (the lists in scratch too).
    eval_ms = {}
    for name in ("painted_92x108", "painted_120x160", "painted_344x344"):
        x = _decoder_view(eval_maps[name])
        eb, eh, ew, ep = x.shape
        floats, global_lists = scratch_plan(x.device.index, eh, ew)
        eval_ms[name] = {
            "ms": device_ms(lambda x=x: peak_topk(x, 24, *EVAL_SMOOTH, thresh)),
            "scratch_floats": eb * ep * floats, "lists_in_scratch": global_lists,
            "shared_bytes_needed": 4 * (3 * eh * ew + 2 * (((eh + 1) // 2 * ((ew + 1) // 2)
                                                               + 3) // 4 * 4))}
    emit("peak_topk", shapes=f"conf [{b},{h},{w},{p}] f32 view, K={k}",
         bytes=nbytes, operations=ops, equal_cases=[r_[0] for r_ in runs],
         kernel_ms=row["ms"], kernel_ms_by_k=by_k, eval_k24_ksize9=eval_ms,
         call_ms=call_ms(lambda: peak_topk(conf, k, ksize, sigma, thresh)),
         **{k_: row[k_] for k_ in ("max_abs_err", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")})
    return row


EVAL_SMOOTH = (9, 1.5)   # the evaluator's decode (hyperpose_torch/eval/evaluate.py)
EVAL_PEAK_HW = ((92, 108), (120, 160), (184, 216), (344, 344))


def eval_peak_maps(cases) -> dict:
    """[B, H, W, 18] maps at the evaluator's decode sizes: 92x108 (368x432
    upsampled 2x, in shared memory), 120x160 (a 480x640 input) and 184x216
    (beyond a block's shared memory: the planes in the kernel's scratch),
    and 344x344 (a 1376x1376 input: the survivor lists there too), the
    painted maps upsampled by `jax_resize_cubic` (sparse peaks, as the
    evaluator's) and uniform random maps (dense survivors)."""
    import torch
    from hyperpose_torch.ops.image import jax_resize_cubic

    rng = np.random.default_rng(11)
    painted = torch.from_numpy(cases["painted"])
    out = {}
    for hw in EVAL_PEAK_HW:
        tag = "x".join(map(str, hw))
        out[f"painted_{tag}"] = jax_resize_cubic(painted, hw).numpy()
        out[f"random_{tag}"] = rng.uniform(0, 1, (2, *hw, 18)).astype(np.float32)
    return out


BIG_SMOOTH = (31, 5.0)  # the largest ksize the peak wrappers take (radius 15)


def peak_candidates_cases(maps, device):
    """(name, conf, ksize, sigma) cases of the banded peak_candidates beside
    the serving shape: each smooth, up to the largest ksize, on the
    decoder's strided NHWC view and on a view of an NCHW tensor (the two
    load orders), at H not a multiple of the 16-row band (46 and 13 rows,
    from row 20 on) and below it (5 rows), with a ragged part group (5
    parts), and maps so wide that the band shrinks to 8 and to 4 rows (1,600
    and 3,000 columns). `maps` holds the [B, 46, 54, 18] "painted" and
    "random" arrays."""
    import torch

    out = []
    smooths = ((5, 0.75),) + OTHER_SMOOTHS + (BIG_SMOOTH,)
    for name, m in maps.items():
        views = {"nhwc_view": _decoder_view(m, device),
                 "nchw_view": torch.from_numpy(m).to(device).permute(0, 3, 1, 2)
                 .contiguous().permute(0, 2, 3, 1)}
        for (view, conf), (ks, sg) in itertools.product(views.items(), smooths):
            out.append((f"{name}_{view}_ksize{ks}", conf, ks, sg))
            for rows in (13, 5):
                out.append((f"{name}_{view}_h{rows}_ksize{ks}", conf[:, 20:20 + rows], ks, sg))
            out.append((f"{name}_{view}_parts5_ksize{ks}", conf[..., :5], ks, sg))
    rng = np.random.default_rng(3)
    for (h, w, p), (ks, sg) in itertools.product(((20, 1600, 3), (9, 3000, 2)),
                                                 ((5, 0.75), BIG_SMOOTH)):
        wide = rng.uniform(0, 1, (1, h, w, p)).astype(np.float32)
        out.append((f"wide{w}_ksize{ks}", _decoder_view(wide, device), ks, sg))
    return out


def nan_peak_maps(maps: np.ndarray) -> np.ndarray:
    """A copy of [B, H, W, P] maps with NaN pixels: in each image a lone NaN
    three columns right of its first peak with room (the zero-border ksize-5
    smooth keeps the peak's own value finite and makes its right
    neighbour's NaN, so JAX's NMS, whose 3x3 maximum carries NaN, drops
    the peak), and in image 0 a whole NaN part plane (part 1)."""
    import torch
    from hyperpose_torch.ops.kernels.peak_topk import peak_candidates_plain

    out = maps.copy()
    ranked, _ = peak_candidates_plain(torch.from_numpy(maps))
    b, p, y, x = np.nonzero(ranked.numpy() > -5e29)
    for i in range(maps.shape[0]):
        room = np.flatnonzero((b == i) & (x + 3 < maps.shape[2]))
        if room.size:
            k = room[0]
            out[i, y[k], x[k] + 3, p[k]] = np.nan
    out[0, :, :, 1] = np.nan
    return out


def _equal_nan(a, b) -> bool:
    """Equal values, NaN in the same places."""
    import torch

    return a.shape == b.shape and bool(torch.equal(a.isnan(), b.isnan())) and bool(
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def phase_peak_candidates(cases) -> dict:
    """peak_candidates equal, bit for bit, to its plain version on the
    serving maps and `peak_candidates_cases`, and on maps with NaN pixels
    with NaN in the same places; timed on the decoder's view."""
    import torch
    from hyperpose_torch.ops.kernels.peak_topk import (
        peak_candidates, peak_candidates_plain,
    )

    ksize, sigma, thresh, neg = 5, 0.75, 0.05, -1e30
    runs = peak_candidates_cases(cases, "cuda")
    for name, conf, ks, sg in runs:
        got = peak_candidates(conf, ks, sg, thresh, neg)
        want = peak_candidates_plain(conf, ks, sg, thresh, neg)
        torch.cuda.synchronize()
        mask = got[0] > neg / 2
        check(bool(torch.equal(mask, want[0] > neg / 2)),
              f"peak_candidates {name}: peak masks differ")
        check(int(mask.sum()) > 0, f"peak_candidates {name}: no peaks")
        check(bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])),
              f"peak_candidates {name}: values differ, ranked "
              f"{float((got[0] - want[0]).abs().max())}, smoothed "
              f"{float((got[1] - want[1]).abs().max())}")
    # NaN pixels: NaN in the same places, and the peaks beside them dropped
    # as JAX's NMS drops them (its 3x3 maximum carries NaN).
    nan_cases = []
    for name in ("painted", "random"):
        for ks, sg in ((5, 0.75),) + OTHER_SMOOTHS:
            conf = _decoder_view(nan_peak_maps(cases[name]))
            got = peak_candidates(conf, ks, sg, thresh, neg)
            want = peak_candidates_plain(conf, ks, sg, thresh, neg)
            torch.cuda.synchronize()
            check(bool(got[1].isnan().any()) and _equal_nan(got[0], want[0])
                  and _equal_nan(got[1], want[1]),
                  f"peak_candidates nan_{name}_ksize{ks}: differs from its plain version "
                  f"(NaN places or values)")
            nan_cases.append(f"nan_{name}_ksize{ks}")
    conf = _decoder_view(cases["painted"])
    b, h, w, p = conf.shape
    r = ksize // 2
    nbytes = 4 * 3 * b * h * w * p           # the map in, two planes out
    ops = b * p * h * w * (2 * (4 * r + 1) + 16)
    row = {
        "name": "peak_candidates", "route": "cuda",
        "source": "hyperpose_torch/csrc/peak_topk.cu",
        "replaces": "hyperpose_tpu/ops/pallas/peak_kernel.py:203",
        "max_abs_err": 0.0,
        "ms": device_ms(lambda: peak_candidates(conf, ksize, sigma, thresh, neg)),
        "plain_ms": device_ms(
            lambda: peak_candidates_plain(conf, ksize, sigma, thresh, neg), reps=10),
        "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S),
        "bound_by": "bytes" if nbytes / H100_BYTES_PER_S
        >= ops / H100_F32_OPS_PER_S else "operations",
        "library_ms": None,
    }
    nchw = torch.from_numpy(cases["painted"]).cuda().permute(0, 3, 1, 2).contiguous()
    emit("peak_candidates", shapes=f"conf [{b},{h},{w},{p}] f32 view -> "
         f"2 x [{b},{p},{h},{w}]", bytes=nbytes, operations=ops,
         equal_cases=[r_[0] for r_ in runs], equal_nan_cases=nan_cases,
         kernel_ms=row["ms"],
         kernel_ms_nchw_view=device_ms(lambda: peak_candidates(
             nchw.permute(0, 2, 3, 1), ksize, sigma, thresh, neg)),
         call_ms=call_ms(lambda: peak_candidates(conf, ksize, sigma, thresh, neg)),
         **{k: row[k] for k in ("plain_ms", "library_ms", "bound_ms", "bound_by")})
    return row


def _stem_model(stem: str, dtype):
    """(model, flax weights) of the flagship checkpoint in one serving form."""
    from hyperpose_torch.models import backbones as B
    from hyperpose_torch.models.openpose import LightWeightOpenPose

    weights = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
    backbone, remap = {
        "plain": (B.VggTiny, None),
        "s2d": (B.VggTinyS2DStem, B.remap_vggtiny_to_s2d),
        "fused": (B.VggTinyFusedStem, B.remap_vggtiny_to_fused),
    }[stem]
    return (LightWeightOpenPose(backbone=backbone, dtype=dtype),
            weights if remap is None else remap(weights))


def _frames(rng) -> list:
    """The synthetic frame and BATCH-1 random frames of the input size."""
    frame = np.load(os.path.join(
        REPO, "hyperpose_torch", "assets", "synth_000000001601.npz"))["rgb"]
    return [frame] + [rng.integers(0, 256, (*INPUT_HW, 3), dtype=np.uint8)
                      for _ in range(BATCH - 1)]


def phase_conv1_pool(frames) -> dict:
    """The fused stem's kernel on the real conv0p output of the remapped
    flagship (channels-last, as the engine runs it), in f32 and bf16, against
    its plain version and against what it replaces: the plain stem's block_1
    and pool1 on cuDNN."""
    import torch
    import torch.nn.functional as F
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.ops.kernels.conv1_pool import conv1_pool, conv1_pool_plain
    from hyperpose_torch.utils.weights import load_flax_weights
    from torch_measures import bf16_agreement

    batch = np.stack([resize_bilinear(f, INPUT_HW) for f in frames])
    x_u8 = torch.from_numpy(batch).cuda()
    b, (h, w) = BATCH, INPUT_HW
    q = w // 2
    ops = 2 * b * h * q * 384 * 128
    out = {}
    for name, dtype, tol in (("f32", torch.float32, 1e-4),
                             ("bf16", torch.bfloat16, 1e-2)):
        fused, fw = _stem_model("fused", dtype)
        plain, pw = _stem_model("plain", dtype)
        stems = [load_flax_weights(m, wt).backbone.cuda().eval().to(
            memory_format=torch.channels_last) for m, wt in ((fused, fw), (plain, pw))]
        fused, plain = stems
        with torch.inference_mode():
            x = (x_u8.to(dtype) / 255.0).permute(0, 3, 1, 2)
            btp = fused.conv0_packed(x)
            w1p, b1p = fused.w1p, fused.b1p
            check(tuple(btp.shape) == (b, h, q, 128) and btp.stride(3) == 1,
                  f"conv0p output {tuple(btp.shape)} strides {btp.stride()}")
            got = conv1_pool(btp, w1p, b1p)
            want = conv1_pool_plain(btp, w1p, b1p)
            torch.cuda.synchronize()
            g, wt = got.float(), want.float()
            err = float((g - wt).abs().max())
            ok = bool(torch.allclose(g, wt, atol=tol, rtol=tol))
            check(ok, f"conv1_pool {name}: max |d| {err} beyond atol=rtol={tol}")
            if name == "bf16":  # 1 ulp, beyond what the sums' order explains
                scale = conv1_pool_plain(btp.abs(), w1p.abs(), torch.zeros_like(b1p))
                agree = bf16_agreement(got, want, scale.float())
                check(agree["max_ulps_beyond_sum_order"] <= 1,
                      f"conv1_pool bf16 vs plain: {agree}")
            try:
                conv1_pool(btp.contiguous().permute(0, 3, 1, 2).contiguous()
                           .permute(0, 2, 3, 1), w1p, b1p)
                fail(f"conv1_pool {name}: a non-channels-last input did not raise")
            except ValueError:
                pass
            a0 = plain.block_0(x)
            nbytes = btp.element_size() * (btp.numel() + got.numel())
            bound_ops = ops / (H100_F32_OPS_PER_S if name == "f32"
                               else H100_BF16_OPS_PER_S)
            out[name] = {
                "max_abs_err": err, "check": f"allclose(atol={tol}, rtol={tol})",
                "ms": device_ms(lambda: conv1_pool(btp, w1p, b1p), reps=20),
                "call_ms": call_ms(lambda: conv1_pool(btp, w1p, b1p), iters=20),
                "plain_ms": device_ms(lambda: conv1_pool_plain(btp, w1p, b1p), reps=5),
                "library_ms": device_ms(lambda: F.max_pool2d(
                    plain.block_1(a0), 2, 2, ceil_mode=True), reps=10),
                "bytes": nbytes, "operations": ops,
                "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, bound_ops),
                "bound_by": "bytes" if nbytes / H100_BYTES_PER_S >= bound_ops
                else "operations",
            }
            row = out[name]
            row["tflop_per_s"] = ops / row["ms"] / 1e9
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            if name == "bf16":
                row.update(agree)
        del fused, plain, stems, btp, got, want, a0
        torch.cuda.empty_cache()
    emit("conv1_pool", shapes=f"btp [{b},{h},{q},128] channels-last view, w1p "
         f"[3,128,128], b1p [128] f32 -> [{b},{h // 2},{q},64]", tf32=False,
         library="unfused cuDNN block_1 (conv + BN + ReLU) then max_pool2d", **out)
    bf = out["bf16"]
    return {"name": "conv1_pool", "route": "cuda",
            "source": "hyperpose_torch/csrc/conv1_pool.cu",
            "replaces": "hyperpose_tpu/ops/pallas/stem_kernel.py:90",
            **{k: bf[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")}}


def phase_stem_gemm() -> tuple[dict, int]:
    """The stem's bf16 GEMM (`stem_gemm`, no masks, no pool) at the TPU
    probe's strip shape, G = 64 strips of (9936, 384) @ (384, 128): the
    serving batch's 635,904 rows. Held against its plain version (and at
    ragged row counts around its 128-row tile), timed against `torch.matmul`
    on the same bf16 operands. It is on no serving path, so its launches are
    counted here. Returns its row and launches."""
    import torch
    from hyperpose_torch.ops.kernels.conv1_pool import stem_gemm, stem_gemm_plain
    from torch_measures import bf16_agreement

    g, m, k, n = 64, 9936, 384, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((g, m, k), device="cuda", generator=gen).to(torch.bfloat16)
    w = (0.05 * torch.randn((k, n), device="cuda", generator=gen)).to(torch.bfloat16)
    edges = {}
    for rows in (1, 127, 128, 129, 1000):
        e = stem_gemm(a[0, :rows][None].contiguous(), w)
        ew = stem_gemm_plain(a[0, :rows][None], w)
        edges[rows] = bf16_agreement(
            e, ew, torch.matmul(a[0, :rows].float().abs(), w.float().abs()))
        check(edges[rows]["max_ulps_beyond_sum_order"] <= 1,
              f"stem_gemm M={rows} vs plain: {edges[rows]}")
    stem_gemm.launches = 0
    got = stem_gemm(a, w)
    launches = stem_gemm.launches
    want = stem_gemm_plain(a, w)
    library = torch.matmul(a, w)
    torch.cuda.synchronize()
    scale = torch.matmul(a.float().abs(), w.float().abs())
    agree = bf16_agreement(got, want, scale)
    err = float((got.float() - want.float()).abs().max())
    check(agree["max_ulps_beyond_sum_order"] <= 1, f"stem_gemm vs plain: {agree}")
    ops = 2 * g * m * k * n
    nbytes = 2 * (a.numel() + w.numel() + got.numel())
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_BF16_OPS_PER_S
    row = {
        "name": "stem_gemm", "route": "cuda",
        "source": "hyperpose_torch/csrc/stem_gemm.cu",
        "replaces": "scripts/probe_mosaic_matmul.py:27",
        "max_abs_err": err,
        "ms": device_ms(lambda: stem_gemm(a, w), reps=20),
        "plain_ms": device_ms(lambda: stem_gemm_plain(a, w), reps=5),
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(lambda: torch.matmul(a, w), reps=20),
    }
    emit("stem_gemm", shapes=f"a [{g},{m},{k}] bf16 @ w [{k},{n}] bf16 -> [{g},{m},{n}]",
         launches=launches, **agree, library_vs_plain=bf16_agreement(library, want, scale),
         ragged_rows=edges, bytes=nbytes, operations=ops, kernel_ms=row["ms"],
         tflop_per_s=ops / row["ms"] / 1e9, library_tflop_per_s=ops / row["library_ms"] / 1e9,
         share_of_bound=row["bound_ms"] / row["ms"],
         library_share_of_bound=row["bound_ms"] / row["library_ms"],
         call_ms=call_ms(lambda: stem_gemm(a, w), iters=20),
         **{k_: row[k_] for k_ in ("max_abs_err", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")})
    return row, launches


def phase_decode(limbs, **cfg) -> dict:
    """Painted two-person maps decoded on the card and on the CPU; returns
    the kernel launches of the card's decode. With the default front end it
    also traces the limb scoring: one kernel, `limb_scores`, and nothing
    else on the card."""
    import torch
    from hyperpose_torch.ops import paf_decode as PD
    from hyperpose_torch.ops.kernels.line_gather import limb_scores
    from hyperpose_torch.ops.kernels.peak_topk import peak_candidates, peak_topk

    conf, paf = make_synthetic_maps(TWO_PEOPLE, limbs)
    conf = np.repeat(conf[None], BATCH, axis=0)
    paf = np.repeat(paf[None], BATCH, axis=0)
    cfg = PD.PafDecoderConfig(**cfg)
    kernels = (limb_scores, peak_topk, peak_candidates)
    for k in kernels:
        k.launches = 0
    gpu = PD.paf_decode_batch(torch.from_numpy(conf).cuda(),
                              torch.from_numpy(paf).cuda(), cfg)
    launches = {k.__name__: k.launches for k in kernels}
    cpu = PD.paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf), cfg)
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
    extra = {}
    if not cfg.use_pallas_peaks:
        conf_c, paf_c = torch.from_numpy(conf).cuda(), torch.from_numpy(paf).cuda()
        xy, _, valid = PD.find_peaks(conf_c[..., :cfg.n_parts], cfg)
        pairs = PD._limb_pairs(PD.COCO_TOPOLOGY)
        _, n_kernels = device_busy(lambda: PD._limb_pair_scores(paf_c, xy, valid, pairs, cfg))
        check(n_kernels == 1, f"the limb scoring launched {n_kernels} kernels, not 1")
        extra["limb_pair_scores_kernels"] = n_kernels
    name = "decode_pallas_peaks" if cfg.use_pallas_peaks else "decode"
    emit(name, humans=humans.tolist(), max_abs_dcoords=d_coords,
         max_abs_dscores=d_scores, tolerance={"coords": 1e-5, "scores": 1e-3},
         launches=launches, **extra)
    return launches


def _launch_counters():
    from hyperpose_torch.ops.kernels.conv1_pool import conv1_pool, stem_gemm
    from hyperpose_torch.ops.kernels.grow import fused_grow
    from hyperpose_torch.ops.kernels.int8_gemm import (
        int8_conv, int8_dwconv, int8_gemm, int8_quantize,
    )
    from hyperpose_torch.ops.kernels.line_gather import limb_scores
    from hyperpose_torch.ops.kernels.peak_topk import peak_candidates, peak_topk

    return (limb_scores, peak_topk, peak_candidates, conv1_pool, fused_grow, stem_gemm,
            int8_gemm, int8_quantize, int8_conv, int8_dwconv)


def drive(engine, frames) -> tuple[list, dict]:
    """One `inference` call with every kernel count set to 0 just before it;
    returns its results and the counts read just after."""
    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    results = engine.inference(frames)
    return results, {k.__name__: k.launches for k in counters}


def phase_end_to_end(frames, card) -> dict:
    """Each serving form of the flagship in f32 (TF32 off) and bf16: the
    main path once with its kernel counts, then step / network / decode
    timings. Returns the launch counts of each (stem, dtype) path."""
    import torch
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.ops.paf_decode import paf_decode_batch
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.runtime.engine import PoseEngine
    from torch_measures import conv_operations

    batch = torch.from_numpy(
        np.stack([resize_bilinear(f, INPUT_HW) for f in frames])).cuda()
    paths, timing = {}, {}
    for stem in ("plain", "s2d", "fused"):
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            model, weights = _stem_model(stem, dtype)
            eng = PoseEngine(model, weights, max_batch_size=BATCH, device="cuda")
            warm_s = eng.warmup()
            results, launches = drive(eng, frames)
            key = f"{stem}_{name}"
            paths[key] = launches
            check(launches["limb_scores"] == launches["peak_topk"] > 0,
                  f"{key}: the main path skipped a decoder kernel: {launches}")
            check((launches["conv1_pool"] > 0) == (stem == "fused"),
                  f"{key}: conv1_pool launches {launches['conv1_pool']}")
            check(launches["fused_grow"] == 0, f"{key}: the PAF path launched grow")
            scores = [hm.score for hm in results[0]]
            check(len(scores) == 2, f"{key}: synthetic frame: {len(scores)} humans")
            for res in results:
                for hm in res:
                    xy = np.array([(p.x, p.y) for p in hm.parts.values()])
                    check(bool(np.isfinite(xy).all() and np.isfinite(hm.score)),
                          f"{key}: non-finite output")
            if name == "f32":
                d = float(np.abs(np.array(scores) - np.array(FLAGSHIP_SCORES)).max())
                check(d <= 1e-3, f"{key}: scores {scores} vs {FLAGSHIP_SCORES}")

            with torch.inference_mode():
                maps = eng.model(batch.to(dtype) / 255.0)
                conf = maps["conf_map"].float()
                paf = maps["paf_map"].float()
            stages = {
                "step": lambda: eng.infer_batch_device(batch),
                "network": lambda: eng.model(batch.to(dtype) / 255.0),
                "decode": lambda: paf_decode_batch(conf, paf, eng.decoder),
            }
            row = {"warmup_s": warm_s, "scores": scores, "launches": launches}
            for stage, fn in stages.items():
                with torch.inference_mode():
                    row[f"{stage}_ms"], row[f"{stage}_p80_ms"] = wall_ms(fn)
                    busy, kernels = device_busy(fn)
                row[f"{stage}_device_busy_ms"] = busy
                row[f"{stage}_kernels"] = kernels
            row.update(frames_per_s=1e3 * BATCH / row["step_ms"],
                       device_idle_share=1.0 - row["step_device_busy_ms"]
                       / row["step_ms"])
            timing[key] = row
            del eng, model, maps, conf, paf
            torch.cuda.empty_cache()

    # The plain f32 form on the CPU (plain versions): the same two people.
    model, weights = _stem_model("plain", torch.float32)
    cpu = PoseEngine(model, weights, max_batch_size=1, device="cpu")
    cpu_scores = [hm.score for hm in cpu.inference([frames[0]])[0]]
    check(len(cpu_scores) == 2, f"CPU run: {len(cpu_scores)} humans")
    d_score = float(np.abs(np.array(timing["plain_f32"]["scores"])
                           - np.array(cpu_scores)).max())
    check(d_score <= 1e-3, f"GPU vs CPU human scores differ by {d_score}")
    emit("end_to_end", card=card, input="x".join(map(str, INPUT_HW)), batch=BATCH,
         tf32=False, wall_samples=50, cpu_scores=cpu_scores,
         conv_gflop_per_batch=conv_operations(LightWeightOpenPose(backbone=VggTiny),
                                              (BATCH, *INPUT_HW, 3)) / 1e9,
         max_abs_dscore_plain_f32_vs_cpu=d_score, **timing)
    return paths


def phase_stream(rng, card) -> dict:
    """`StreamProcessor` over the bf16 fused-stem engine: 20 frames (the
    synthetic one, then random camera-sized frames) come back in order, on
    the native queues, and frame 0 has the humans `inference` finds."""
    import torch
    from hyperpose_torch.runtime import native
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.runtime.stream import StreamProcessor

    model, weights = _stem_model("fused", torch.bfloat16)
    eng = PoseEngine(model, weights, max_batch_size=BATCH, device="cuda")
    eng.warmup()
    frames = _frames(rng)[:1] + [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                                 for _ in range(19)]
    want = eng.inference(frames[:1])[0]
    check(native.get_lib() is not None,
          f"the native runtime did not build: {native.build_error}")
    sp = StreamProcessor(eng)
    check(sp.native, "the stream runs on the Python queues, not the native ones")
    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    out = list(sp.process(iter(frames)))
    secs = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    check([r.index for r in out] == list(range(20)),
          f"stream order {[r.index for r in out]}")
    check(all(r.frame is f for r, f in zip(out, frames)), "stream mixed up frames")
    got = out[0].humans
    check(len(got) == len(want) == 2, f"stream frame 0: {len(got)} humans, "
          f"inference: {len(want)}")
    d_score = max(abs(g.score - w.score) for g, w in zip(got, want))
    d_xy = max(abs(g.parts[p].x - part.x) + abs(g.parts[p].y - part.y)
               for g, w in zip(got, want) for p, part in w.parts.items())
    check(all(sorted(g.parts) == sorted(w.parts) for g, w in zip(got, want))
          and d_score <= 1e-3 and d_xy <= 1e-4,
          f"stream frame 0 differs from inference: |dscore| {d_score}, |dxy| {d_xy}")
    check(launches["conv1_pool"] > 0, f"stream skipped conv1_pool: {launches}")
    emit("stream", card=card, engine="fused bf16", batch=BATCH, frames=len(out),
         ordered=True, native_queue=sp.native,
         native_library=str(native.library_path().relative_to(REPO)),
         seconds=secs, frames_per_s=len(out) / secs, launches=launches,
         frame0_scores=[g.score for g in got], max_abs_dscore_vs_inference=d_score)
    return launches

# -- PifPaf -----------------------------------------------------------------------

PAF_PATH_KERNELS = (  # the flagship path's kernels: none may launch on PifPaf's
    "limb_scores", "peak_topk", "peak_candidates", "conv1_pool")


def phase_pifpaf_decode(card) -> None:
    """Painted two-person composite fields at batch 8 on the card: 2 humans
    on every frame, the growth kernel launched once and no PAF-decoder
    kernel, and the humans the port decodes on the CPU."""
    import torch
    from hyperpose_torch.ops.pifpaf_decode import pifpaf_decode_batch

    fields = painted_pifpaf_batch()
    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    gpu = pifpaf_decode_batch({k: torch.from_numpy(v).cuda() for k, v in fields.items()})
    gpu = _numpy(gpu)
    launches = {k.__name__: k.launches for k in counters}
    cpu = _numpy(pifpaf_decode_batch(fields))
    humans = gpu["valid"].sum(axis=1)
    check(bool((humans == 2).all()), f"pifpaf decode found {humans.tolist()} humans, not 2")
    check(launches["fused_grow"] == 1 and not any(launches[k] for k in PAF_PATH_KERNELS),
          f"pifpaf decode launches {launches}")
    d_xy, d_s = human_deltas(gpu, cpu)
    check(d_xy <= 1e-5 and d_s <= 1e-5, f"pifpaf decode vs CPU: |dxy| {d_xy}, |dscore| {d_s}")
    emit("pifpaf_decode", card=card, fields=f"painted, [{BATCH},46,54,17/19]",
         humans=humans.tolist(), launches=launches, max_abs_dcoords_vs_cpu=d_xy,
         max_abs_dscores_vs_cpu=d_s, tolerance={"coords": 1e-5, "scores": 1e-5})


def _pifpaf_engine(weights, dtype, device="cuda", batch=BATCH):
    from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY

    model = Pifpaf(dtype=dtype)
    return PoseEngine(model, weights, max_batch_size=batch, device=device,
                      topology=PIFPAF_TOPOLOGY, fused_decode=pifpaf_fused_decode(model))


def _pifpaf_decode(eng, out, grow_backend="auto"):
    from hyperpose_torch.ops.pifpaf_decode import PifPafDecoderConfig, pifpaf_decode_batch

    return pifpaf_decode_batch(out, PifPafDecoderConfig(grow_backend=grow_backend), 8, INPUT_HW)


def _pifpaf_checks(eng, out, key) -> dict:
    """The decode with the grow kernel equals the plain growth's on the same
    fields."""
    got, want = _numpy(_pifpaf_decode(eng, out)), _numpy(_pifpaf_decode(eng, out, "xla"))
    check(all(np.array_equal(got[k], want[k]) for k in got),
          f"{key}: the decode with the grow kernel differs from grow_backend='xla'")
    return {"decode_kernel_equals_plain": True}


class Served(NamedTuple):
    """One model family's serving path, as `phase_serving` drives it."""
    name: str                # the phase is f"{name}_end_to_end"
    about: str               # the model, for the phase's line
    hw: tuple                # the engine's input size
    model: Callable          # () -> the float32 model (for its weights and conv work)
    engine: Callable         # (weights, dtype, device="cuda", batch=BATCH) -> PoseEngine
    decode: Callable         # (engine, network outputs) -> DecodedSkeletons
    check_decode: Callable   # (engine, outputs on the card, key) -> dict; fails on a mismatch
    kernels: tuple           # the hand-written kernels its decode launches
    n_int8: int = 0          # the int8 convs of its network
    n_dw: int = 0            # of which depthwise (`int8_dwconv`)
    cpu_frames: int = BATCH  # the frames whose f32 outputs are held against the CPU
    raised_biases: tuple = ()    # weight leaves raised by 1 (`served_weights`)


def served_weights(spec: Served) -> dict:
    """The weights a served model runs on: `random_flax_weights(model, 0)`
    (the repository has no trained checkpoint of these models), with each
    leaf of `spec.raised_biases` (the last stage's output biases) raised by
    1, so that its maps hold peaks and limbs above the PAF decoder's
    thresholds and the decode assembles people, as the CPU parity tests do
    (tests/test_torch_openpose_family.py)."""
    from hyperpose_torch.utils.weights import random_flax_weights

    weights = random_flax_weights(spec.model(), seed=0)
    for leaf in spec.raised_biases:
        weights[f"params/{leaf}"] += np.float32(1.0)
    return weights


def _pifpaf_model():
    from hyperpose_torch.models.pifpaf import Pifpaf
    return Pifpaf()


PIFPAF = Served("pifpaf", "Pifpaf (Resnet50, stride 16)", INPUT_HW, _pifpaf_model,
                _pifpaf_engine, _pifpaf_decode, _pifpaf_checks, ("fused_grow",))


def phase_serving(spec: Served, forms, frames, card) -> tuple[dict, dict, list]:
    """One model family through `PoseEngine` at full width and depth on
    seeded random weights (`served_weights`; the repository has no trained
    checkpoint of these models), batch 8 (the synthetic frame
    and 7 random frames), in each of `forms`: "f32" (TF32 off), "bf16", and
    "int8" with bf16 activations (`quantize_engine` calibrated on the
    batch). For each: the main path once with its kernel counts (its
    decoder's kernels launched, no other; int8: `int8_quantize` and
    `int8_conv` once a dense conv, `int8_dwconv` once a depthwise one and
    no quantize pass before it), finite humans and outputs, the f32 outputs of the first
    `spec.cpu_frames` frames against the CPU (max |d| <= 1e-3 max |v| per
    output), the family's own check of its decode on the card's outputs,
    every int8 conv exact against its plain version and a CPU copy on the
    card's input, then step / network / decode wall and device timings.
    Returns the launches of each form, the f32 outputs, and (spec.name,
    conv, its input) of every depthwise int8 conv of the int8 step (for
    `phase_int8_dwconv`)."""
    import torch
    from torch import nn
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.quant import quantize_engine
    from torch_measures import conv_operations

    int8_kernels = ("int8_conv", "int8_quantize", "int8_gemm", "int8_dwconv")
    weights = served_weights(spec)
    batch = torch.from_numpy(np.stack([resize_bilinear(f, spec.hw) for f in frames])).cuda()
    paths, timing, out32, dw = {}, {}, None, []
    for form in forms:
        key = f"{spec.name}_{form}"
        dtype = torch.float32 if form == "f32" else torch.bfloat16
        eng, row = spec.engine(weights, dtype), {}
        n_int8, n_dw = (spec.n_int8, spec.n_dw) if form == "int8" else (0, 0)
        if form == "int8":
            t0 = time.perf_counter()
            eng = quantize_engine(eng, [batch])
            torch.cuda.synchronize()
            row["quantize_engine_s"] = time.perf_counter() - t0
            check(len(eng.quant_scales) == n_int8
                  and not any(type(m) is nn.Conv2d for m in eng.model.modules()),
                  f"{key}: {len(eng.quant_scales)} int8 convs, not {n_int8}")
        row["warmup_s"] = eng.warmup()
        results, launches = drive(eng, frames)
        paths[form] = launches
        check(launches["int8_quantize"] == n_int8 - n_dw and launches["int8_dwconv"] == n_dw
              and launches["int8_conv"] == n_int8 - n_dw and launches["int8_gemm"] == 0
              and all((n > 0) == (k in spec.kernels)
                      for k, n in launches.items() if k not in int8_kernels),
              f"{key}: launches {launches}, not {spec.kernels} and {n_int8} int8 convs "
              f"({n_dw} depthwise)")
        for res in results:
            for hm in res:
                xy = np.array([(p.x, p.y) for p in hm.parts.values()])
                check(bool(np.isfinite(xy).all() and np.isfinite(hm.score)),
                      f"{key}: non-finite output")
        row.update(launches=launches, humans=[len(r) for r in results])

        def network():
            return eng.model(batch.to(dtype) / 255.0)

        with torch.inference_mode():
            out = network()
            check(all(bool(torch.isfinite(v).all()) for v in out.values() if torch.is_tensor(v)),
                  f"{key}: non-finite network outputs")
            if form == "f32":
                out32, n = out, spec.cpu_frames
                ref = spec.engine(weights, torch.float32, device="cpu").model(
                    batch[:n].cpu().to(torch.float32) / 255.0)
                rel = {k: float((out[k][:n].cpu() - v).abs().max() / v.abs().max())
                       for k, v in ref.items() if torch.is_tensor(v)}
                check(max(rel.values()) <= 1e-3,
                      f"{key}: f32 outputs vs CPU, max |d| / max |v|: {rel}")
                row["outputs_vs_cpu_max_rel"] = rel
                del ref
            row.update(spec.check_decode(eng, out, key))
            if form == "int8":
                seen = _record_int8_inputs(eng.model, network)
                check(len(seen) == n_int8, f"{key}: {len(seen)} int8 convs ran in one step")
                _convs_equal_plain(seen, key)
                row["convs_equal_to_plain_and_cpu"] = _convs_card_vs_cpu(seen, key)
                row["conv_couts"] = sorted({c.out_channels for c, _ in seen})
                dw = [(spec.name, c, x) for c, x in seen if c.depthwise]
                del seen
            stages = {"step": lambda: eng.infer_batch_device(batch), "network": network,
                      "decode": lambda: spec.decode(eng, out)}
            for stage, fn in stages.items():
                row[f"{stage}_ms"], row[f"{stage}_p80_ms"] = wall_ms(fn)
                row[f"{stage}_device_busy_ms"], row[f"{stage}_kernels"] = device_busy(fn)
        row.update(frames_per_s=1e3 * BATCH / row["step_ms"],
                   device_idle_share=1.0 - row["step_device_busy_ms"] / row["step_ms"])
        timing[form] = row
        del eng, out, results
        torch.cuda.empty_cache()
    emit(f"{spec.name}_end_to_end", card=card, model=spec.about + ", seeded random weights",
         input="x".join(map(str, spec.hw)), batch=BATCH, tf32=False, wall_samples=50,
         int8_activations="bf16", outputs_tolerance="max |d| <= 1e-3 * max |v| per f32 "
         "output", cpu_frames=spec.cpu_frames, conv_gflop_per_batch=conv_operations(
             spec.model(), (BATCH, *spec.hw, 3)) / 1e9, **timing)
    return paths, out32, dw


def phase_grow(fields32) -> dict:
    """The growth kernel against its plain version on the tables the decoder
    prepares from painted two-person fields (every seed slot live, so the
    skeletons grow to full size) and from the full-size network's f32
    outputs (the main path's inputs), batch 8: zero mismatches. Both are
    timed, each beside the evaluations and bytes its data needs
    (`torch_measures.grow_work`); the kernel row is the network's."""
    import torch
    from hyperpose_torch.ops import pifpaf_decode as D
    from hyperpose_torch.ops.kernels.grow import fused_grow, fused_grow_plain
    from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY
    from torch_measures import grow_work

    cfg = D.PifPafDecoderConfig()

    def inputs(fields):
        with torch.inference_mode():
            maps = D.restore_maps(fields, 8)
            return D.grow_inputs(D._prepare(maps, cfg, PIFPAF_TOPOLOGY), cfg, PIFPAF_TOPOLOGY)

    painted = {k: torch.from_numpy(v).cuda() for k, v in painted_pifpaf_batch().items()}
    cases = {"painted": inputs(painted), "network": inputs(fields32)}
    b, mh = cases["network"][0].shape
    e, k = cases["network"][2][0].shape[1:]
    p, steps, rev = cases["network"][6:9]
    mismatches, timed = {}, {}
    for name, args in cases.items():
        got = fused_grow(*args)
        want = fused_grow_plain(*args)
        torch.cuda.synchronize()
        mismatches[name] = sum(int((g != w).sum()) for g, w in zip(got, want))
        check(mismatches[name] == 0, f"grow {name}: {mismatches[name]} values differ from plain")
        check(float(got[0].max()) > 0, f"grow {name}: no annotation grew")
        work = grow_work(args)
        ops = 21 * work["evaluations"]  # ~20 f32 operations and one expf each
        t_bytes, t_ops = work["bytes"] / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
        ms = device_ms(lambda: fused_grow(*args), reps=20)
        t = timed[name] = {
            "live_seed_slots": int((args[1][..., 3] > 0).sum()),
            "kernel_ms": ms, "call_ms": call_ms(lambda: fused_grow(*args), iters=20),
            "plain_ms": device_ms(lambda: fused_grow_plain(*args), reps=3, replays=3),
            "evaluations": work["evaluations"],
            "evaluations_dense": b * mh * steps * e * k * (2 if rev else 1),
            "operations": ops, "bytes": work["bytes"],
            "bytes_all_tables": 4 * (12 * b * e * k + 5 * b * mh + 4 * b * mh * p),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        t.update(evaluations_per_s=t["evaluations"] / ms * 1e3,
                 share_of_bound=t["bound_ms"] / ms)
    emit("grow", shapes=f"seeds [{b},{mh}], 12 tables [{b},{e},{k}] f32, P={p}, "
         f"{steps} rounds, reverse_match={rev} -> 4 x [{b},{mh},{p}]",
         mismatches=mismatches, library_ms=None, **timed)
    net = timed["network"]
    return {"name": "grow", "route": "cuda", "source": "hyperpose_torch/csrc/grow.cu",
            "replaces": "hyperpose_tpu/ops/pallas/grow_kernel.py:199",
            "max_abs_err": 0.0, "ms": net["kernel_ms"], "library_ms": None,
            **{k_: net[k_] for k_ in ("plain_ms", "bound_ms", "bound_by")}}


# -- int8 serving -------------------------------------------------------------------

H100_INT8_OPS_PER_S = 1979e12  # int8 tensor cores, dense
PROBE_MKN = (4096, 1792, 256)  # scripts/probe_int8_pallas.py:30


def _gemm_work(m: int, n: int, k: int, bf16: bool) -> tuple[int, int, float, str]:
    """(bytes, operations, bound ms, what binds) of one [M, K] x [N, K]^T
    product: each operand read once, the 4-byte result written once."""
    nbytes = (2 if bf16 else 1) * (m * k + n * k) + 4 * m * n
    ops = 2 * m * n * k
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / (H100_BF16_OPS_PER_S if bf16 else H100_INT8_OPS_PER_S)
    return nbytes, ops, 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _int_mm(a, bt):
    """The library's s8 x s8 -> s32 product of the same operands:
    `torch._int_mm` takes N only in multiples of 8, so Bt gets zero rows."""
    import torch

    n = bt.shape[0]
    if n % 8:
        bt = torch.cat([bt, bt.new_zeros((8 - n % 8, bt.shape[1]))])
    return lambda: torch._int_mm(a, bt.T)[:, :n]


def phase_int8_gemm() -> None:
    """`int8_gemm` at the TPU probe's shape, (4096, 1792) @ (1792, 256), in
    both its types: each against its plain version, each timed (CUDA-graph
    replay) beside the library call -- `torch._int_mm` for s8,
    `torch.mm(out_dtype=torch.float32)` for bf16 -- with TOP/s, the share of
    the bound, and the s8/bf16 ratio the probe prints."""
    import torch
    from hyperpose_torch.ops.kernels.int8_gemm import int8_gemm, int8_gemm_plain
    from torch_measures import sum_order

    m, k, n = PROBE_MKN
    gen = torch.Generator(device="cuda").manual_seed(1)
    ints = lambda *shape: torch.randint(  # noqa: E731
        -127, 128, shape, device="cuda", generator=gen, dtype=torch.int16).to(torch.int8)
    bf = lambda *shape: torch.randn(  # noqa: E731
        shape, device="cuda", generator=gen).to(torch.bfloat16)
    out = {}
    for name, a, bt in (("s8", ints(m, k), ints(n, k)), ("bf16", bf(m, k), bf(n, k))):
        got, want = int8_gemm(a, bt), int8_gemm_plain(a, bt)
        if name == "s8":
            library, lib_name = _int_mm(a, bt), "torch._int_mm"
            check(bool(torch.equal(got, want)), "int8_gemm s8 differs from its plain version")
            check(bool(torch.equal(library(), want)), "torch._int_mm differs from the plain version")
        else:
            library = lambda: torch.mm(a, bt.T, out_dtype=torch.float32)  # noqa: E731
            lib_name = "torch.mm(out_dtype=float32)"
            slack = sum_order(k) * torch.matmul(a.float().abs(), bt.float().abs().T)
            check(bool(((got - want).abs() <= slack).all()),
                  "int8_gemm bf16 beyond the float32 sum-order slack of its plain version")
        torch.cuda.synchronize()
        nbytes, ops, bound, by = _gemm_work(m, n, k, name == "bf16")
        row = out[name] = {
            "max_abs_err": float((got.double() - want.double()).abs().max()),
            "kernel_ms": device_ms(lambda: int8_gemm(a, bt), reps=50),
            "plain_ms": device_ms(lambda: int8_gemm_plain(a, bt), reps=10),
            "library": lib_name, "library_ms": device_ms(library, reps=50),
            "call_ms": call_ms(lambda: int8_gemm(a, bt)),
            "bytes": nbytes, "operations": ops, "bound_ms": bound, "bound_by": by,
        }
        row.update(tera_ops_per_s=ops / row["kernel_ms"] / 1e9,
                   library_tera_ops_per_s=ops / row["library_ms"] / 1e9,
                   share_of_bound=bound / row["kernel_ms"])
    ratio = {"kernel": out["s8"]["tera_ops_per_s"] / out["bf16"]["tera_ops_per_s"],
             "library": out["s8"]["library_tera_ops_per_s"]
             / out["bf16"]["library_tera_ops_per_s"]}
    emit("int8_gemm", shapes=f"a [{m},{k}] @ bt [{n},{k}]^T -> [{m},{n}] (s8 -> s32, "
         "bf16 -> f32)", s8_over_bf16=ratio, **out)


def _record_int8_inputs(model, forward) -> list:
    """(Int8Conv2d, its input) for every int8 conv of one `forward()`."""
    from hyperpose_torch.quant import Int8Conv2d

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args[0])))
             for m in model.modules() if isinstance(m, Int8Conv2d)]
    try:
        forward()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _convs_card_vs_cpu(seen, key: str) -> int:
    """Every int8 conv of one step, run on the card, equals a CPU copy of
    it on the same input: quantize, the conv's s32 sums and the dequantize
    + bias epilogue, exactly. The first image of the batch stands for the
    batch (each output row depends on its own image only), to keep the
    CPU's share short. Returns the number of convs compared."""
    import torch

    for i, (conv, x) in enumerate(seen):
        want = copy.deepcopy(conv).cpu()(x[:1].cpu())
        got = conv(x)[:1].cpu()
        check(got.dtype == want.dtype and bool(torch.equal(got, want)),
              f"int8 {key}: conv {i} ({tuple(x.shape)} -> {tuple(want.shape)}) differs "
              f"on the card from the CPU by up to {float((got.float() - want.float()).abs().max())}")
    return len(seen)


def _convs_equal_plain(seen, key: str) -> tuple[list, list]:
    """Each conv's kernels equal their plain version on its own input: a
    dense conv's `int8_conv` on its quantized input, a depthwise conv's
    fused `int8_dwconv` on the float input (against the quantize's and the
    conv's plain versions in turn). Returns the quantized inputs (a
    depthwise conv's from the plain quantize) and the plain outputs."""
    import torch
    from hyperpose_torch.ops.kernels.int8_gemm import int8_quantize_plain

    xqs, wants = [], []
    for c, x in seen:
        if c.depthwise:
            xq = int8_quantize_plain(x, c.inv_s, c.w_taps.shape[-1])
            got = c.rows(x)
        else:
            xq = c.quantize(x)
            got = c.conv(xq, x.dtype)
        want = c.conv_plain(xq, x.dtype)
        check(bool(torch.equal(got, want)),
              f"{key}: {'int8_dwconv' if c.depthwise else 'int8_conv'} differs from its "
              f"plain version at {tuple(x.shape)} -> {c.out_channels} ({c.kernel_size}, "
              f"stride {c.stride}, dilation {c.dilation})")
        xqs.append(xq)
        wants.append(want)
    return xqs, wants


def _unfused_conv(conv, xq, dtype):
    """The conv as the int8 path ran it before the implicit-GEMM kernel, on
    the library's int8 GEMM: the explicit im2col [M, kh*kw*Cp], then
    `torch._int_mm` (s32), then the dequantize + bias in float32 and the
    cast, each its own pass."""
    import torch
    from hyperpose_torch.ops.kernels.int8_gemm import int8_im2col_plain

    a = int8_im2col_plain(xq, conv.w_taps.shape[1:3], *conv.taps_geometry)
    acc = _int_mm(a, conv.w_q)()[:, :conv.out_channels]
    y = acc.to(torch.float32).mul_(conv.dq)
    if conv.bias is not None:
        y.add_(conv.bias)
    return y.to(dtype)


def _conv_work(conv, x, xq) -> tuple[int, int, int]:
    """(conv bytes, conv operations, quantize bytes) of one int8 conv on
    input x and its quantized buffer xq: the conv reads xq (channels padded;
    for a folded conv, its taps along the channels) once and the padded
    weights once and writes its output once in x's dtype, against
    2 * M * cout * kh * kw * cin operations; the quantize reads x once and
    writes xq once."""
    b, cin, h, w = x.shape
    ho, wo = conv.out_hw(h, w)
    m, (kh, kw) = b * ho * wo, conv.kernel_size
    c_bytes = xq.numel() + conv.w_q.numel() + 8 * conv.out_channels \
        + m * conv.out_channels * x.element_size()
    return (c_bytes, 2 * m * conv.out_channels * kh * kw * cin,
            x.numel() * x.element_size() + xq.numel())


def _float_weight(conv):
    """The conv's weights as float32 OIHW, s_w * w_q."""
    (kh, kw), cin, cout = conv.kernel_size, conv.in_channels, conv.out_channels
    w = conv.w_q[:cout].float()
    w = (w[:, :kh * kw * cin].view(cout, kh, kw, cin) if conv.folded
         else w.view(cout, kh, kw, -1)[..., :cin])
    return (w * conv.s_w[:, None, None, None]).permute(0, 3, 1, 2)


def _int8_breakdown(seen) -> dict:
    """Device ms of the int8 convs of one step, each stage summed over every
    conv (one CUDA graph per stage replays it for all of them): the two
    kernels (`quantize`, `conv`), the unfused path they replace (the
    quantize's plain version, then `_unfused_conv`), and the bf16 cuDNN
    convs of the same layers (weights s_w * w_q, channels-last input), with
    the bounds of the kernels' work."""
    import torch
    import torch.nn.functional as F
    from hyperpose_torch.ops.kernels.int8_gemm import int8_quantize_plain

    xqs = [c.quantize(x) for c, x in seen]
    dts = [x.dtype for _, x in seen]
    bf16 = [(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
             _float_weight(c).to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
             None if c.bias is None else c.bias.to(torch.bfloat16)) for c, x in seen]
    stages = {
        "quantize": lambda: [c.quantize(x) for c, x in seen],
        "conv": lambda: [c.conv(xq, dt) for (c, _), xq, dt in zip(seen, xqs, dts)],
        "unfused_quantize": lambda: [int8_quantize_plain(x, c.inv_s, c.w_taps.shape[3], c.fold)
                                     for c, x in seen],
        "unfused_conv": lambda: [_unfused_conv(c, xq, dt)
                                 for (c, _), xq, dt in zip(seen, xqs, dts)],
        "cudnn_bf16_conv": lambda: [F.conv2d(x, w, b, c.stride, c.padding, c.dilation)
                                    for (c, _), (x, w, b) in zip(seen, bf16)],
    }
    out = {f"{k}_device_ms": device_ms(fn, reps=2, replays=2) for k, fn in stages.items()}
    work = [_conv_work(c, x, xq) for (c, x), xq in zip(seen, xqs)]
    t_bytes = sum(w[0] for w in work) / H100_BYTES_PER_S
    t_ops = sum(w[1] for w in work) / H100_INT8_OPS_PER_S
    out.update(conv_bytes=sum(w[0] for w in work), conv_operations=sum(w[1] for w in work),
               conv_bound_ms=1e3 * max(t_bytes, t_ops),
               conv_bound_by="bytes" if t_bytes >= t_ops else "operations",
               quantize_bytes=sum(w[2] for w in work),
               quantize_bound_ms=1e3 * sum(w[2] for w in work) / H100_BYTES_PER_S)
    return out


def _main_path_convs(seen, breakdown) -> dict:
    """`int8_conv` at every shape one step gives it, on the step's own
    quantized inputs: each exact against its plain version (and so is the
    unfused yardstick); the step's convs
    timed together (kernel and plain) beside the sum of their bounds. The
    library yardstick is the unfused path on `torch._int_mm` (PyTorch has no
    int8 conv on CUDA); the GEMM-only bound of that path (A the explicit
    im2col, C in s32) is given beside, for it is not like for like."""
    import torch
    from hyperpose_torch.ops.kernels.int8_gemm import int8_conv_plain

    xqs, wants = _convs_equal_plain(seen, "int8 plain_bf16")
    args = [(xq, c.w_taps, c.dq, c.bias, *c.taps_geometry, x.dtype)
            for (c, x), xq in zip(seen, xqs)]
    for (c, x), xq, want in zip(seen, xqs, wants):
        check(bool(torch.equal(_unfused_conv(c, xq, x.dtype), want)),
              "the unfused path on torch._int_mm differs from the plain version")
    old_gemm = []
    for (c, x) in seen:
        ho, wo = c.out_hw(*x.shape[2:])
        old_gemm.append(_gemm_work(x.shape[0] * ho * wo, c.out_channels,
                                   -(-c.kernel_size[0] * c.kernel_size[1] * c.in_channels
                                     // 32) * 32, False))
    return {
        "convs": len(seen),
        "shapes": [[*x.shape, c.out_channels, *c.kernel_size, *c.stride, *c.padding]
                   for c, x in seen],
        "max_abs_err": 0.0,
        "ms": breakdown["conv_device_ms"],
        "plain_ms": device_ms(lambda: [int8_conv_plain(*a) for a in args], reps=1, replays=2),
        "library_ms": breakdown["unfused_conv_device_ms"],
        "bytes": breakdown["conv_bytes"], "operations": breakdown["conv_operations"],
        "bound_ms": breakdown["conv_bound_ms"], "bound_by": breakdown["conv_bound_by"],
        "unfused_gemm_only_bound_ms": sum(w[2] for w in old_gemm),
    }


def phase_int8_end_to_end(frames, card) -> tuple[dict, dict]:
    """The int8 serving path: `quantize_engine` calibrated on the 8 frames,
    for each flagship form in f32 (TF32 off) and bf16 and for PifPaf in
    bf16; the main path once with its kernel counts (every conv launches
    `int8_quantize` and `int8_conv` once and `int8_gemm` never; the fused
    stem `conv1_pool`, PifPaf `fused_grow`), then step / network / decode
    timings and the int8 convs' device times: the two kernels, the unfused
    path they replace, and the bf16 cuDNN convs of the same layers, beside
    the kernels' bounds. Every int8 conv of a step equals a CPU copy of it
    on the same input. The int8 f32 flagship finds the float engine's 2
    people on the synthetic frame and agrees with the same int8 engine on
    the CPU. Returns the kernel row of `int8_gemm.cu` (the conv, at the
    shapes of the bf16 plain-stem flagship's step), and that path's launch
    counts."""
    import torch
    from torch import nn
    from hyperpose_torch.models.pifpaf import Pifpaf
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.ops.paf_decode import paf_decode_batch
    from hyperpose_torch.ops.pifpaf_decode import PifPafDecoderConfig, pifpaf_decode_batch
    from hyperpose_torch.quant import quantize_engine
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.weights import random_flax_weights

    batch = torch.from_numpy(
        np.stack([resize_bilinear(f, INPUT_HW) for f in frames])).cuda()
    cases = [(stem, name, dtype) for stem in ("plain", "s2d", "fused")
             for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
    cases.append(("pifpaf", "bf16", torch.bfloat16))
    timing, row = {}, None
    for stem, name, dtype in cases:
        key = f"{stem}_{name}"
        if stem == "pifpaf":
            eng = _pifpaf_engine(random_flax_weights(Pifpaf(), seed=0), dtype)
        else:
            model, weights = _stem_model(stem, dtype)
            eng = PoseEngine(model, weights, max_batch_size=BATCH, device="cuda")
        t0 = time.perf_counter()
        qeng = quantize_engine(eng, [batch])
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t0
        float_humans = eng.inference(frames[:1])[0] if name == "f32" else None
        del eng
        torch.cuda.empty_cache()
        warm_s = qeng.warmup()
        results, launches = drive(qeng, frames)
        n_convs = len(qeng.quant_scales)
        check(n_convs == {"fused": 39, "pifpaf": 55}.get(stem, 40),
              f"int8 {key}: {n_convs} calibrated convs")
        check(not any(type(m) is nn.Conv2d for m in qeng.model.modules()),
              f"int8 {key}: a float conv is left")
        check(launches["int8_conv"] == n_convs and launches["int8_quantize"] == n_convs
              and launches["int8_gemm"] == 0,
              f"int8 {key}: {n_convs} convs launched int8_conv {launches['int8_conv']}, "
              f"int8_quantize {launches['int8_quantize']} and int8_gemm "
              f"{launches['int8_gemm']} times")
        check(launches["conv1_pool"] == (stem == "fused"),
              f"int8 {key}: conv1_pool launches {launches['conv1_pool']}")
        check((launches["fused_grow"] > 0) == (stem == "pifpaf")
              and (launches["limb_scores"] > 0) == (stem != "pifpaf"),
              f"int8 {key}: decoder launches {launches}")
        for res in results:
            for hm in res:
                xy = np.array([(p.x, p.y) for p in hm.parts.values()])
                check(bool(np.isfinite(xy).all() and np.isfinite(hm.score)),
                      f"int8 {key}: non-finite output")
        entry = {"quantize_engine_s": quantize_s, "warmup_s": warm_s, "launches": launches,
                 "humans": [len(r) for r in results],
                 "scores": [hm.score for hm in results[0]]}
        if float_humans is not None:
            found = find_people(float_humans, results[0])
            check(found is not None and found <= INT8_TOL["xy"],
                  f"int8 {key}: the float engine's people are not found: int8 parts "
                  f"{[sorted(g.parts) for g in results[0]]}, float "
                  f"{[sorted(w.parts) for w in float_humans]}")
            entry.update(float_scores=[w.score for w in float_humans],
                         max_abs_dxy_vs_float=found)
        if key == "plain_f32":
            # The same int8 engine (one scale table) on the CPU: it finds the
            # float engine's people too, and its maps lie within the int8
            # noise of the card's.
            cpu = PoseEngine(*_stem_model("plain", torch.float32), max_batch_size=1,
                             device="cpu", quant_scales=qeng.quant_scales)
            want = cpu.inference(frames[:1])[0]
            found = find_people(float_humans, want)
            check(found is not None and found <= INT8_TOL["xy"],
                  "int8 plain f32 on the CPU: the float engine's people are not found")
            with torch.inference_mode():
                x1 = batch[:1].to(dtype) / 255.0
                m_cpu, m_card = cpu.model(x1.cpu()), qeng.model(x1)
            rel = max(float((m_card[k].cpu() - m_cpu[k]).abs().max() / m_cpu[k].abs().max())
                      for k in ("conf_map", "paf_map"))
            check(rel <= INT8_TOL["maps"],
                  f"int8 plain f32, card vs CPU maps: max |d| / max |v| = {rel}")
            entry.update(cpu_scores=[w.score for w in want], cpu_max_abs_dxy_vs_float=found,
                         maps_vs_cpu_max_rel=rel)
            del cpu, m_cpu, m_card

        def network():
            return qeng.model(batch.to(dtype) / 255.0)

        with torch.inference_mode():
            maps = network()
            if stem == "pifpaf":
                cfg = PifPafDecoderConfig()
                decode = lambda: pifpaf_decode_batch(maps, cfg, 8, INPUT_HW)  # noqa: E731
            else:
                conf = maps["conf_map"].float()
                paf = maps["paf_map"].float()
                decode = lambda: paf_decode_batch(conf, paf, qeng.decoder)  # noqa: E731
            stages = {"step": lambda: qeng.infer_batch_device(batch),
                      "network": network, "decode": decode}
            for stage, fn in stages.items():
                entry[f"{stage}_ms"], entry[f"{stage}_p80_ms"] = wall_ms(fn, iters=10)
                busy, kernels = device_busy(fn, iters=3)
                entry[f"{stage}_device_busy_ms"] = busy
                entry[f"{stage}_kernels"] = kernels
            seen = _record_int8_inputs(qeng.model, network)
            entry["convs_equal_to_cpu"] = _convs_card_vs_cpu(seen, key)
            check(entry["convs_equal_to_cpu"] == n_convs,
                  f"int8 {key}: {entry['convs_equal_to_cpu']} convs ran in one step, not {n_convs}")
            breakdown = _int8_breakdown(seen)
            entry.update(breakdown)
            if key == "plain_bf16":
                row = _main_path_convs(seen, breakdown)
            del seen
        entry.update(frames_per_s=1e3 * BATCH / entry["step_ms"],
                     device_idle_share=1.0 - entry["step_device_busy_ms"] / entry["step_ms"])
        timing[key] = entry
        del qeng, maps, results
        torch.cuda.empty_cache()
    emit("int8_end_to_end", card=card, input="x".join(map(str, INPUT_HW)), batch=BATCH,
         tf32=False, wall_samples=10, calibration="the 8 frames of the batch",
         tolerance=INT8_TOL,
         main_path_convs={k: v for k, v in row.items() if k != "shapes"},
         main_path_conv_shapes_bchw_cout_kernel_stride_pad=row["shapes"], **timing)
    return {"name": "int8_gemm", "route": "cuda", "source": "hyperpose_torch/csrc/int8_gemm.cu",
            "replaces": "scripts/probe_int8_pallas.py:40",
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}, timing["plain_bf16"]["launches"]


# -- the Resnet18 family: PoseProposal and Lightweight-OpenPose on Resnet18 ---------

def phase_ppn_decode(card) -> None:
    """Painted two-person PoseProposal maps (a 12x12 grid, batch 8) and maps
    full of exact ties, decoded on the card and on the CPU: every field
    equal bit for bit, exactly 2 people with all 18 parts on each painted
    frame, and no hand-written kernel launched (the JAX decoder has none).
    Times the card's decode: wall ms and device ms and kernels a call."""
    import torch
    from hyperpose_torch.ops.ppn_decode import ppn_decode_batch

    cases = {"painted": painted_ppn_batch(),
             "ties": dense_ppn_maps(6, b=BATCH, levels=(0.1, 0.5, 0.5, 0.75))}
    counters = _launch_counters()
    rows = {}
    for name, maps in cases.items():
        cuda = {k: torch.from_numpy(v).cuda() for k, v in maps.items()}
        for k in counters:
            k.launches = 0
        gpu = _numpy(ppn_decode_batch(cuda))
        launches = {k.__name__: k.launches for k in counters}
        check(not any(launches.values()), f"ppn decode {name} launched {launches}")
        cpu = _numpy(ppn_decode_batch(maps))
        diff = [k for k in gpu if not np.array_equal(gpu[k], cpu[k])]
        check(not diff, f"ppn decode {name}: {diff} differ between the card and the CPU")
        humans = gpu["valid"].sum(axis=1)
        if name == "painted":
            check(bool((humans == 2).all() and gpu["part_valid"][:, :2].all()),
                  f"painted ppn maps decoded to {humans.tolist()} humans, not 2 whole ones")
        row = rows[name] = {"humans": humans.tolist(), "equal_to_cpu": True}
        row["wall_ms"], row["wall_p80_ms"] = wall_ms(lambda: ppn_decode_batch(cuda))
        row["device_busy_ms"], row["kernels"] = device_busy(lambda: ppn_decode_batch(cuda), 3)
    emit("ppn_decode", card=card, maps=f"[{BATCH},12,12,18] c/i/x/y/w/h, "
         f"e [{BATCH},17,9,9,12,12], in 384x384", wall_samples=50, **rows)


def _ppn_engine(weights, dtype, device="cuda", batch=BATCH):
    from hyperpose_torch.models.pose_proposal import PoseProposal, ppn_fused_decode
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.topology import PPN_TOPOLOGY

    model = PoseProposal(dtype=dtype)
    return PoseEngine(model, weights, input_hw=PPN_HW, max_batch_size=batch, device=device,
                      topology=PPN_TOPOLOGY, fused_decode=ppn_fused_decode(model))


def _ppn_checks(eng, out, key) -> dict:
    """The card's decode of its outputs equals the CPU's decode of the same
    outputs, bit for bit (`restore_coor`, then `ppn_decode_batch`)."""
    gpu = _numpy(eng.fused_decode.decode(out))
    cpu = _numpy(eng.fused_decode.decode({k: v.cpu() for k, v in out.items()}))
    diff = [k for k in gpu if not np.array_equal(gpu[k], cpu[k])]
    check(not diff, f"{key}: the card's decode of its maps differs from the CPU's in {diff}")
    return {"decode_equal_to_cpu": True}


def _paf_decode(eng, out):
    from hyperpose_torch.ops.paf_decode import paf_decode_batch

    return paf_decode_batch(out["conf_map"].float(), out["paf_map"].float(), eng.decoder)


def _paf_checks(eng, out, key) -> dict:
    """The PAF decoder on the card's outputs against the CPU on the same
    outputs: the peaks (`peak_topk` against its plain version on the CPU)
    equal; on the card's peaks, `limb_scores` equal to its plain version on
    the card bit for bit, and to the plain version on the CPU in validity
    and within 1e-6 in value (ROADMAP.md Queue 3); the humans within
    `phase_decode`'s 1e-5 (coords) and 1e-3 (scores)."""
    import dataclasses

    import torch
    from hyperpose_torch.ops import paf_decode as PD

    cfg, pairs = eng.decoder, PD._limb_pairs(eng.topology)
    plain = dataclasses.replace(cfg, gather_backend="xla")
    conf, paf = out["conf_map"].float()[..., :cfg.n_parts], out["paf_map"].float()
    xy, score, valid = PD.find_peaks(conf, cfg)
    xy_c, score_c, valid_c = PD.find_peaks(conf.cpu(), cfg)
    d_peak = float((xy.cpu() - xy_c).abs().max())
    row = {"valid_peaks_per_image": valid.sum((1, 2)).tolist(),
           "peaks_vs_cpu": {"valid_differ": int((valid.cpu() != valid_c).sum()),
                            "score_differ": int((score.cpu() != score_c).sum()),
                            "max_abs_dxy": d_peak}}
    check(torch.equal(valid.cpu(), valid_c) and torch.equal(score.cpu(), score_c)
          and d_peak <= 1e-5,
          f"{key}: the card's peaks differ from the CPU's on the same maps: {row['peaks_vs_cpu']}")
    cand = PD._limb_pair_scores(paf, xy, valid, pairs, cfg)
    cand_p = PD._limb_pair_scores(paf, xy, valid, pairs, plain)
    cand_c = PD._limb_pair_scores(paf.cpu(), xy.cpu(), valid.cpu(), pairs, plain)
    check(torch.equal(cand, cand_p), f"{key}: limb_scores differs from its plain version on "
          f"the card in {int((cand != cand_p).sum())} of {cand.numel()} values")
    cand, ok = cand.cpu(), cand.cpu() > -5e29
    both = ok & (cand_c > -5e29)
    d_cand = float((cand - cand_c)[both].abs().max()) if both.any() else 0.0
    row["limb_scores_vs_cpu_plain"] = {
        "values": cand.numel(), "valid": int(ok.sum()),
        "validity_differ": int((ok != (cand_c > -5e29)).sum()),
        "values_differ": int((both & (cand != cand_c)).sum()), "max_abs_d": d_cand}
    check(torch.equal(ok, cand_c > -5e29) and d_cand <= 1e-6,
          f"{key}: limb_scores vs its plain version on the CPU: {row['limb_scores_vs_cpu_plain']}")
    on_cpu = {k: out[k].cpu() for k in ("conf_map", "paf_map")}
    d_xy, d_s = human_deltas(_numpy(_paf_decode(eng, out)), _numpy(_paf_decode(eng, on_cpu)))
    check(d_xy <= 1e-5 and d_s <= 1e-3, f"{key}: decode vs CPU |dxy| {d_xy}, |dscore| {d_s}")
    row.update(limb_scores_equal_to_plain_on_card=True, decode_vs_cpu_max_abs_dxy=d_xy,
               decode_vs_cpu_max_abs_dscore=d_s)
    return row


def _ppn_model():
    from hyperpose_torch.models.pose_proposal import PoseProposal
    return PoseProposal()


def _paf_model(name: str, backbone: str | None = None):
    """() -> a factory of the PAF-family model `name` of
    `hyperpose_torch.models.openpose` (on `backbone` of `models.backbones`)
    in a dtype, float32 when none is given."""
    def make(dtype=None):
        import torch
        from hyperpose_torch.models import backbones, openpose

        kw = {} if backbone is None else {"backbone": getattr(backbones, backbone)}
        return getattr(openpose, name)(dtype=dtype or torch.float32, **kw)
    return make


def paf_served(name: str, about: str, hw, make, n_int8: int, n_dw: int = 0,
               **options) -> Served:
    """A model served by the PAF step (`PoseEngine`'s own decoder, which
    launches `limb_scores` and `peak_topk`); `make(dtype)` builds it;
    `options` are `Served`'s last fields."""
    def engine(weights, dtype, device="cuda", batch=BATCH):
        from hyperpose_torch.runtime.engine import PoseEngine

        return PoseEngine(make(dtype), weights, input_hw=hw, max_batch_size=batch,
                          device=device)
    return Served(name, about, hw, make, engine, _paf_decode, _paf_checks,
                  ("limb_scores", "peak_topk"), n_int8, n_dw, **options)


PPN = Served("ppn", "PoseProposal (Resnet18, stride 32, 1485-channel head)", PPN_HW,
             _ppn_model, _ppn_engine, lambda eng, out: eng.fused_decode.decode(out),
             _ppn_checks, (), n_int8=21)
LW_RESNET18 = paf_served("lw_resnet18", "LightWeightOpenPose(backbone=Resnet18), stride 8",
                         INPUT_HW, _paf_model("LightWeightOpenPose", "Resnet18"), n_int8=49)
# The rest of the OpenPose family, at the JAX bench_all.py rows' sizes.
OPENPOSE_HW = (368, 656)   # openpose_vgg19_656x368, the reference's OpenPose size
LW_MOBILENET = paf_served(
    "lw_mobilenet", "LightWeightOpenPose() (MobilenetDilated, stride 8)", INPUT_HW,
    _paf_model("LightWeightOpenPose"), n_int8=54, n_dw=11,
    raised_biases=("ref_heads/conf2/bias", "ref_heads/paf2/bias"))
OPENPOSE_VGG19 = paf_served(
    "openpose_vgg19", "OpenPose() (Vgg19, PReLU, 5 refinements, stride 8)", OPENPOSE_HW,
    _paf_model("OpenPose"), n_int8=92, cpu_frames=2,
    raised_biases=("ref4_conf/out/conv/bias", "ref4_paf/out/conv/bias"))
MBTHIN_OPENPOSE = paf_served(
    "mbthin_openpose", "MobilenetThinOpenpose() (MobilenetThin, 1152 channels, stride 8)",
    INPUT_HW, _paf_model("MobilenetThinOpenpose"), n_int8=143, n_dw=71,
    raised_biases=("ref4_conf/out/bn2/bias", "ref4_paf/out/bn2/bias"))
MBSMALL_OPENPOSE = paf_served(
    "mbsmall_openpose", "MobilenetSmallOpenpose() (MobilenetSmall, stride 4, 92x108 maps; "
    "its SeparableConvs float in int8, as in JAX)", INPUT_HW,
    _paf_model("MobilenetSmallOpenpose"), n_int8=15, n_dw=7,
    raised_biases=("ref3_conf/out/bn/bias", "ref3_paf/out/bn/bias"))
OPENPOSE_FAMILY = (LW_MOBILENET, OPENPOSE_VGG19, MBTHIN_OPENPOSE, MBSMALL_OPENPOSE)

# int32 multiply-adds outside the tensor cores: 64 int32 lanes an SM (half the
# 128 float32 lanes of H100_F32_OPS_PER_S), 132 SMs, 1.98 GHz, 2 operations each.
H100_INT32_OPS_PER_S = 33.5e12


def backbone_dw_convs(name: str, frames) -> list:
    """(name, conv, its input) of every depthwise int8 conv of the bf16
    backbone `name` of `models.backbones` (seeded random weights,
    calibrated on the batch) on the 8 frames at 368x432."""
    import torch
    from hyperpose_torch import quant
    from hyperpose_torch.models import backbones
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

    flat = random_flax_weights(getattr(backbones, name)(), seed=0)
    model = load_flax_weights(getattr(backbones, name)(dtype=torch.bfloat16), flat)
    model = model.cuda().eval().to(memory_format=torch.channels_last)
    x = torch.from_numpy(np.stack([resize_bilinear(f, INPUT_HW) for f in frames])).cuda()
    x = (x.to(torch.bfloat16) / 255.0).permute(0, 3, 1, 2)
    quant.quantize_model(model, quant.calibrate(model, [x]), weights=flat)
    with torch.inference_mode():
        seen = _record_int8_inputs(model, lambda: model(x))
        return [(name, c, xin) for c, xin in seen if c.depthwise]


def _dw_work(convs) -> dict:
    """The bytes and operations the fused kernel needs for `convs` ((conv,
    input) pairs), the input read at its own width (`int8_dwconv_work`),
    and the bound: bytes over H100_BYTES_PER_S or integer operations over
    H100_INT32_OPS_PER_S, the larger."""
    from torch_measures import int8_dwconv_work

    work = [int8_dwconv_work((x.shape[0], *x.shape[2:], x.shape[1]), c.kernel_size, c.stride,
                             c.padding, c.dilation, c.out_channels, x.element_size(),
                             x.element_size()) for c, x in convs]
    nbytes, ops = sum(w["bytes"] for w in work), sum(w["operations"] for w in work)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_INT32_OPS_PER_S
    return {"bytes": nbytes, "operations": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _dw_times(convs, plain: bool) -> dict:
    """Device ms of `convs` together (one CUDA graph each): the fused
    kernel, cuDNN's bf16 depthwise convs of the same layers (weights
    s_w * w_q, the bf16 input, channels-last) and, if `plain`, the plain
    version."""
    import torch
    import torch.nn.functional as F
    from hyperpose_torch.ops.kernels.int8_gemm import int8_dwconv_fused_plain

    cudnn = [(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last),
              (c.w_taps[..., :c.out_channels].float() * c.s_w).permute(2, 0, 1)[:, None]
              .to(torch.bfloat16).contiguous(memory_format=torch.channels_last), c)
             for c, x in convs]
    out = {"kernel_ms": device_ms(lambda: [c.rows(x) for c, x in convs], reps=2, replays=3),
           "cudnn_bf16_ms": device_ms(lambda: [
               F.conv2d(x, w, None, c.stride, c.padding, c.dilation, c.out_channels)
               for x, w, c in cudnn], reps=2, replays=3)}
    if plain:
        out["plain_ms"] = device_ms(lambda: [int8_dwconv_fused_plain(
            x, c.inv_s, c.w_taps, c.dq, c.bias, *c.taps_geometry) for c, x in convs],
            reps=1, replays=2)
    return out


def phase_int8_dwconv(records, card) -> dict:
    """`int8_dwconv`, the fused quantize and depthwise conv, at every
    depthwise shape of `records` ((set, conv, its input): the int8 steps'
    own bf16 inputs): equal to its plain version bit for bit on that input
    and on its float32 copy; then, per set and per distinct shape,
    the device times of `_dw_times` beside the bound of the work
    (`_dw_work`) and its share. A set's times are one graph of all its
    convs; its plain time is the sum of its shapes'. Returns the rows by
    set."""
    import torch
    from hyperpose_torch.ops.kernels.int8_gemm import int8_dwconv_fused_plain

    rows = {}
    for name in dict.fromkeys(r[0] for r in records):
        mine = [(c, x) for n, c, x in records if n == name]
        groups = {}
        for c, x in mine:
            for xin in (x, x.float().contiguous(memory_format=torch.channels_last)):
                got = c.rows(xin)
                check(bool(torch.equal(got, int8_dwconv_fused_plain(
                          xin, c.inv_s, c.w_taps, c.dq, c.bias, *c.taps_geometry))),
                      f"int8_dwconv {name}: differs from its plain version at "
                      f"{tuple(xin.shape)} ({c.kernel_size}, stride {c.stride}, dilation "
                      f"{c.dilation}, {xin.dtype})")
            key = (*x.shape[2:], x.shape[1], c.kernel_size[0], c.stride[0], c.padding[0],
                   c.dilation[0])
            groups.setdefault(key, []).append((c, x))
        shapes = []
        for key, convs in groups.items():
            shape = {"h_w_c_k_stride_pad_dil": key, "convs": len(convs),
                     **_dw_times(convs, plain=True), **_dw_work(convs)}
            shape["share_of_bound"] = shape["bound_ms"] / shape["kernel_ms"]
            shapes.append(shape)
        row = rows[name] = {"convs": len(mine), "equal_to_plain": True, "dtypes": "bf16, f32",
                            **_dw_times(mine, plain=False), **_dw_work(mine),
                            "plain_ms": sum(sh["plain_ms"] for sh in shapes), "shapes": shapes}
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    emit("int8_dwconv", card=card, input="the int8 steps' own bf16 inputs, batch 8",
         int32_ops_per_s=H100_INT32_OPS_PER_S, **rows)
    return rows


# -- the serving facade: the CLI, and engines saved and loaded ----------------------

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _launches_of(fn) -> dict:
    """The kernel launches of one call of `fn` (counts set to 0 just before
    it, read just after a device synchronize); only the kernels launched."""
    import torch

    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in counters if k.launches}


def loaded_worker(exe: str, io_path: str) -> None:
    """In a fresh process: load the program an engine saved, run it on the
    batch the eager step ran on, and print one JSON line: the seconds to
    load and of the first call, its launches in one call, its largest
    difference to the eager outputs per field, and its wall."""
    import torch
    from hyperpose_torch.runtime.engine import PoseEngine

    t0 = time.perf_counter()
    fn = PoseEngine.load_executable(exe)
    load_s = time.perf_counter() - t0
    io = np.load(io_path)
    batch = torch.from_numpy(io["batch"]).cuda()
    t0 = time.perf_counter()
    fn(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    out = {}
    launches = _launches_of(lambda: out.update(zip(FIELDS, fn(batch))))
    diff = {f: float(np.abs(out[f].cpu().numpy().astype(np.float64)
                            - io[f].astype(np.float64)).max()) for f in FIELDS}
    step_ms, step_p80 = wall_ms(lambda: fn(batch))
    busy, kernels = device_busy(lambda: fn(batch))
    print(json.dumps({"load_s": load_s, "first_call_s": first_s, "launches": launches,
                      "max_abs_diff": diff, "step_ms": step_ms, "step_p80_ms": step_p80,
                      "device_busy_ms": busy, "kernels": kernels}), flush=True)


def _save_and_load(eng, batch, tmp: str, key: str) -> dict:
    """Time the engine's eager step, save it, and run the saved program in a
    fresh process (`loaded_worker`): equal outputs, the same kernels."""
    import torch

    eager = {}
    launches = _launches_of(lambda: eager.update(vars(eng.infer_batch_device(batch))))
    step_ms, step_p80 = wall_ms(lambda: eng.infer_batch_device(batch))
    busy, kernels = device_busy(lambda: eng.infer_batch_device(batch))
    t0 = time.perf_counter()
    paths = eng.save(os.path.join(tmp, key))
    torch.cuda.synchronize()
    save_s = time.perf_counter() - t0
    io = os.path.join(tmp, f"{key}_io.npz")
    np.savez(io, batch=batch.cpu().numpy(), **{f: v.cpu().numpy() for f, v in eager.items()})
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--loaded",
                           paths["executable"], io], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    check(proc.returncode == 0, f"{key}: the loaded program failed:\n{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(got["launches"] == launches,
          f"{key}: the loaded program launched {got['launches']}, the eager step {launches}")
    diff = got["max_abs_diff"]
    check(diff["valid"] == diff["part_valid"] == 0
          and max(diff["coords"], diff["scores"], diff["part_scores"]) <= 1e-3,
          f"{key}: the loaded program's outputs differ from the eager step's: {diff}")
    return {"eager_step_ms": step_ms, "eager_step_p80_ms": step_p80,
            "eager_device_busy_ms": busy, "eager_kernels": kernels,
            "loaded_step_ms": got["step_ms"], "loaded_step_p80_ms": got["step_p80_ms"],
            "loaded_device_busy_ms": got["device_busy_ms"], "loaded_kernels": got["kernels"],
            "save_s": save_s, "load_s": got["load_s"], "first_call_s": got["first_call_s"],
            "pt2_bytes": os.path.getsize(paths["executable"]), "launches": launches,
            "bit_equal": not any(diff.values()), "max_abs_diff": diff}


def phase_facade_cli(frames, card) -> dict:
    """The port's CLI (`hyperpose_torch.cli.run`, what `main` runs) on the
    card at 368x432, batch 8, bf16 (the config's default), on the batch's 8
    frames written as PNG and on a 20-frame mp4 of the synthetic frame:
    the flagship (`--backbone Vggtiny --weights` the checkpoint) in operator
    and stream mode, PifPaf (`--model Pifpaf`, seeded weights) and the int8
    default Lightweight-OpenPose (`--quantize 8`, seeded weights), each run
    with its launches; then each of the three engines saved
    (`PoseEngine.save`) and loaded in a fresh process. Outputs go to a
    temporary directory. Returns the launches of each run."""
    import tempfile

    import cv2
    import torch
    from hyperpose_torch import cli
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.runtime.engine import PoseEngine

    tmp = tempfile.mkdtemp(prefix="hp_facade_")
    try:
        src = os.path.join(tmp, "frames")
        os.makedirs(src)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(src, f"f{i}.png"), f[..., ::-1])
        video = os.path.join(tmp, "synthetic.mp4")
        bgr = np.ascontiguousarray(frames[0][..., ::-1])
        writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 20,
                                 (bgr.shape[1], bgr.shape[0]))
        for _ in range(20):
            writer.write(bgr)
        writer.release()
        weights = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
        size = ["--h", str(INPUT_HW[0]), "--w", str(INPUT_HW[1]), "--max_batch_size",
                str(BATCH), "--device", "cuda"]
        flagship = ["--backbone", "Vggtiny", "--weights", weights]
        ref_model, _ = _stem_model("plain", torch.float32)
        ref = PoseEngine(ref_model, weights, max_batch_size=1,
                         device="cpu").inference([frames[0]])[0]
        check(len(ref) == 2, f"CPU reference: {len(ref)} humans")
        runs, rows = {}, {}
        for key, argv in (
                ("flagship_operator", flagship + ["--source", src]),
                ("flagship_stream", flagship + ["--source", video, "--runtime", "stream"]),
                ("pifpaf_operator", ["--model", "Pifpaf", "--source", src]),
                ("int8_lw_operator", ["--quantize", str(BATCH), "--source", src])):
            out = {}
            prefix = os.path.join(tmp, key)
            launches = _launches_of(lambda: out.update(cli.run(
                argv + size + ["--saving_prefix", prefix])))
            eng = out.pop("engine")
            check(eng.device.type == "cuda" and eng.dtype == torch.bfloat16,
                  f"{key}: engine on {eng.device} in {eng.dtype}")
            row = rows[key] = {k: v for k, v in out.items() if k not in ("paths", "humans")}
            row["launches"] = launches
            runs[key] = eng
            if key.endswith("operator"):
                check(out["images"] == BATCH and len(os.listdir(prefix)) == BATCH,
                      f"{key}: {out['images']} images")
                for res in out["humans"]:
                    for hm in res:
                        xy = np.array([(p.x, p.y) for p in hm.parts.values()])
                        check(bool(np.isfinite(xy).all() and np.isfinite(hm.score)),
                              f"{key}: non-finite output")
            else:
                check(out["frames"] == 20 and os.path.getsize(prefix + ".mp4") > 0,
                      f"{key}: {out['frames']} frames")
                check(2 * 20 <= out["total_humans"] <= 3 * 20,
                      f"{key}: {out['total_humans']} humans in 20 frames of 2 people")
            if key.startswith("flagship_operator"):
                worst = find_people(ref, out["humans"][0])
                check(worst is not None and worst <= INT8_TOL["xy"],
                      f"{key}: the synthetic frame's 2 people not found ({worst})")
                row["frame0_worst_dxy"] = worst
        paf = {"limb_scores", "peak_topk"}
        check(paf <= set(rows["flagship_operator"]["launches"])
              and paf <= set(rows["flagship_stream"]["launches"]),
              f"the flagship CLI runs skipped a decoder kernel: {rows}")
        check("fused_grow" in rows["pifpaf_operator"]["launches"]
              and not paf & set(rows["pifpaf_operator"]["launches"]),
              f"the PifPaf CLI run: {rows['pifpaf_operator']['launches']}")
        check({"int8_quantize", "int8_conv", "int8_dwconv"} | paf
              <= set(rows["int8_lw_operator"]["launches"]),
              f"the int8 CLI run: {rows['int8_lw_operator']['launches']}")
        batch = torch.from_numpy(
            np.stack([resize_bilinear(f, INPUT_HW) for f in frames])).cuda()
        saved = {key: _save_and_load(runs[key], batch, tmp, key)
                 for key in ("flagship_operator", "pifpaf_operator", "int8_lw_operator")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("facade_cli", card=card, input="x".join(map(str, INPUT_HW)), batch=BATCH,
         dtype="bf16", runs=rows, saved=saved)
    return {key: row["launches"] for key, row in rows.items()}


# -- evaluation: datasets, the Evaluator and the scorers on the card ---------------

EVAL_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_eval_flagship_synth_val100.json")
EVAL_ROOT = os.path.join(REPO, "build", "eval_synth")   # gitignored
EVAL_AP_TOL = 0.003          # |AP - the JAX package's|, f32 flagship
EVAL_MATCH = (0.5, 0.98)     # px of mean keypoint distance, share of JAX's detections
EVAL_FAMILY_SCENES = 16      # PifPaf and PoseProposal: the first 16 val scenes


def _synth_val_set(fixture) -> dict:
    """The 100 val scenes of the seed-0 synthetic set, generated by the
    port under EVAL_ROOT: the annotation file must equal the fixture's byte
    for byte (it comes from numpy); the JPEG files and the decoded RGB
    arrays are counted where they equal the fixture's (another OpenCV build
    may encode and decode JPEG otherwise)."""
    import hashlib

    import cv2
    from hyperpose_torch.data.synthetic import generate_synthetic_coco

    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_coco(EVAL_ROOT, n_train=0, n_val=fixture["n_val"], seed=fixture["seed"],
                            emit_mpii=False)
    seconds = time.perf_counter() - t0
    with open(os.path.join(EVAL_ROOT, "annotations", "person_keypoints_val2017.json"),
              "rb") as f:
        ann = hashlib.sha256(f.read()).hexdigest()
    check(ann == fixture["annotation_sha256"],
          "the port's synthetic val annotations differ from the JAX fixture's")
    jpeg = rgb = 0
    for name, want in fixture["jpeg_sha256"].items():
        path = os.path.join(EVAL_ROOT, "val2017", name)
        with open(path, "rb") as f:
            jpeg += hashlib.sha256(f.read()).hexdigest() == want
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        rgb += hashlib.sha256(img.tobytes()).hexdigest() == fixture["rgb_sha256"][name]
    return {"generate_s": seconds, "scenes": len(fixture["jpeg_sha256"]),
            "jpeg_equal_to_fixture": jpeg, "rgb_equal_to_fixture": rgb,
            "opencv": cv2.__version__, "fixture_opencv": fixture["opencv_version"]}


def _eval_setup(model_type: str, backbone: str, dtype: str, weights):
    """(config, model with `weights`, dataset) of one evaluation on the
    synthetic val set."""
    from hyperpose_torch import config as Config
    from hyperpose_torch import models as Model
    from hyperpose_torch.data.base import get_dataset
    from hyperpose_torch.utils.weights import load_flax_weights

    Config.reset()
    Config.set_model_type(Config.MODEL[model_type])
    Config.set_model_backbone(Config.BACKBONE[backbone])
    Config.set_compute_dtype(dtype)
    Config.set_dataset_path(EVAL_ROOT)
    cfg = Config.get_config(create_dirs=False)
    model = load_flax_weights(Model.get_model(cfg), weights)
    return cfg, model, get_dataset(cfg)


def _evaluate(cfg, model, dataset, device="cuda", limit=None, multiscale=False) -> dict:
    """One `Evaluator.evaluate` with every kernel count set to 0 just before
    it and read just after: metrics, COCO results, launches, and seconds a
    image by stage."""
    import torch
    from hyperpose_torch import models as Model

    ev = Model.evaluator(cfg, model, dataset, device, multiscale)
    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    metrics = ev.evaluate(limit=limit, eval_dir=os.path.join(EVAL_ROOT, "out"))
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    st = ev.stats
    check(st.images > 0 and all(np.isfinite(v) for v in metrics.values()
                                if not np.isnan(v)), f"evaluation: {metrics}")
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "results": ev.results,
            "launches": {k.__name__: k.launches for k in counters if k.launches},
            "images": st.images, "seconds": seconds,
            "s_per_image": {"read_resize": st.read_s / st.images,
                            "device_step": st.device_s / st.images,
                            "score": st.score_s / st.images},
            "launches_per_batch": {k.__name__: k.launches / st.batches
                                   for k in counters if k.launches}}


def match_detections(ref, got, px: float) -> float:
    """The share of the detections `ref` (COCO results) that find their own
    detection of `got` in the same image with the same keypoints present
    and a mean keypoint distance under `px` pixels (greedy, `ref` by score)."""
    free: dict = {}
    for g in got:
        free.setdefault(g["image_id"], []).append(np.asarray(g["keypoints"]).reshape(-1, 3))
    found = 0
    for d in sorted(ref, key=lambda d: -d["score"]):
        k = np.asarray(d["keypoints"]).reshape(-1, 3)
        vis = k[:, 2] > 0
        best = None
        for j, kg in enumerate(free.get(d["image_id"], [])):
            if vis.any() and np.array_equal(kg[:, 2] > 0, vis):
                dist = float(np.hypot(*(kg[vis, :2] - k[vis, :2]).T).mean())
                if best is None or dist < best[0]:
                    best = (dist, j)
        if best is not None and best[0] < px:
            found += 1
            free[d["image_id"]].pop(best[1])
    return found / max(len(ref), 1)


def same_people(a, b, sizes) -> tuple[float, float]:
    """(max |d keypoint| over the image size, max |d score|) between two
    COCO result lists of the same images, person by person (each image's
    people sorted by score); raises ValueError unless every image has the
    same number of people with the same keypoints present."""
    def people(res):
        out: dict = {}
        for r in res:
            out.setdefault(r["image_id"], []).append(
                (r["score"], np.asarray(r["keypoints"]).reshape(-1, 3)))
        return {k: sorted(v, key=lambda t: (-round(t[0], 3), tuple(np.round(t[1][:, :2], 1).ravel())))
                for k, v in out.items()}

    pa, pb = people(a), people(b)
    if set(pa) != set(pb):
        raise ValueError(f"images with people differ: {sorted(set(pa) ^ set(pb))}")
    d_xy = d_s = 0.0
    for iid, ha in pa.items():
        hb = pb[iid]
        if len(ha) != len(hb):
            raise ValueError(f"image {iid}: {len(ha)} vs {len(hb)} people")
        oh, ow = sizes[iid]
        for (sa, ka), (sb, kb) in zip(ha, hb):
            if not np.array_equal(ka[:, 2], kb[:, 2]):
                raise ValueError(f"image {iid}: keypoint sets differ")
            d = np.abs(ka[:, :2] - kb[:, :2]) / (ow, oh)
            d_xy, d_s = max(d_xy, float(d.max())), max(d_s, abs(sa - sb))
    return d_xy, d_s


def _family_vs_cpu(spec: "Served", model_type: str, backbone: str) -> dict:
    """A non-PAF family's evaluation on the first EVAL_FAMILY_SCENES val
    scenes, seeded random weights (`served_weights`), f32: people found,
    and the card's COCO results against the same `Evaluator` on the CPU,
    person by person within `phase_serving`'s decode bounds (1e-5 of the
    image size, 1e-3 in score)."""
    weights = served_weights(spec)
    runs = {}
    for device in ("cuda", "cpu"):
        cfg, model, dataset = _eval_setup(model_type, backbone, "float32", weights)
        runs[device] = _evaluate(cfg, model, dataset, device, limit=EVAL_FAMILY_SCENES)
        del model
    with open(os.path.join(EVAL_ROOT, "annotations", "person_keypoints_val2017.json")) as f:
        sizes = {im["id"]: (im["height"], im["width"]) for im in json.load(f)["images"]}
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(len(cpu["results"]) > 0, f"{spec.name} evaluation: no people on the CPU")
    try:
        d_xy, d_s = same_people(gpu["results"], cpu["results"], sizes)
    except ValueError as e:
        fail(f"{spec.name} evaluation: the card's people differ from the CPU's: {e}")
    check(d_xy <= 1e-5 and d_s <= 1e-3,
          f"{spec.name} evaluation vs the CPU: |dxy| {d_xy} of the image, |dscore| {d_s}")
    return {"scenes": EVAL_FAMILY_SCENES, "people": len(gpu["results"]),
            "AP": gpu["metrics"]["AP"], "cpu_AP": cpu["metrics"]["AP"],
            "vs_cpu_max_abs_dxy": d_xy,
            "vs_cpu_max_abs_dscore": d_s, "launches": gpu["launches"],
            "s_per_image": gpu["s_per_image"], "cpu_s_per_image": cpu["s_per_image"]}


def phase_evaluate(card) -> dict:
    """The port's evaluation path on the card: the 100 val scenes of the
    seed-0 synthetic set generated by the port (`_synth_val_set`), the
    committed flagship (Lightweight-OpenPose on VggTiny) through
    `models.evaluator` at 368x432, batch 8, with PyTorch's default TF32
    flags outside the evaluator (cuDNN's on: the evaluator turns TF32 off
    for its step): f32 held to the JAX package's evaluation
    (tests/fixtures/jax_eval_flagship_synth_val100.json: AP within
    EVAL_AP_TOL, EVAL_MATCH of its detections found), bf16, int8 (bf16
    activations, scales from the 100 scenes of the tune split; AP of both
    at least 0.9 x f32's) and multiscale f32; then PifPaf and PoseProposal
    (`_family_vs_cpu`). Each run's launches are counted (the
    PAF decoder's kernels on the flagship, the int8 kernels on int8, the
    growth kernel on PifPaf). Returns the launches of each run."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        return _phase_evaluate(card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _phase_evaluate(card) -> dict:
    import torch
    from hyperpose_torch.tools.eval import TUNE_SPLIT, calibration_batches, quantize_for_eval
    from hyperpose_torch.utils.weights import read_flax_weights

    with open(EVAL_FIXTURE) as f:
        fixture = json.load(f)
    t_phase = time.perf_counter()
    data = _synth_val_set(fixture)
    flat = read_flax_weights(os.path.join(REPO, "weights", "flagship_tinyvgg.npz"))
    runs = {}
    for key, dtype, multiscale in (("f32", "float32", False), ("bf16", "bfloat16", False),
                                   ("int8", "bfloat16", False),
                                   ("multiscale_f32", "float32", True)):
        cfg, model, dataset = _eval_setup("LightweightOpenpose", "Vggtiny", dtype, flat)
        row = {}
        if key == "int8":
            t0 = time.perf_counter()
            batches = calibration_batches(TUNE_SPLIT, 100, (cfg.model.hin, cfg.model.win),
                                          cfg.eval.batch_size)
            model, scales = quantize_for_eval(model, flat, batches, torch.device("cuda"))
            row.update(calibration_scenes=sum(len(b) for b in batches), int8_convs=len(scales),
                       calibrate_quantize_s=time.perf_counter() - t0)
        run = _evaluate(cfg, model, dataset, multiscale=multiscale)
        row.update({k: v for k, v in run.items() if k != "results"})
        row.update({m: run["metrics"][m] for m in ("AP", "AP50", "AP75", "AR")})
        runs[key] = row
        if key == "f32":
            ref = fixture["metrics"]
            row["jax_AP"], row["ap_minus_jax"] = ref["AP"], row["AP"] - ref["AP"]
            row["jax_detections"], row["detections"] = len(fixture["detections"]), len(
                run["results"])
            row["jax_detections_matched"] = match_detections(
                fixture["detections"], run["results"], EVAL_MATCH[0])
            check(abs(row["ap_minus_jax"]) <= EVAL_AP_TOL,
                  f"f32 evaluation: AP {row['AP']} vs the JAX package's {ref['AP']}")
            check(row["jax_detections_matched"] >= EVAL_MATCH[1],
                  f"f32 evaluation: {row['jax_detections_matched']:.3f} of JAX's detections "
                  f"found within {EVAL_MATCH[0]} px")
        del model
        torch.cuda.empty_cache()
    for key in ("bf16", "int8"):
        check(runs[key]["AP"] >= 0.9 * runs["f32"]["AP"],
              f"{key} evaluation: AP {runs[key]['AP']} below 0.9 x f32's {runs['f32']['AP']}")
    for key in ("f32", "bf16", "multiscale_f32"):
        check({"peak_topk", "limb_scores"} <= set(runs[key]["launches"]),
              f"{key} evaluation launches {runs[key]['launches']}")
    check({"peak_topk", "limb_scores", "int8_quantize", "int8_conv"}
          <= set(runs["int8"]["launches"]), f"int8 evaluation launches {runs['int8']['launches']}")
    # PifPaf's head biases raised by 1, so its seeded fields hold people.
    pifpaf = PIFPAF._replace(raised_biases=("pif_head/bias", "paf_head/bias"))
    family = {"pifpaf": _family_vs_cpu(pifpaf, "Pifpaf", "Default"),
              "ppn": _family_vs_cpu(PPN, "PoseProposal", "Default")}
    check(family["pifpaf"]["launches"].get("fused_grow", 0) > 0,
          f"PifPaf evaluation launches {family['pifpaf']['launches']}")
    emit("evaluate", card=card, data=data, model="LightweightOpenpose (Vggtiny), "
         "weights/flagship_tinyvgg.npz", input="x".join(map(str, INPUT_HW)), batch=BATCH,
         tf32_outside_the_evaluator={"cudnn": True, "matmul": False},
         int8_activations="bf16", ap_tolerance=EVAL_AP_TOL,
         match=dict(zip(("px", "share"), EVAL_MATCH)), runs=runs, family=family,
         seconds=time.perf_counter() - t_phase)
    out = {key: row["launches"] for key, row in runs.items()}
    out.update({key: row["launches"] for key, row in family.items()})
    return out


# -- training (the train phase) ------------------------------------------------

TRAIN_ROOT = os.path.join(REPO, "build", "train_synth")   # gitignored
TRAIN_SCENES = 32        # seed-0 synthetic train scenes the pipeline reads
TRAIN_STEPS = 30         # timed steps in each dtype
OVERFIT_STEPS = 100      # steps on one fixed batch; the loss must fall below 0.8x
TRAIN_LOSS_RTOL = 1e-5   # step 1, card vs CPU, f32 with TF32 off, relative
TRAIN_GRAD_L2 = 2e-2     # the card's f32 gradients, over all: relative L2 distance from float64
TRAIN_GRAD_TENSOR = 0.1  # each of them: the same, its norm floored at 1e-4 of the largest
TRAIN_STATS_RTOL = 1e-5  # each new BN statistic: |d| / max(1, |v|)
TRAIN_BF16_RTOL = 2e-3   # a bf16 step's loss against the CPU's f32 loss, relative


def _train_cfg(model_type: str, dtype: str, tag: str, backbone: str = "Default",
               dmadapt=None, hw=None, batch=None):
    """A training config of the port on the phase's synthetic set, its
    model_dir emptied under TRAIN_ROOT/runs/<tag>."""
    from hyperpose_torch import config as Config

    Config.reset()
    Config.set_model_name(f"chip_smoke_{tag}")
    Config.set_model_type(Config.MODEL[model_type])
    Config.set_model_backbone(Config.BACKBONE[backbone])
    Config.set_compute_dtype(dtype)
    Config.set_dataset_path(TRAIN_ROOT)
    if hw is not None:
        base = Config.get_config(create_dirs=False)
        s = base.model.hin // base.model.hout
        Config.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // s, wout=hw[1] // s)
    if batch is not None:
        Config.set_batch_size(batch)
    if dmadapt:
        Config.set_domainadapt_dataset(dmadapt)
    cfg = Config.get_config(create_dirs=False)
    Config.reset()
    cfg.model.model_dir = os.path.join(TRAIN_ROOT, "runs", tag)
    shutil.rmtree(cfg.model.model_dir, ignore_errors=True)
    cfg.log.log_interval = 10 ** 9
    return cfg


def _train_batches(cfg, n: int, workers: int = 1) -> tuple[list, float]:
    """The first `n` batches of a `TrainPipeline` (seed 0) over the
    config's dataset, and batches/s after the first (one worker keeps the
    order fixed)."""
    from hyperpose_torch import models as Model
    from hyperpose_torch.data.base import get_dataset
    from hyperpose_torch.data.pipeline import TrainPipeline

    pipe = TrainPipeline(get_dataset(cfg).get_train_records(), Model.get_augmentor(cfg),
                         batch_size=cfg.train.batch_size,
                         out_hw=(cfg.model.hout, cfg.model.wout), n_parts=cfg.model.n_pos,
                         n_workers=workers, seed=0)
    it = iter(pipe)
    out = [next(it)]
    t0 = time.perf_counter()
    out += [next(it) for _ in range(n - 1)]
    rate = (n - 1) / (time.perf_counter() - t0) if n > 1 else float("nan")
    pipe.stop()
    return out, rate


def _trainer(cfg, device: str):
    """The config's model in a `Trainer` on `device` after `init_state`
    (flax's initialization drawn on the CPU from seed 0: the same weights
    on every device)."""
    from hyperpose_torch import models as Model
    from hyperpose_torch.train.trainer import Trainer

    tr = Trainer(cfg, Model.get_model(cfg), Model.get_topology(cfg).limbs, device=device)
    tr.init_state()
    return tr


def train_step1_vs_cpu(cfg, batch) -> dict:
    """Step 1 of the same initialized trainer on the card and on the CPU in
    f32 (TF32 off in the step): the loss; every new BatchNorm statistic
    (|d| / max(1, |v|)); every gradient card against CPU (max |d| over its
    max |g|, and how many tensors lie beyond 1e-3), and both against a
    float64 step on the card (relative L2 over all the gradients: float32
    gradients of a train-mode step at initialization carry the rounding of
    ReLU and max-pool inputs next to their thresholds and of BatchNorm's
    cancelling gradient, in both places alike), over all of them and tensor
    by tensor (relative L2, the norm floored at 1e-4 of the largest tensor's,
    as tests/test_torch_train.py holds them)."""
    import torch

    gpu, cpu = _trainer(cfg, "cuda"), _trainer(cfg, "cpu")
    ref = gpu.twin()   # the float64 step on the card
    g64 = [g.cpu() for g in ref.loss_and_grads(batch)[1]]
    del ref
    mg, gg = gpu.loss_and_grads(batch)
    mc, gc = cpu.loss_and_grads(batch)
    names = [n for n, _ in cpu.model.named_parameters()]
    top = max(float(g.abs().max()) for g in gc)
    top64 = max(float(r.norm()) for r in g64)
    per, per64 = {}, {"gpu": {}, "cpu": {}}
    sq = {"gpu": 0.0, "cpu": 0.0, "ref": 0.0}
    for n, a, b, r in zip(names, gg, gc, g64):
        a = a.float().cpu()
        per[n] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6 * top)
        for key, g in (("gpu", a), ("cpu", b)):
            per64[key][n] = float((g.double() - r).norm()) / max(float(r.norm()), 1e-4 * top64)
        sq["gpu"] += float((a.double() - r).square().sum())
        sq["cpu"] += float((b.double() - r).square().sum())
        sq["ref"] += float(r.square().sum())
    stats = {}
    for (n, a), b in zip(gpu.model.named_buffers(), cpu.model.buffers()):
        if a.is_floating_point():
            stats[n] = float(((a.cpu() - b).abs() / b.abs().clamp_min(1.0)).max())
    loss_g, loss_c = float(mg["total_loss"]), float(mc["total_loss"])
    del gpu, cpu
    torch.cuda.empty_cache()
    return {"loss": loss_g, "cpu_loss": loss_c, "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
            "grad_tensors": len(per), "grad_max_rel_vs_cpu": max(per.values()),
            "grad_worst_vs_cpu": sorted(per.items(), key=lambda kv: -kv[1])[:5],
            "grad_tensors_over_1e-3_vs_cpu": sum(v > 1e-3 for v in per.values()),
            "grad_rel_l2_card_vs_f64": (sq["gpu"] / sq["ref"]) ** 0.5,
            "grad_rel_l2_cpu_vs_f64": (sq["cpu"] / sq["ref"]) ** 0.5,
            "grad_tensor_max_rel_l2_card_vs_f64": max(per64["gpu"].values()),
            "grad_tensor_max_rel_l2_cpu_vs_f64": max(per64["cpu"].values()),
            "grad_tensor_worst_card_vs_f64": sorted(per64["gpu"].items(),
                                                    key=lambda kv: -kv[1])[:5],
            "stats_max_rel": max(stats.values()), "stats": len(stats)}


def check_step1(r: dict) -> None:
    """The gates on `train_step1_vs_cpu`: the loss and statistics tight;
    the card's gradients within TRAIN_GRAD_L2 of float64 over all and
    TRAIN_GRAD_TENSOR each (cuDNN's float32 algorithms, TF32 off, land
    farther from it than the CPU's, so the CPU's distance is recorded, not
    a bound)."""
    check(r["loss_rel"] <= TRAIN_LOSS_RTOL, f"train step 1 loss vs CPU: {r}")
    check(r["stats_max_rel"] <= TRAIN_STATS_RTOL, f"train step 1 BN statistics: {r}")
    check(r["grad_rel_l2_card_vs_f64"] <= TRAIN_GRAD_L2, f"train step 1 gradients: {r}")
    check(r["grad_tensor_max_rel_l2_card_vs_f64"] <= TRAIN_GRAD_TENSOR,
          f"train step 1 gradient tensors: {r}")


def _train_run(cfg, batch) -> tuple[dict, object]:
    """OVERFIT_STEPS steps of a fresh trainer on one fixed batch on the
    card, with the kernel counts set to 0 just before and read just after
    (training launches none): the first loss and the loss after the last
    update; TRAIN_STEPS of them timed (median / p80 of synced calls), 3
    traced (device busy ms, kernels), the peak memory of a step."""
    import torch

    tr = _trainer(cfg, "cuda")
    counters = _launch_counters()
    for k in counters:
        k.launches = 0

    def step():
        return tr.step(batch)

    first = float(step()["total_loss"])
    med, p80 = wall_ms(step, iters=TRAIN_STEPS, warmup=3)
    torch.cuda.reset_peak_memory_stats()
    busy, kernels = device_busy(step, iters=3)
    peak = torch.cuda.max_memory_allocated()
    for _ in range(OVERFIT_STEPS - 1 - 3 - TRAIN_STEPS - 3):
        step()
    check(tr.optimizer.count == OVERFIT_STEPS, f"{tr.optimizer.count} steps")
    last = float(tr.loss_and_grads(batch, grads=False)[0]["total_loss"])
    launched = {k.__name__: k.launches for k in counters if k.launches}
    check(not launched, f"a training step launched a serving kernel: {launched}")
    b = cfg.train.batch_size
    return {"first_loss": first, "loss_after": last, "loss_ratio": last / first,
            "step_ms": med, "step_p80_ms": p80, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / med, "kernels_per_step": kernels,
            "peak_memory_bytes": peak, "images_per_s": 1e3 * b / med}, tr


def train_resume(cfg, batches) -> dict:
    """`Trainer.train` on the card over 4 fixed batches, with cuDNN's
    deterministic algorithms: 2 steps (a checkpoint at each), a new trainer
    that resumes from the checkpoint (`ckpt.restore` onto the card) for 2
    more, and 4 straight steps. The two end in the same weights, statistics
    and optimizer state, bit for bit."""
    import torch
    from hyperpose_torch import models as Model
    from hyperpose_torch.train.trainer import Trainer

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ends = {}
    try:
        for tag, parts in (("resumed", [(2, batches[:2]), (4, batches[2:])]),
                           ("straight", [(4, batches)])):
            c = copy.deepcopy(cfg)
            c.model.model_dir = os.path.join(TRAIN_ROOT, "runs", f"resume_{tag}")
            shutil.rmtree(c.model.model_dir, ignore_errors=True)
            c.train.save_interval = 1
            for n_step, bs in parts:
                tr = Trainer(c, Model.get_model(c), Model.get_topology(c).limbs, device="cuda")
                tr.train(bs, n_step=n_step)
            ends[tag] = tr
    finally:
        torch.backends.cudnn.deterministic = det
    a, b = ends["resumed"], ends["straight"]

    def tensors(tr):
        return list(tr.model.state_dict().values()) + tr.optimizer.mu + tr.optimizer.nu

    diff = max(float((x.double() - y.double()).abs().max())
               for x, y in zip(tensors(a), tensors(b)))
    out = {"ckpt_steps": a.ckpt.steps(), "optimizer_count": a.optimizer.count,
           "bitwise": all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b))),
           "max_abs_diff": diff}
    del ends, a, b, tr
    torch.cuda.empty_cache()
    return out


class _LogRecords:
    """The messages of a logger while in a `with` block, at INFO."""

    def __init__(self, name: str):
        import logging

        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())

    def __enter__(self):
        self.level = self.logger.level
        self.logger.setLevel("INFO")
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def train_cli() -> dict:
    """The slice's entry point on the card, as a user runs it:
    `python -m hyperpose_torch.tools.train --synthetic` (its own synthetic
    set, 8 train scenes; the flagship on Vggtiny at the config's 368x432,
    batch 8, bf16) for 2 steps with a checkpoint at each, then the same
    command with `--n_step 4`, which resumes from step 2. Run in a working
    directory of its own, since the command writes `save_dir/` there."""
    import torch
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.tools import train as train_entry
    from hyperpose_torch.train.checkpoint import CheckpointManager, load_weights_npz

    root = os.path.join(TRAIN_ROOT, "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    argv = ["--synthetic", "--synthetic_train_scenes", "8", "--dataset_path",
            os.path.join(root, "data"), "--model_backbone", "Vggtiny", "--save_interval", "1"]
    cwd, t0 = os.getcwd(), time.perf_counter()
    os.chdir(root)
    try:
        with _LogRecords("hyperpose_torch.TRAIN") as first:
            _, cfg = train_entry.run(argv + ["--n_step", "2"])
        steps_first = CheckpointManager(cfg.model.model_dir).steps()
        with _LogRecords("hyperpose_torch.TRAIN") as second:
            model, cfg = train_entry.run(argv + ["--n_step", "4"])
    finally:
        os.chdir(cwd)
    model_dir = os.path.join(root, cfg.model.model_dir)
    state = CheckpointManager(model_dir).restore()[1]
    npz = load_weights_npz(LightWeightOpenPose(backbone=VggTiny),
                           os.path.join(model_dir, "newest_model.npz"))
    out = {"seconds": time.perf_counter() - t0, "ckpt_steps_after_2": steps_first,
           "ckpt_steps_after_4": CheckpointManager(model_dir).steps(),
           "resumed": [m for m in second if m.startswith("resumed")],
           "first_run_resumed": [m for m in first if m.startswith("resumed")],
           "optimizer_count": state["optimizer"]["count"],
           "device": str(next(model.parameters()).device),
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
           "npz_finite": all(bool(torch.isfinite(t).all())
                             for t in npz.state_dict().values() if t.is_floating_point())}
    del model, npz
    torch.cuda.empty_cache()
    return out


def check_train_cli(r: dict) -> None:
    check(r["ckpt_steps_after_2"] == [1, 2] and not r["first_run_resumed"],
          f"tools.train --n_step 2: {r}")
    check(r["resumed"] == ["resumed from step 2"] and r["ckpt_steps_after_4"] == [2, 3, 4]
          and r["optimizer_count"] == 4, f"tools.train --n_step 4 did not resume: {r}")
    check(r["device"].startswith("cuda") and r["param_dtypes"] == ["torch.float32"]
          and r["npz_finite"], f"tools.train on the card: {r}")


def _family_step(model_type: str, tag: str, dmadapt=None) -> dict:
    """One bf16 step of a family at its config's size and batch on the card
    from a seeded pipeline batch, and step 1's loss against the CPU: the
    CPU's f32 loss against the card's f32 loss (TF32 off, no update) and
    the bf16 step's."""
    import torch
    from hyperpose_torch import models as Model
    from hyperpose_torch.train.domainadapt import UnlabeledPipeline

    cfg16 = _train_cfg(model_type, "bfloat16", tag + "_bf16", dmadapt=dmadapt)
    cfg32 = _train_cfg(model_type, "float32", tag + "_f32", dmadapt=dmadapt)
    batch = _train_batches(cfg16, 1)[0][0]
    unl = None
    if dmadapt:
        up = UnlabeledPipeline(dmadapt, Model.get_augmentor(cfg16), cfg16.train.batch_size)
        unl = up.next()
        up.stop()
    out = {"input": f"{cfg16.model.hin}x{cfg16.model.win}", "batch": cfg16.train.batch_size}
    losses = {}
    for key, cfg, device in (("cpu_f32", cfg32, "cpu"), ("f32", cfg32, "cuda"),
                             ("bf16", cfg16, "cuda")):
        tr = _trainer(cfg, device)
        if dmadapt:
            tr.init_dmadapt_state()
            m = tr.step(batch, unl) if key == "bf16" or device == "cpu" else None
            if m is None:
                continue
        elif key == "bf16":
            m = tr.step(batch)
            out["step_ms"] = wall_ms(lambda: tr.step(batch), iters=5, warmup=1)[0]
        else:
            m = tr.loss_and_grads(batch, grads=False)[0]
        losses[key] = {k: float(v) for k, v in m.items()}
        del tr
        torch.cuda.empty_cache()
    ref = losses["cpu_f32"]["total_loss"]
    for key, tol in (("f32", 1e-4), ("bf16", TRAIN_BF16_RTOL)):
        if key in losses:
            rel = abs(losses[key]["total_loss"] - ref) / abs(ref)
            out[f"{key}_loss_rel_vs_cpu"] = rel
            check(np.isfinite(losses[key]["total_loss"]) and rel <= tol,
                  f"{tag} {key} step-1 loss {losses[key]['total_loss']} vs the CPU's {ref}")
    out["losses"] = losses
    return out


def phase_train(card, frames) -> dict:
    """The training path of the port on the card: the flagship
    (Lightweight-OpenPose on VggTiny) at 368x432, batch 8, Adam, from a
    seeded `TrainPipeline` batch of the seed-0 synthetic set: step 1 on the
    card against the CPU in f32 (TF32 off) and against float64
    (`train_step1_vs_cpu`, `check_step1`), OVERFIT_STEPS steps on that
    batch in f32 and in bf16 (timed; the loss must fall below 0.8x), the
    bf16 run's `newest_model.npz` served by a bf16 `PoseEngine` (one launch
    each of `peak_topk` and `limb_scores`) and scored by `Evaluator` on 16
    val scenes (AP recorded, not gated), a checkpoint resumed on the card
    bit for bit (`train_resume`), the entry point run and resumed
    (`train_cli`), then one bf16 step each of PoseProposal, PifPaf and
    domain adaptation with step 1's loss against the CPU, and
    `TrainPipeline` alone (4 workers). Returns the serving check's
    launches."""
    import glob

    import torch
    from hyperpose_torch.data.synthetic import generate_synthetic_coco
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.runtime.engine import PoseEngine

    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    generate_synthetic_coco(TRAIN_ROOT, n_train=TRAIN_SCENES, n_val=8, seed=0, emit_mpii=False)
    cfg32 = _train_cfg("LightweightOpenpose", "float32", "flagship_f32", "Vggtiny")
    cfg16 = _train_cfg("LightweightOpenpose", "bfloat16", "flagship_bf16", "Vggtiny")
    batches = _train_batches(cfg32, 4)[0]
    batch = batches[0]
    step1 = train_step1_vs_cpu(cfg32, batch)
    emit("train_step1", card=card, **step1)
    check_step1(step1)
    runs = {}
    for key, cfg in (("f32", cfg32), ("bf16", cfg16)):
        runs[key], tr = _train_run(cfg, batch)
        check(runs[key]["loss_ratio"] < 0.8, f"{key} training: loss {runs[key]}")
        if key == "bf16":
            check(all(p.dtype == torch.float32 for p in tr.model.parameters()),
                  "bf16 training holds non-float32 parameters")
            npz = tr.save(OVERFIT_STEPS)
        del tr
        torch.cuda.empty_cache()
    emit("train_runs", card=card, **runs)
    eng = PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), npz,
                     max_batch_size=BATCH, device="cuda")
    eng.warmup()
    _, served = drive(eng, frames[:BATCH])
    check(served["peak_topk"] == 1 and served["limb_scores"] == 1,
          f"the trained npz's serving step launched {served}")
    del eng
    if not os.path.exists(os.path.join(EVAL_ROOT, "annotations", "person_keypoints_val2017.json")):
        with open(EVAL_FIXTURE) as f:
            _synth_val_set(json.load(f))
    ecfg, emodel, dataset = _eval_setup("LightweightOpenpose", "Vggtiny", "bfloat16", npz)
    scored = _evaluate(ecfg, emodel, dataset, limit=16)
    del emodel
    torch.cuda.empty_cache()
    resume = train_resume(cfg16, batches)
    check(resume["bitwise"] and resume["ckpt_steps"] == [2, 3, 4]
          and resume["optimizer_count"] == 4, f"resume on the card: {resume}")
    cli = train_cli()
    check_train_cli(cli)
    val_jpgs = sorted(glob.glob(os.path.join(EVAL_ROOT, "val2017", "*.jpg")))
    family = {"ppn": _family_step("PoseProposal", "ppn"),
              "pifpaf": _family_step("Pifpaf", "pifpaf"),
              "dmadapt": _family_step("LightweightOpenpose", "dmadapt", dmadapt=val_jpgs)}
    _, pipe_rate = _train_batches(cfg16, 12, workers=4)
    emit("train", card=card, model="LightweightOpenpose (Vggtiny)",
         input="x".join(map(str, INPUT_HW)), batch=cfg16.train.batch_size,
         optimizer="Adam, lr 1e-4", step1_vs_cpu=step1, runs=runs,
         served={"launches": served, "eval_scenes": 16,
                 "AP": scored["metrics"]["AP"], "eval_launches": scored["launches"]},
         resume=resume, entry_point=cli, family=family, pipeline_batches_per_s=pipe_rate,
         seconds=time.perf_counter() - t_phase)
    return served


# -- pretraining, multi-rank training and serving, the TensorLayer import ----------

FLAGSHIP_NPZ = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
PRETRAIN_ROOT = os.path.join(REPO, "build", "pretrain_synth")   # gitignored
PRETRAIN_SIZE, PRETRAIN_BATCH = 224, 32   # PretrainConfig's batch, the reference's size
PRETRAIN_STEPS = 30      # timed steps in each dtype
PRETRAIN_RUN = 100       # steps of `single_pretrain`; the loss must fall below 0.8x
PRETRAIN_LOSS_RTOL = 1e-5   # step 1, card vs CPU, f32 with TF32 off, 4 images


def _pretrain_cfg(tag: str, **over):
    """The port's pretraining config (PretrainConfig's lr 5e-4, wd 1e-5,
    batch 32), its model dir emptied under PRETRAIN_ROOT/runs/<tag>."""
    from hyperpose_torch import config as Config

    Config.reset()
    Config.set_pretrain(True)
    kw = dict(log_interval=10 ** 9, val_interval=10 ** 9, save_interval=10 ** 9,
              lr_decay_step=10 ** 9, pretrain_model_dir=os.path.join(PRETRAIN_ROOT, "runs", tag))
    kw.update(over)
    for k, v in kw.items():
        Config._set("pretrain", k, v)
    cfg = Config.get_config(create_dirs=False)
    Config.reset()
    shutil.rmtree(cfg.pretrain.pretrain_model_dir, ignore_errors=True)
    return cfg


def pretrain_resume(train_root: str) -> dict:
    """`single_pretrain` on the card with cuDNN's deterministic algorithms
    at 64x64, batch 8, lr / 5 every 2 steps: 2 steps (a checkpoint), then a
    run that resumes to step 4, against the same 4 steps taken straight in
    memory on the batches the resumed run reads (its data order restarts,
    as the JAX loop's does). Equal bit for bit, and the decayed lr kept."""
    import torch
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.train import pretrain as PP

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = _pretrain_cfg("resume", batch_size=8, lr_decay_step=2, save_interval=2)
        ds, _ = PP.load_imagenet_splits(train_root, 64)
        PP.single_pretrain(VggTiny, cfg, dataset=ds, n_step=2, device="cuda")
        resumed, _ = PP.single_pretrain(VggTiny, cfg, dataset=ds, n_step=4, device="cuda")
        lr_saved = torch.load(os.path.join(cfg.pretrain.pretrain_model_dir, "ckpt", "4.pt"),
                              map_location="cpu")["optimizer"]["lr"]
        model = PP.pretrain_model(VggTiny, 64, "cuda")
        opt = PP.pretrain_optimizer(model, cfg)
        step = PP.PretrainStep(model, opt, torch.float32)
        for _ in range(2):      # each run's data: a fresh seed-0 epoch
            for (images, labels), _ in zip(ds.batches(8, np.random.default_rng(0)), range(2)):
                step(images, labels)
            opt.set_learning_rate(opt.learning_rate / 5.0)
    finally:
        torch.backends.cudnn.deterministic = det
    a, b = resumed.state_dict(), model.state_dict()
    return {"bitwise": all(torch.equal(a[k], b[k]) for k in b),
            "max_abs_diff": max(float((a[k].double() - b[k].double()).abs().max()) for k in b),
            "lr_kept": lr_saved == opt.learning_rate, "lr": lr_saved}


def phase_pretrain(card) -> dict:
    """ImageNet pretraining on the card: VggTiny with its classifier head at
    224x224, batch 32, Adam with decayed weights (lr 5e-4, wd 1e-5), on a
    10-class synthetic twin the port generates at 224 (20 train and 5 val
    images a class): step 1 on 4 images against the CPU in f32 (TF32 off);
    PRETRAIN_STEPS timed steps in f32 and in bf16 on one batch (median /
    p80, images/s, device busy ms, idle share, kernels a step, peak
    memory); `single_pretrain` for PRETRAIN_RUN steps in bf16 (the loss must
    fall below 0.8x; a scheduled lr / 5 at step 50; validation top-1 at
    steps 50 and 100); a resume bit for bit (`pretrain_resume`); the npz
    grafted into the flagship (its count). Pretraining launches none of the
    kernels (counted over the timed steps)."""
    import torch
    from hyperpose_torch.data.synthetic import generate_synthetic_imagenet
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.train import pretrain as PP

    t_phase = time.perf_counter()
    shutil.rmtree(PRETRAIN_ROOT, ignore_errors=True)
    root = generate_synthetic_imagenet(os.path.join(PRETRAIN_ROOT, "data"), n_classes=10,
                                       n_train_per_class=20, n_val_per_class=5,
                                       size=PRETRAIN_SIZE, seed=0)
    train_ds, val_ds = PP.load_imagenet_splits(root, PRETRAIN_SIZE)
    images, labels = next(train_ds.batches(PRETRAIN_BATCH, np.random.default_rng(0)))
    cfg = _pretrain_cfg("steps")
    losses = {}
    for device in ("cpu", "cuda"):
        m = PP.pretrain_model(VggTiny, PRETRAIN_SIZE, device)
        losses[device] = float(PP.PretrainStep(m, PP.pretrain_optimizer(m, cfg), torch.float32)
                               .loss_and_grads(images[:4], labels[:4])[0])
        del m
    step1 = {"loss": losses["cuda"], "cpu_loss": losses["cpu"],
             "loss_rel": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])}
    check(step1["loss_rel"] <= PRETRAIN_LOSS_RTOL, f"pretrain step 1 vs CPU: {step1}")
    counters = _launch_counters()
    for k in counters:
        k.launches = 0
    runs = {}
    for key, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = PP.pretrain_model(VggTiny, PRETRAIN_SIZE, "cuda")
        step = PP.PretrainStep(m, PP.pretrain_optimizer(m, cfg), dtype)

        def one():
            step(images, labels)

        med, p80 = wall_ms(one, iters=PRETRAIN_STEPS, warmup=3)
        torch.cuda.reset_peak_memory_stats()
        busy, kernels = device_busy(one, iters=3)
        runs[key] = {"step_ms": med, "step_p80_ms": p80,
                     "images_per_s": 1e3 * PRETRAIN_BATCH / med, "device_busy_ms": busy,
                     "idle_share": 1.0 - busy / med, "kernels_per_step": kernels,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del m, step
        torch.cuda.empty_cache()
    launched = {k.__name__: k.launches for k in counters if k.launches}
    check(not launched, f"a pretraining step launched a serving kernel: {launched}")
    run_cfg = _pretrain_cfg("run", log_interval=1, val_interval=50, lr_decay_step=50)
    t0 = time.perf_counter()
    model, history = PP.single_pretrain(VggTiny, run_cfg, dataset=train_ds, val_dataset=val_ds,
                                        n_step=PRETRAIN_RUN, device="cuda",
                                        compute_dtype=torch.bfloat16)
    run_s = time.perf_counter() - t0
    first, last = history["log"][0]["loss"], history["log"][-1]["loss"]
    check(last < 0.8 * first, f"pretraining loss {first} -> {last}")
    check(history["lr_events"] == [("schedule", 50), ("schedule", 100)],
          f"pretraining lr events {history['lr_events']}")
    npz = os.path.join(run_cfg.pretrain.pretrain_model_dir, "newest_VggTiny.npz")
    grafted = PP.load_pretrained_backbone(LightWeightOpenPose(backbone=VggTiny), npz)
    check(grafted == 45, f"the pretrained npz grafted {grafted} tensors into the flagship")
    del model
    torch.cuda.empty_cache()
    resume = pretrain_resume(os.path.join(root, "train"))
    check(resume["bitwise"] and resume["lr_kept"], f"pretraining resume: {resume}")
    out = {"model": "VggTiny (pretraining head, fc1 18816 -> 4096)", "input": PRETRAIN_SIZE,
           "batch": PRETRAIN_BATCH, "optimizer": "Adam + decayed weights, lr 5e-4, wd 1e-5",
           "step1_vs_cpu": step1, "runs": runs,
           "single_pretrain": {"steps": PRETRAIN_RUN, "seconds": run_s, "first_loss": first,
                               "last_loss": last, "loss_ratio": last / first,
                               "lr_events": history["lr_events"], "val": history["val"]},
           "resume": resume, "grafted_into_flagship": grafted,
           "seconds": time.perf_counter() - t_phase}
    emit("pretrain", card=card, **out)
    return out


PARALLEL_ROOT = os.path.join(REPO, "build", "parallel")   # gitignored
PARALLEL_X64_RTOL = 1e-9     # ranks against one process on the same device, float64
PARALLEL_MODES_SEED = 30
PARALLEL_LOSS_RTOL = 1e-6    # the losses, which sum float32 casts of the maps
PARALLEL_SMALL = {"model": "flagship", "model_type": "LightweightOpenpose", "hw": [64, 80],
                  "out_hw": [8, 10], "batch": 8}   # the narrow flagship, as the CPU tests


def _rank_inputs(tag: str, spec: dict, arrays: dict) -> str:
    import torch_dist_worker as W

    path = os.path.join(PARALLEL_ROOT, tag)
    shutil.rmtree(path, ignore_errors=True)
    W.write_inputs(path, spec, arrays)
    return path


def ranks_vs_one_process(ranks: list, ref: dict, tag: str,
                         rtol: float = PARALLEL_X64_RTOL) -> float:
    """The largest relative difference of any output under `tag` between a
    rank and the one-process run (each tensor's max |value|, floored at
    1e-6 of its collection's largest; the metrics, float32 losses, in their
    own bound): fails beyond `rtol` (PARALLEL_LOSS_RTOL for the metrics)."""
    keys = [k for k in ref if k.startswith(tag + "/") and not k.endswith("step_s")]
    top: dict = {}
    for k in keys:
        g = k.split("/")[1]
        top[g] = max(top.get(g, 0.0), float(np.abs(ref[k]).max()))
    worst = 0.0
    for r, out in enumerate(ranks):
        for k in keys:
            e = float(np.abs(np.asarray(out[k], np.float64) - ref[k]).max()) / max(
                float(np.abs(ref[k]).max()), 1e-6 * top[k.split("/")[1]], 1e-30)
            metric = "/metrics/" in k or k.split("/")[1].startswith("step")
            bound = max(PARALLEL_LOSS_RTOL, rtol) if metric else rtol
            check(e <= bound, f"rank {r} {k}: {e} from one process")
            if not metric:
                worst = max(worst, e)
    return worst


def _rel_l2(got: dict, want: dict) -> tuple[float, float]:
    """(worst tensor, over all) relative L2 distance of the tensors `got`
    from `want` (same keys; each norm floored at 1e-4 of the largest
    tensor's)."""
    top = max(float(np.linalg.norm(v)) for v in want.values())
    per = {k: float(np.linalg.norm(got[k] - v)) / max(float(np.linalg.norm(v)), 1e-4 * top)
           for k, v in want.items()}
    whole = (sum(float(np.sum((got[k] - v) ** 2)) for k, v in want.items())
             / sum(float(np.sum(v ** 2)) for v in want.values())) ** 0.5
    return max(per.values()), whole


def _grads_vs_f64(out: dict, ref: dict) -> tuple[float, float]:
    """(worst tensor, over all) relative L2 distance of `out`'s float32
    gradients from `ref`'s float64 ones (`_rel_l2`)."""
    return _rel_l2({k[9:]: v for k, v in out.items() if k.startswith("f32/grads/")},
                   {k[9:]: v for k, v in ref.items() if k.startswith("f64/grads/")})


def _state_vs(out: dict, ref: dict, mode: str) -> tuple[float, float]:
    """`_rel_l2` of the state a sync-modes rank holds after its steps (its
    weights, statistics and Adam's moments) from `ref`'s."""
    keys = [k for k in ref if k.startswith(mode + "/") and k.split("/")[1] in (
        "after", "mu", "nu")]
    return _rel_l2({k: np.asarray(out[k], np.float64) for k in keys}, {k: ref[k] for k in keys})


def phase_parallel(card, frames) -> dict:
    """Multi-process training and serving on the card, ranks spawned by this
    script (tests/torch_dist_worker.py). Two ranks share the one card, so
    they join a gloo group (NCCL refuses two ranks on one device), whose
    all-gather and sends stage CUDA tensors through the host. Returns the
    sharded engine's launches per rank.

    - Sync_sgd: 2 ranks, each 4 rows of the flagship's batch 8 at 368x432
      (the flagship checkpoint's weights, a seeded pipeline batch), one
      Adam step in float64 and in float32, against one process on the card:
      float64 within 1e-9, float32 held to that float64 step with PR 14's
      bounds (0.1 a tensor, 2e-2 over all, relative L2);
    - NCCL at world size 1: a float32 step with cuDNN deterministic equal
      bit for bit to the one-process step;
    - Sync_avg and Pair_avg, `sync_modes_on_card`;
    - `ShardedStreamEngine`: 2 ranks, the bf16 flagship, 16 frames: the
      people of one engine on the same 16 frames, and per rank one launch
      of `peak_topk` and of `limb_scores` for its step;
    - one step under `tracing.device_profile`: its trace lists CUDA kernels.

    The walls are recorded: two ranks share one card, so they are not a
    scaling number. Also returns the Sync_sgd step's (spec, inputs,
    one-process outputs), which `phase_spatial` holds its ranks to."""
    import torch
    import torch_dist_worker as W
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.human import SkeletonBatch
    from hyperpose_torch.utils.tracing import device_profile
    from hyperpose_torch.utils.weights import read_flax_weights

    t_phase = time.perf_counter()
    shutil.rmtree(PARALLEL_ROOT, ignore_errors=True)
    if not os.path.isdir(os.path.join(TRAIN_ROOT, "train2017")):
        from hyperpose_torch.data.synthetic import generate_synthetic_coco

        generate_synthetic_coco(TRAIN_ROOT, n_train=TRAIN_SCENES, n_val=8, seed=0,
                                emit_mpii=False)
    flagship = {f"w/{k}": v for k, v in read_flax_weights(FLAGSHIP_NPZ).items()}
    cfg = _train_cfg("LightweightOpenpose", "float32", "parallel", "Vggtiny")
    full = {"model": "flagship_full", "model_type": "LightweightOpenpose",
            "hw": list(INPUT_HW), "out_hw": [INPUT_HW[0] // 8, INPUT_HW[1] // 8],
            "batch": cfg.train.batch_size, "device": "cuda", "backend": "gloo"}
    batch = {f"b0/{k}": v for k, v in _train_batches(cfg, 1)[0][0].items()}
    sgd = _rank_inputs("sync_sgd", full, {**flagship, **batch})
    nccl = _rank_inputs("nccl1", dict(full, backend="nccl", tags=["f32"], deterministic=True),
                        {**flagship, **batch})
    stream_frames = [resize_bilinear(f, INPUT_HW) for f in frames[:BATCH]]
    stream_frames = np.stack(stream_frames + [f[:, ::-1] for f in stream_frames])
    stream = _rank_inputs("stream", {"hw": list(INPUT_HW), "dtype": "bfloat16",
                                     "device": "cuda"}, {**flagship, "frames": stream_frames})

    t0 = time.perf_counter()
    runs = {"sync_sgd": W.start("sync_sgd", 2, sgd, timeout=600)}
    ref = W.run_case("sync_sgd", sgd)
    ref_s = {k: float(v) for k, v in ref.items() if k.endswith("step_s")}
    ranks = W.finish(runs.pop("sync_sgd"))
    sgd_s = time.perf_counter() - t0
    x64 = ranks_vs_one_process(ranks, ref, "f64")
    f32 = [_grads_vs_f64(o, ref) for o in ranks + [ref]]
    for tensor, whole in f32:
        check(tensor <= TRAIN_GRAD_TENSOR and whole <= TRAIN_GRAD_L2,
              f"2-rank float32 gradients vs float64: {tensor}, {whole}")

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nccl_run = W.start("sync_sgd", 1, nccl, timeout=300)
        nccl_ref = W.run_case("sync_sgd", nccl)
        (nccl_out,) = W.finish(nccl_run)
    finally:
        torch.backends.cudnn.deterministic = det
    nccl_equal = all(np.array_equal(nccl_out[k], v) for k, v in nccl_ref.items()
                     if not k.endswith("step_s"))
    check(nccl_equal, "an NCCL group of one changed the step")

    modes = sync_modes_on_card(PARALLEL_MODES_SEED)

    one = PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), FLAGSHIP_NPZ,
                     input_hw=INPUT_HW, max_batch_size=BATCH, device="cuda")
    one.warmup()
    t0 = time.perf_counter()
    stream_run = W.start("stream", 2, stream, timeout=300)
    singles = [one.infer_batch_device(stream_frames[i:i + BATCH]) for i in (0, BATCH)]
    stream_ranks = W.finish(stream_run)
    stream_s = time.perf_counter() - t0
    fields = ("coords", "part_scores", "part_valid", "scores", "valid")
    ref_sk = SkeletonBatch(*(np.concatenate([getattr(d, f).cpu().numpy() for d in singles])
                             for f in fields))
    people, launches = 0, []
    for r, out in enumerate(stream_ranks):
        sk = SkeletonBatch(*(out[f"global/{f}"] for f in fields))
        for i in range(len(stream_frames)):
            want, got = ref_sk.to_humans(i), sk.to_humans(i)
            d = find_people(want, got)
            check(len(want) == len(got) and d is not None and d <= INT8_TOL["xy"],
                  f"rank {r} frame {i}: {len(got)} people vs one engine's {len(want)} ({d})")
            people += len(want) if r == 0 else 0
        launches.append({"peak_topk": int(out["launches/peak_topk"]),
                         "limb_scores": int(out["launches/limb_scores"])})
        check(launches[-1] == {"peak_topk": 1, "limb_scores": 1},
              f"rank {r}'s sharded step launched {launches[-1]}")

    tr = _trainer(cfg, "cuda")
    tr.step(_train_batches(cfg, 1)[0][0])
    prof_dir = os.path.join(PARALLEL_ROOT, "profile")
    with device_profile(prof_dir):
        tr.step(_train_batches(cfg, 1)[0][0])
        torch.cuda.synchronize()
    with open(os.path.join(prof_dir, "trace.json")) as f:
        trace_kernels = sum(e.get("cat") == "kernel" for e in json.load(f)["traceEvents"])
    check(trace_kernels > 0, "device_profile's trace lists no CUDA kernel")
    del tr, one
    torch.cuda.empty_cache()
    out = {"note": "two ranks share one card: not a scaling number",
           "sync_sgd": {"ranks": 2, "rows_per_rank": full["batch"] // 2, "input": full["hw"],
                        "f64_max_rel_vs_one_process": x64,
                        "f32_grad_tensor_max_rel_l2_vs_f64": [t for t, _ in f32],
                        "f32_grad_rel_l2_vs_f64": [w for _, w in f32],
                        "rank_step_s": {k: [float(o[k]) for o in ranks]
                                        for k in ("f64/step_s", "f32/step_s")},
                        "one_process_step_s": ref_s, "wall_s": sgd_s},
           "nccl_world_1_bitwise": nccl_equal,
           "sync_modes": modes,
           "stream": {"ranks": 2, "frames": len(stream_frames), "dtype": "bf16",
                      "people": people, "launches_per_rank": launches,
                      "rank_global_s": [float(o["global_s"]) for o in stream_ranks],
                      "wall_s": stream_s},
           "device_profile_kernels": trace_kernels,
           "seconds": time.perf_counter() - t_phase}
    emit("parallel", card=card, **out)
    return launches, (full, {**flagship, **batch}, ref)


SPATIAL_FORMS = ("plain", "fused", "int8")
GROUPED_INT8 = ((2, 3, 1), (2, 1, 2), (4, 3, 1), (4, 1, 2))   # groups, kernel, stride


def grouped_int8_on_card() -> dict:
    """Grouped int8 convs (`Int8Conv2d.parts`, one dense int8 conv a group)
    at 128 channels on 46x54 maps, batch 8, bf16 activations, channels-last:
    the kernels' output equal to the plain version (`int8_quantize_plain`,
    then each group's `conv_plain`) on the card, bit for bit, and
    `int8_conv` launched once a group."""
    import torch
    from hyperpose_torch import quant
    from hyperpose_torch.ops.kernels.int8_gemm import int8_conv, int8_quantize_plain

    rng = np.random.default_rng(7)
    out = {}
    for groups, k, stride in GROUPED_INT8:
        cin = cout = 128
        conv = torch.nn.Conv2d(cin, cout, k, stride=stride, groups=groups,
                               padding=k // 2 if stride == 1 else 0)
        kernel = (rng.normal(0, 1, (k, k, cin // groups, cout)) / k).astype(np.float32)
        bias = rng.normal(0, 0.1, cout).astype(np.float32)
        q = quant.Int8Conv2d.from_conv(conv, kernel, bias, 4.0).cuda()
        x = torch.from_numpy(rng.normal(0, 1, (BATCH, cin, *FEAT_HW)).astype(np.float32)).to(
            "cuda", torch.bfloat16).contiguous(memory_format=torch.channels_last)
        int8_conv.launches = 0
        got = q.rows(x)
        launched = int8_conv.launches
        n = cin // groups
        want = torch.cat([p.conv_plain(int8_quantize_plain(x[:, g * n:(g + 1) * n], p.inv_s,
                                                           p.w_taps.shape[-1], p.fold), x.dtype)
                          for g, p in enumerate(q.parts)], dim=1)
        key = f"g{groups}_{k}x{k}_s{stride}"
        check(torch.equal(got, want), f"grouped int8 conv {key}: kernels vs plain differ")
        check(launched == groups, f"grouped int8 conv {key}: {launched} int8_conv launches")
        out[key] = {"equal": True, "int8_conv_launches": launched}
    return out


def tf_plan_families() -> list:
    """(name, () -> the float32 model with its weights, served input size)
    of every model the TF exports take, the slowest to plan first: each
    served family (`served_weights`), Lightweight-OpenPose on every other
    backbone, and on the flagship checkpoint in its three serving forms
    (plain, S2D stem, fused stem)."""
    from hyperpose_torch.models import backbones as B
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

    def lw(backbone, weights=None):
        def make():
            model = LightWeightOpenPose(backbone=backbone)
            return load_flax_weights(model, random_flax_weights(model, 0)
                                     if weights is None else weights())
        return make

    out = [(spec.name, lambda spec=spec: load_flax_weights(spec.model(), served_weights(spec)),
            spec.hw)
           for spec in (MBTHIN_OPENPOSE, OPENPOSE_VGG19, MBSMALL_OPENPOSE, PIFPAF,
                        LW_MOBILENET, LW_RESNET18, PPN)]
    out += [(f"lw_{b.__name__.lower()}", lw(b), INPUT_HW)
            for b in (B.MobilenetV2, B.Vgg16, B.Vgg19, B.MobilenetV1, B.VggTinyS2D)]
    return out + [
        ("flagship", lw(B.VggTiny, lambda: FLAGSHIP_NPZ), INPUT_HW),
        ("flagship_s2d_stem", lw(B.VggTinyS2DStem,
                                 lambda: B.remap_vggtiny_to_s2d(FLAGSHIP_NPZ)), INPUT_HW),
        ("flagship_fused_stem", lw(B.VggTinyFusedStem,
                                   lambda: B.remap_vggtiny_to_fused(FLAGSHIP_NPZ)), INPUT_HW)]


TF_PLAN_WORKERS = 4   # processes planning the families (8 host cores on the card's machine)


def tf_plan_one(name: str) -> dict:
    """In a worker: the `tf_plan_families` model `name` on the card, its
    float32 forward at its served size, batch 1, captured there and planned
    as TF ops (`utils/tf_lower.py`, non-strict: unlowered ops are listed)."""
    from hyperpose_torch.utils import tf_lower

    make, hw = {n: (m, hw) for n, m, hw in tf_plan_families()}[name]
    t0 = time.perf_counter()
    plan = tf_lower.plan_forward(make().cuda().eval(), (1, *hw, 3), strict=False)
    return {"family": name, "hw": list(hw), "nodes": plan.nodes, "tf_ops": len(plan.steps),
            "unlowered": plan.unlowered, "histogram": plan.histogram(),
            "seconds": time.perf_counter() - t0}


def tf_plans_start():
    """Plan every family in TF_PLAN_WORKERS spawned processes while this one
    goes on (capture and lowering are host work, about 90 s in one process
    on the card's machine); `tf_plans_finish` collects them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(TF_PLAN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return time.perf_counter(), pool, [pool.submit(tf_plan_one, name)
                                       for name, _, _ in tf_plan_families()]


def tf_plans_finish(started) -> dict:
    """One line a family (graph nodes, TF ops by name, unlowered ops, which
    fail the run) and the workers stopped."""
    t0, pool, futures = started
    try:
        rows = [f.result(timeout=600) for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    for r in rows:
        emit("tf_plan", **{**r, "unlowered": len(r["unlowered"])})
        check(not r["unlowered"], f"tf_lower: {r['family']} has unlowered ops {r['unlowered']}")
    return {"families": len(rows), "unlowered": 0,
            "tf_ops": {r["family"]: r["tf_ops"] for r in rows},
            "plans_wall_s": time.perf_counter() - t0}


def tf_export_tool(out_dir: str, device: str) -> dict:
    """`tools.export_model --format pb` of the flagship on `device`. Where
    `import tensorflow` fails (the card's machine has no TensorFlow), the
    tool must raise an ImportError naming tensorflow and write nothing.
    Where it works, the reloaded `.pb`'s maps of the synthetic frame at
    368x432, decoded by the engine's decoder, hold the flagship's two people
    (17.0187 and 8.584, within 1e-3; tests/test_torch_export_tflite.py)."""
    import contextlib
    import io
    import shutil

    import torch
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.tools import export_model
    from hyperpose_torch.utils.human import SkeletonBatch

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--model_backbone", "Vggtiny", "--weights", FLAGSHIP_NPZ, "--model_name",
            "flagship", "--format", "pb", "--output_dir", out_dir, "--device", device]
    try:
        import tensorflow as tf
    except ImportError:
        try:
            export_model.run(argv)
        except ImportError as e:
            check("tensorflow" in str(e), f"export_model without tensorflow: {e}")
            check(not os.path.exists(out_dir), "export_model wrote files without tensorflow")
            return {"tensorflow": False, "refused_with_import_error": True}
        fail("export_model --format pb ran without tensorflow")
    with contextlib.redirect_stdout(io.StringIO()):
        res = export_model.run(argv)
    graph_def = tf.compat.v1.GraphDef()
    with open(res["pb"], "rb") as f:
        graph_def.ParseFromString(f.read())
    frame = np.load(os.path.join(REPO, "hyperpose_torch", "assets",
                                 "synth_000000001601.npz"))["rgb"]
    x = resize_bilinear(frame, INPUT_HW)[None].astype(np.float32) / 255.0
    conf, paf = tf.function(lambda inp: tf.graph_util.import_graph_def(
        graph_def, input_map={"input:0": inp},
        return_elements=["Identity:0", "Identity_1:0"]))(tf.constant(x))
    engine = res["engine"]
    d = engine.decode_outputs({"conf_map": torch.from_numpy(conf.numpy()).to(engine.device),
                               "paf_map": torch.from_numpy(paf.numpy()).to(engine.device)})
    scores = sorted((h.score for h in SkeletonBatch(*(
        getattr(d, f).cpu().numpy() for f in FIELDS)).to_humans(0)), reverse=True)
    check(len(scores) == 2 and np.allclose(scores, [17.0187, 8.584], rtol=0, atol=1e-3),
          f"the flagship's .pb decoded to scores {scores}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"tensorflow": True, "people": scores}


def tools_on_card(frames) -> dict:
    """`tools.export_model --with_decode` of the flagship (batch 8, the
    config's bf16) on the card: its `.pt2` loads and equals the eager step
    bit for bit on `frames`; `tools.measure_flops` on the card counts what
    it counts from the shapes alone (the meta device); meanwhile every
    family planned as TF ops on the card (`tf_plans_start`), then the TF
    export tool (`tf_export_tool`: on the card's machine, its refusal
    without TensorFlow)."""
    import contextlib
    import io

    import torch
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.tools import export_model, measure_flops

    plans = tf_plans_start()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = export_model.run(["--model_backbone", "Vggtiny", "--weights", FLAGSHIP_NPZ,
                                "--with_decode", "--batch_size", str(BATCH), "--model_name",
                                "flagship", "--output_dir", os.path.join(REPO, "build", "export")])
        export_s = time.perf_counter() - t0
        x = torch.from_numpy(frames[:BATCH]).cuda()
        eager = res["engine"]._step(x)
        loaded = PoseEngine.load_executable(res["executable"])(x)
        equal = all(torch.equal(t, getattr(eager, f)) for f, t in zip(FIELDS, loaded))
        card, meta = measure_flops.run([]), measure_flops.run(["--device", "meta"])
    check(equal, "export_model's program differs from the eager step")
    check(card["flops"] == meta["flops"] > 0 and card["params"] == meta["params"],
          f"measure_flops on the card {card} vs the shapes {meta}")
    del res
    tf_export = tf_plans_finish(plans)
    t0 = time.perf_counter()
    tf_export["tool"] = tf_export_tool(os.path.join(REPO, "build", "export_tf"), "cuda")
    tf_export["tool_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {"export_s": export_s, "pt2_equals_eager": equal,
            "gflop_frame": card["flops"] / 1e9, "params": card["params"],
            "tf_export": tf_export}


def phase_spatial(card, frames, step) -> dict:
    """Spatial parallelism on the card (`parallel/spatial.py`): ranks
    spawned by this script share the one card over gloo (NCCL refuses two
    ranks on one device), whose sends and all-gathers stage CUDA tensors
    through the host. Two groups run one after the other, 2 ranks (sp = 2)
    and 4 ranks (dp = 2 x sp = 2), each rank taking 184 of the 368 rows:

    - training: the flagship checkpoint at 368x432, batch 8 (`step`: the
      `parallel` phase's inputs and its one-process step on the card), one
      Adam step in float64 within 1e-9 of one process, and in float32 its
      gradients held to that float64 step with the `train` phase's bounds
      (TRAIN_GRAD_TENSOR a tensor, TRAIN_GRAD_L2 over all, relative L2);
    - serving: `ShardedStreamEngine(spatial=2)` on 16 frames in bf16 with the
      plain stem, bf16 with the fused stem and int8 (bf16 activations): every
      rank finds one engine's people on the same frames (`find_people`,
      INT8_TOL), and each rank's measured global batch launched `peak_topk`
      and `limb_scores`, `conv1_pool` (fused) and `int8_conv` (int8);
    - meanwhile (the 2 ranks') in this process: grouped int8 convs
      (`grouped_int8_on_card`) and the export and FLOP-count tools
      (`tools_on_card`).

    The walls are recorded: the ranks share one card, so they are not a
    scaling number. Returns each form's launches per rank."""
    import torch
    import torch_dist_worker as W
    from hyperpose_torch.ops.image import resize_bilinear
    from hyperpose_torch.utils.human import SkeletonBatch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    spec, arrays, ref = step
    weights = {k: v for k, v in arrays.items() if k.startswith("w/")}
    stream_frames = [resize_bilinear(f, INPUT_HW) for f in frames[:BATCH]]
    stream_frames = np.stack(stream_frames + [f[:, ::-1] for f in stream_frames])
    stream_spec = {"hw": list(INPUT_HW), "dtype": "bfloat16", "device": "cuda", "spatial": 2,
                   "forms": list(SPATIAL_FORMS)}
    groups = {}
    for world in (2, 4):
        train = _rank_inputs(f"spatial{world}/train", dict(spec, spatial=2), arrays)
        stream = _rank_inputs(f"spatial{world}/stream", stream_spec,
                              {**weights, "frames": stream_frames})
        top = os.path.join(PARALLEL_ROOT, f"spatial{world}")
        W.write_inputs(top, {"runs": [["sync_sgd", train], ["stream", stream]],
                             "device": "cuda"}, {})
        groups[world] = (train, stream, top)
    # One group at a time: a float64 step's activations take tens of GB a rank.
    t0 = time.perf_counter()
    first = W.start("group", 2, groups[2][2], timeout=900)
    grouped = grouped_int8_on_card()
    tools = tools_on_card(stream_frames)
    one = {}
    for form in SPATIAL_FORMS:
        eng = W.stream_engine(stream_spec, {**weights, "frames": stream_frames}, form,
                              len(stream_frames), "cuda")
        d = eng.infer_batch_device(stream_frames)
        one[form] = SkeletonBatch(*(getattr(d, f).cpu().numpy() for f in FIELDS))
        del eng
    torch.cuda.empty_cache()
    out = {"note": "the ranks share one card: not a scaling number",
           "grouped_int8": grouped, "tools": tools, "train": {}, "stream": {}}
    launches = {}
    for world, (train, stream, top) in groups.items():
        if world == 2:
            W.finish(first)
        else:
            t0 = time.perf_counter()
            W.launch("group", world, top, timeout=900)
        wall = time.perf_counter() - t0
        ranks = W.read_outputs(train, world)
        x64 = ranks_vs_one_process(ranks, ref, "f64")
        f32 = [_grads_vs_f64(o, ref) for o in ranks]
        for tensor, whole in f32:
            check(tensor <= TRAIN_GRAD_TENSOR and whole <= TRAIN_GRAD_L2,
                  f"sp ranks (world {world}) float32 gradients vs float64: {tensor}, {whole}")
        geometry = [o["geometry"].tolist() for o in ranks]
        half = INPUT_HW[0] // 2
        check(all(g[1:] == [2, r % 2, half * (r % 2), half * (r % 2 + 1)]
                  for r, g in enumerate(geometry)), f"sp ranks' rows: {geometry}")
        out["train"][f"world{world}"] = {
            "dp": world // 2, "sp": 2, "rows_per_rank": half,
            "images_per_rank": spec["batch"] // (world // 2),
            "f64_max_rel_vs_one_process": x64,
            "f32_grad_tensor_max_rel_l2_vs_f64": [t for t, _ in f32],
            "f32_grad_rel_l2_vs_f64": [w for _, w in f32],
            "rank_step_s": {k: [float(o[k]) for o in ranks]
                            for k in ("f64/step_s", "f32/step_s")},
            "peak_bytes": {case: [int(o[f"peak_bytes/{case}"]) for o in W.read_outputs(top, world)]
                           for case in ("sync_sgd", "stream")}}
        sranks = W.read_outputs(stream, world)
        people, launched = 0, {}
        for form in SPATIAL_FORMS:
            want_sk, rows = one[form], []
            for r, o in enumerate(sranks):
                sk = SkeletonBatch(*(o[f"{form}/global/{f}"] for f in FIELDS))
                for i in range(len(stream_frames)):
                    want, got = want_sk.to_humans(i), sk.to_humans(i)
                    d = find_people(want, got)
                    check(len(want) == len(got) and d is not None and d <= INT8_TOL["xy"],
                          f"{form} sp rank {r} (world {world}) frame {i}: {len(got)} people "
                          f"vs one engine's {len(want)} ({d})")
                    people += len(want) if r == 0 else 0
                n = {k: int(o[f"{form}/launches/{k}"]) for k in W.STREAM_KERNELS}
                need = ["peak_topk", "limb_scores"] + {"fused": ["conv1_pool"],
                                                       "int8": ["int8_conv"]}.get(form, [])
                check(all(n[k] > 0 for k in need), f"{form} sp rank {r} launched {n}")
                rows.append({k: v for k, v in n.items() if v})
            launched[form] = rows
            out["stream"].setdefault(f"world{world}", {})[form] = {
                "launches_per_rank": rows,
                "rank_global_s": [float(o[f"{form}/global_s"]) for o in sranks]}
        out["stream"][f"world{world}"]["people"] = people
        out["train"][f"world{world}"]["wall_s"] = wall
        launches[f"world{world}"] = launched
    shutil.rmtree(PARALLEL_ROOT, ignore_errors=True)   # float64 states: tens of MB a rank
    out["seconds"] = time.perf_counter() - t_phase
    emit("spatial", card=card, **out)
    return launches


def sync_modes_on_card(seed: int, gate: bool = True) -> dict:
    """Sync_avg (2 ranks, 3 steps) and Pair_avg (4 ranks, 2 steps, so both
    pairings) at the CPU tests' size (the narrow flagship, 64x80, batch 8,
    random weights and batches from `seed`), float64 steps, cuDNN
    deterministic: the card's gloo ranks within PARALLEL_X64_RTOL of one
    process standing for them on the card
    (`torch_dist_worker.one_process_sync_modes`; with `gate` False, nothing
    fails). Recorded beside it, not bounded: the card's ranks against the
    CPU's gloo ranks, and the target entries the two devices build more
    than 1e-3 apart (none on seeds 30 to 42). The losses sum float32 casts
    of the maps, so each device's float64 gradients carry float32 rounding,
    and these few-row steps amplify it: on seeds 30 to 42 the card's state
    after the steps lay 9e-9 to 0.06 apart from the CPU's in relative L2
    (PERF.md §5), and on the CPU alone a 1e-7 relative change of the
    initial weights moves seed 32's Sync_avg state by 0.35. No bound on the
    card against the CPU holds for every seed."""
    import torch
    import torch_dist_worker as W
    from hyperpose_torch.data.targets import openpose_targets
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY
    from hyperpose_torch.utils.weights import random_flax_weights

    small = {f"w/{k}": v for k, v in random_flax_weights(
        W.make_model("flagship")[0], 5).items()}
    rng = np.random.default_rng(seed)
    for i in range(3):
        small.update({f"b{i}/{k}": v for k, v in _small_batch(rng).items()})
    # target entries that the two devices' float32 put on either side of a
    # threshold (the Gaussian's cutoff, a limb band's edges)
    apart = []
    for i in range(3):
        maps = [openpose_targets(*(torch.as_tensor(small[f"b{i}/{k}"][:, :, :18], device=d)
                                   for k in ("kpts", "valid")), COCO_TOPOLOGY.limbs,
                                 tuple(PARALLEL_SMALL["hw"]), tuple(PARALLEL_SMALL["out_hw"]))
                for d in ("cuda", "cpu")]
        apart.append(sum(int((maps[0][k].cpu() - maps[1][k]).abs().gt(1e-3).sum())
                         for k in maps[1]))
    paths = {}
    for mode, world, steps in (("sync_avg", 2, 3), ("pair_avg", 4, 2)):
        arrays = {k: v for k, v in small.items()
                  if k.startswith("w/") or int(k[1]) < steps}
        for device in ("cuda", "cpu"):
            paths[mode, device] = (_rank_inputs(f"{mode}_{device}", dict(
                PARALLEL_SMALL, modes=[mode], device=device, deterministic=True), arrays),
                world)
    t0 = time.perf_counter()
    started = {key: W.start("sync_modes", world, path, timeout=600)
               for key, (path, world) in paths.items()}
    t1 = time.perf_counter()
    one = {mode: W.one_process_sync_modes(*paths[mode, "cuda"]) for mode in ("sync_avg",
                                                                            "pair_avg")}
    one_s = time.perf_counter() - t1
    done = {key: W.finish(run) for key, run in started.items()}
    wall_s = time.perf_counter() - t0
    out = {"seed": seed, "vs_one_process_on_card_max_rel": {}, "card_vs_cpu_max_rel": {},
           "card_vs_cpu_rel_l2": {}, "target_entries_apart": apart}
    for mode in ("sync_avg", "pair_avg"):
        out["vs_one_process_on_card_max_rel"][mode] = max(
            ranks_vs_one_process([a], b, mode, PARALLEL_X64_RTOL if gate else math.inf)
            for a, b in zip(done[mode, "cuda"], one[mode]))
        out["card_vs_cpu_max_rel"][mode] = max(
            ranks_vs_one_process([a], b, mode, math.inf)
            for a, b in zip(done[mode, "cuda"], done[mode, "cpu"]))
        l2 = [_state_vs(a, b, mode) for a, b in zip(done[mode, "cuda"], done[mode, "cpu"])]
        out["card_vs_cpu_rel_l2"][mode] = {"tensor": max(t for t, _ in l2),
                                           "whole": max(w for _, w in l2)}
    out.update(one_process_s=one_s, wall_s=wall_s)
    for path, _ in paths.values():
        shutil.rmtree(path, ignore_errors=True)   # float64 states: tens of MB a rank
    return out


def sync_modes_readings(seeds) -> None:
    """`sync_modes_on_card` on each of `seeds` (one JSON line each, no
    bound applied): how far the card and the CPU lie apart across data.
    Needs no kernel."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_card()
    for seed in seeds:
        emit("sync_modes_reading", card=card, **sync_modes_on_card(int(seed), gate=False))


def _small_batch(rng) -> dict:
    """A seeded batch of PARALLEL_SMALL's size (tests/torch_train_cases.py):
    keypoints with every case the targets treat apart, a crowd mask."""
    from torch_train_cases import bbxs_of, crowd_mask, random_people

    (h, w), b = PARALLEL_SMALL["hw"], PARALLEL_SMALL["batch"]
    kpts, valid = random_people(int(rng.integers(1 << 30)), b, 4, 19, (h, w))
    kpts[:, :, 18] = -1000.0
    valid[:, :, 18] = False
    return {"images": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), "kpts": kpts,
            "valid": valid, "mask": crowd_mask(b, tuple(PARALLEL_SMALL["out_hw"])),
            "bbxs": bbxs_of(kpts, valid)}


def phase_tl_import(card) -> dict:
    """The flagship checkpoint written in the reference's TensorLayer
    npz_dict layout (tests/tl_fixtures.py's names and build order,
    tests/torch_tl_layout.py), imported back by
    `utils.weights_import.import_tl_checkpoint` and served on the card in
    f32: the synthetic frame's 2 people with JAX's scores."""
    import torch
    from tl_fixtures import lw_openpose_entries, save_tl_npz_dict
    from torch_tl_layout import tl_layout
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.tl_orders import ORDER_KEYS
    from hyperpose_torch.utils.weights import read_flax_weights
    from hyperpose_torch.utils.weights_import import import_tl_checkpoint

    t0 = time.perf_counter()
    order = ORDER_KEYS["LightweightOpenpose"]
    path = os.path.join(REPO, "build", "tl_flagship.npz")
    entries = tl_layout(lw_openpose_entries("vggtiny")[0], read_flax_weights(FLAGSHIP_NPZ),
                        order)
    save_tl_npz_dict(entries, path)
    model = import_tl_checkpoint(LightWeightOpenPose(backbone=VggTiny), path, order)
    eng = PoseEngine(model, None, input_hw=INPUT_HW, max_batch_size=1, device="cuda")
    frame = np.load(os.path.join(REPO, "hyperpose_torch", "assets",
                                 "synth_000000001601.npz"))["rgb"]
    humans, launched = drive(eng, [frame])
    scores = sorted((h.score for h in humans[0]), reverse=True)
    check(len(scores) == 2 and float(np.abs(np.array(scores) - FLAGSHIP_SCORES).max()) <= 1e-3,
          f"the TL-imported flagship found {scores}")
    del eng, model
    torch.cuda.empty_cache()
    out = {"tl_entries": len(entries), "people": len(scores), "scores": scores,
           "launches": {k: v for k, v in launched.items() if v},
           "seconds": time.perf_counter() - t0}
    emit("tl_import", card=card, **out)
    return out


def seeded_rng():
    """The generator of the painted maps, frames and stream frames: seed 0,
    past a [B, 19, 2, 46, 54] normal draw and two [B, 19, 2560] integer
    draws. Those are the inputs on which PERF.md's times were taken, so a
    run of this script compares with them."""
    rng = np.random.default_rng(0)
    rng.standard_normal((BATCH, 19, 2, *FEAT_HW))
    for n in FEAT_HW:
        rng.integers(0, n, (BATCH, 19, 2560))
    return rng


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--loaded"]:
        loaded_worker(*sys.argv[2:4])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if sys.argv[1:2] == ["--sync-modes-readings"]:
        sync_modes_readings(sys.argv[2:])
        return
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    limbs = np.asarray(COCO_TOPOLOGY.limbs)
    rng = seeded_rng()
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    rows = [phase_limb_scores()]
    cases = _peak_maps(rng, limbs)
    rows.append(phase_peak_topk(cases))
    rows.append(phase_peak_candidates(cases))
    frames = _frames(rng)
    rows.append(phase_conv1_pool(frames))
    gemm, gemm_launches = phase_stem_gemm()
    rows.append(gemm)
    phase_decode(limbs)
    pallas_peaks = phase_decode(limbs, use_pallas_peaks=True)
    check(pallas_peaks["peak_candidates"] > 0 and pallas_peaks["peak_topk"] == 0,
          f"use_pallas_peaks decode launches: {pallas_peaks}")
    paths = phase_end_to_end(frames, card)
    phase_stream(rng, card)
    phase_pifpaf_decode(card)
    pifpaf, fields32, _ = phase_serving(PIFPAF, ("f32", "bf16"), frames, card)
    rows.append(phase_grow(fields32))
    t_int8 = time.perf_counter()
    phase_int8_gemm()
    int8_row, int8_path = phase_int8_end_to_end(frames, card)
    rows.append(int8_row)
    t_int8 = time.perf_counter() - t_int8
    t_r18 = time.perf_counter()
    phase_ppn_decode(card)
    phase_serving(PPN, ("f32", "bf16", "int8"), frames, card)
    lw_r18, _, _ = phase_serving(LW_RESNET18, ("f32", "bf16", "int8"), frames, card)
    t_r18 = time.perf_counter() - t_r18
    t_family, family, dw = time.perf_counter(), {}, []
    for spec in OPENPOSE_FAMILY:
        family[spec.name], _, spec_dw = phase_serving(spec, ("f32", "bf16", "int8"), frames,
                                                      card)
        dw += spec_dw
    for name in ("MobilenetV1", "MobilenetV2"):
        dw += backbone_dw_convs(name, frames)
    dw_rows = phase_int8_dwconv(dw, card)
    del dw
    t_family = time.perf_counter() - t_family
    t_facade = time.perf_counter()
    facade = phase_facade_cli(frames, card)
    t_facade = time.perf_counter() - t_facade
    t_eval = time.perf_counter()
    evaluation = phase_evaluate(card)
    t_eval = time.perf_counter() - t_eval
    t_train = time.perf_counter()
    train_served = phase_train(card, frames)
    t_train = time.perf_counter() - t_train
    t_new = time.perf_counter()
    phase_pretrain(card)
    stream_launches, step = phase_parallel(card, frames)
    phase_tl_import(card)
    t_new = time.perf_counter() - t_new
    t_spatial = time.perf_counter()
    spatial_launches = phase_spatial(card, frames, step)
    t_spatial = time.perf_counter() - t_spatial
    # The depthwise kernel's own path: the 11 depthwise convs of the int8
    # LightWeightOpenPose() step (bf16 activations).
    lw = dw_rows["lw_mobilenet"]
    int8_row.update(dwconv_device_ms=lw["kernel_ms"], dwconv_bound_ms=lw["bound_ms"],
                    dwconv_cudnn_bf16_ms=lw["cudnn_bf16_ms"],
                    dwconv_launches=family["lw_mobilenet"]["int8"]["int8_dwconv"])
    check(int8_row["dwconv_launches"] > 0, "int8_dwconv was not launched on its path")
    # Each kernel's launches on its own path: the plain-stem f32 engine for
    # the PAF decoder kernels, the bf16 fused-stem engine for conv1_pool, the
    # use_pallas_peaks decode for peak_candidates, the f32 PifPaf engine for
    # grow, the int8 bf16 plain-stem engine for int8_gemm.cu (its conv
    # kernel, launched once per int8 conv; the probe's GEMM is on no path);
    # stem_gemm (on no path) in its own phase.
    launches = {**paths["plain_f32"],
                "conv1_pool": paths["fused_bf16"]["conv1_pool"],
                "peak_candidates": pallas_peaks["peak_candidates"],
                "grow": pifpaf["f32"]["fused_grow"], "stem_gemm": gemm_launches,
                "int8_gemm": int8_path["int8_conv"]}
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was not launched on its path")
    check(len(rows) == 7, f"{len(rows)} kernel rows")
    emit("total", seconds=time.perf_counter() - t0, int8_phases_seconds=t_int8,
         resnet18_phases_seconds=t_r18, openpose_family_phases_seconds=t_family,
         facade_cli_phase_seconds=t_facade, lw_resnet18_f32_launches=lw_r18["f32"],
         facade_cli_launches=facade, evaluate_phase_seconds=t_eval,
         evaluate_launches=evaluation, train_phase_seconds=t_train,
         train_serving_launches=train_served, pretrain_parallel_tl_import_seconds=t_new,
         sharded_stream_launches_per_rank=stream_launches, spatial_phase_seconds=t_spatial,
         spatial_stream_launches_per_rank=spatial_launches)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
