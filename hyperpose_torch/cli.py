"""Command-line inference tool of the PyTorch port.

The counterpart of `hyperpose_tpu/cli.py`, with its flags (reference:
examples/cli.cpp:15-35 — --model --post --w --h --max_batch_size --source
--runtime --keep_ratio --saving_prefix --logging) and one more, `--device`,
on top of the port's `PoseEngine` and `StreamProcessor`. Reading and writing
images and video needs OpenCV.

    python -m hyperpose_torch.cli --source video.mp4 --runtime stream
    python -m hyperpose_torch.cli --source images/ --device cpu
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import time

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hyperpose-torch CLI")
    p.add_argument("--model", type=str, default="LightweightOpenpose",
                   help="model type (a Config.MODEL name)")
    p.add_argument("--backbone", type=str, default="Default")
    p.add_argument("--post", type=str, default="paf",
                   choices=["paf", "ppn", "pifpaf"],
                   help="post-processing family (usually implied by --model)")
    p.add_argument("--w", type=int, default=432, help="input width")
    p.add_argument("--h", type=int, default=368, help="input height")
    p.add_argument("--max_batch_size", type=int, default=None,
                   help="engine batch (default: the engine's default, 8)")
    p.add_argument("--source", type=str, required=True,
                   help="video file, camera index, or image folder")
    p.add_argument("--runtime", type=str, default="operator",
                   choices=["operator", "stream"])
    p.add_argument("--keep_ratio", action="store_true")
    p.add_argument("--low_latency", action="store_true", default=None,
                   help="dispatch partial batches immediately instead of "
                   "topping up to the full batch (auto-enabled for cameras "
                   "and --imshow)")
    p.add_argument("--imshow", action="store_true",
                   help="display annotated frames in a window "
                        "(reference: cli.cpp --imshow)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="skeleton overlay blend factor "
                        "(reference: cli.cpp --alpha)")
    p.add_argument("--saving_prefix", type=str, default="output")
    p.add_argument("--weights", type=str, default=None,
                   help="weights as the JAX package's flat npz; without it "
                        "(or if the file is missing) seeded random weights "
                        "(utils/weights.py random_flax_weights, seed 0). The "
                        "JAX CLI's flax PRNGKey(0) initialization cannot be "
                        "reproduced in PyTorch, so the two CLIs agree only on "
                        "a given npz")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--logging", action="store_true")
    p.add_argument("--quantize", type=int, default=0, metavar="N",
                   help="calibrate on the first N source frames and serve "
                        "int8 (reference analog: int8 TFLite export, "
                        "export_tflite.py:29-41)")
    p.add_argument("--input_format", type=str, default="rgb8",
                   choices=["rgb8", "yuv420"],
                   help="device infeed format; yuv420 ships planar 4:2:0 "
                        "frames (half the host->device bytes) and "
                        "reconstructs RGB on the device")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the step runs: cuda (the default; raises "
                        "when no GPU is found) or cpu")
    return p.parse_args(argv)


def build_engine(args):
    """The engine of `args` on `args.device` (default cuda), and its
    topology."""
    import torch

    from . import config as Config
    from . import models as Model
    from .runtime.engine import PoseEngine
    from .utils.weights import random_flax_weights

    device = torch.device(getattr(args, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but torch finds no CUDA device; pass --device cpu "
            "to run on the CPU")
    Config.reset()
    Config.set_model_type(Config.MODEL[args.model])
    Config.set_model_backbone(Config.BACKBONE[args.backbone])
    Config.set_model_inout(hin=args.h, win=args.w,
                           hout=args.h // 8, wout=args.w // 8)
    cfg = Config.get_config(create_dirs=False)
    model = Model.get_model(cfg)
    if args.weights and os.path.exists(args.weights):
        variables = args.weights
        print(f"loaded weights: {args.weights}")
    else:
        variables = random_flax_weights(model, seed=0)
    topo = Model.get_topology(cfg)
    engine = PoseEngine(
        model, variables, input_hw=(args.h, args.w),
        max_batch_size=args.max_batch_size, keep_ratio=args.keep_ratio,
        topology=topo, fused_decode=Model._fused_decode_for(cfg, model),
        input_format=getattr(args, "input_format", "rgb8"), device=device,
    )
    return engine, topo


def _image_paths(folder: str, limit: int | None = None) -> list[str]:
    paths = sorted(p for p in glob.glob(os.path.join(folder, "*"))
                   if p.lower().endswith(_IMAGE_EXTS))
    return paths[:limit] if limit else paths


def _calibration_batches(args, engine):
    """First N source frames, resized to the engine input, chunked into
    engine-sized uint8 batches for int8 calibration."""
    import cv2
    import numpy as np

    h, w = engine.input_hw
    frames = []
    if os.path.isdir(args.source):
        for p in _image_paths(args.source, args.quantize):
            img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            frames.append(cv2.resize(img, (w, h)))
    else:
        src = int(args.source) if args.source.isdigit() else args.source
        cap = cv2.VideoCapture(src)
        while len(frames) < args.quantize:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2RGB), (w, h)))
        cap.release()
    if not frames:
        return []
    arr = np.stack(frames).astype(np.uint8)
    bs = engine.max_batch_size
    return [arr[i:i + bs] for i in range(0, len(arr), bs)]


def run_operator(args, engine, topo) -> dict:
    """Batched image-folder mode (reference: cli.cpp:184-285). Writes each
    annotated image under `saving_prefix/`; returns {"images", "seconds",
    "fps", "paths", "humans"} (the humans of each image, in path order)."""
    import cv2

    from .utils.human import draw_humans

    paths = _image_paths(args.source, args.limit)
    if not paths:
        print(f"no images found under {args.source}")
        return {"images": 0, "seconds": 0.0, "fps": 0.0, "paths": [], "humans": []}
    print(f"engine warmup: {engine.warmup():.1f}s")
    os.makedirs(args.saving_prefix, exist_ok=True)
    t0 = time.perf_counter()
    found = []
    for i in range(0, len(paths), engine.max_batch_size):
        chunk = paths[i:i + engine.max_batch_size]
        images = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in chunk]
        results = engine.inference(images)
        for path, img, humans in zip(chunk, images, results):
            out = draw_humans(img, humans, topo, alpha=args.alpha)
            if args.imshow:
                cv2.imshow("hyperpose-torch", cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
                cv2.waitKey(1)
            dst = os.path.join(args.saving_prefix, os.path.basename(path))
            cv2.imwrite(dst, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
            found.append(humans)
    dt = time.perf_counter() - t0
    n = len(found)
    print(f"operator mode: {n} images in {dt:.2f}s -> {n / dt:.2f} FPS")
    return {"images": n, "seconds": dt, "fps": n / dt, "paths": paths, "humans": found}


def run_stream(args, engine, topo) -> dict:
    """Pipelined video mode (reference: cli.cpp:286-301 stream mode). Writes
    the annotated video to `saving_prefix.mp4`; returns the stream's stats
    (`StreamProcessor.process_video`)."""
    from .runtime.stream import StreamProcessor

    print(f"engine warmup: {engine.warmup():.1f}s")
    sp = StreamProcessor(engine)
    if args.logging:
        sp.add_queue_monitor(1000)
    out_path = f"{args.saving_prefix}.mp4"
    source = int(args.source) if args.source.isdigit() else args.source
    stats = sp.process_video(
        source, out_path, topology=topo, limit=args.limit,
        alpha=args.alpha, imshow=args.imshow, low_latency=args.low_latency,
    )
    print(
        f"stream mode: {stats['frames']} frames in {stats['seconds']:.2f}s "
        f"-> {stats['fps']:.2f} FPS ({stats['total_humans']} humans) "
        f"-> {out_path}"
    )
    return stats


def run(argv=None) -> dict:
    """The CLI on `argv` (default: the command line); returns what the
    runtime returned, with the engine under "engine"."""
    args = parse_args(argv)
    if args.logging:
        logging.basicConfig(level=logging.INFO)
    engine, topo = build_engine(args)
    if args.quantize:
        from . import quant

        batches = _calibration_batches(args, engine)
        if batches:
            t0 = time.perf_counter()
            engine = quant.quantize_engine(engine, batches)
            print(f"int8 calibration on {sum(len(b) for b in batches)} "
                  f"frames: {time.perf_counter() - t0:.1f}s "
                  f"({len(engine.quant_scales)} convs quantized)")
        else:
            print("warning: --quantize given but no calibration frames read")
    if args.runtime == "stream" or not os.path.isdir(args.source):
        result = run_stream(args, engine, topo)
    else:
        result = run_operator(args, engine, topo)
    return {**result, "engine": engine}


def main(argv=None) -> None:
    """The console entry point (`hyperpose-torch`, `python -m
    hyperpose_torch.cli`): `run` without a return value."""
    run(argv)


if __name__ == "__main__":
    main()
