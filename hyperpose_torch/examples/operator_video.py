"""Operator-API example: batched video inference with any decoder.

Counterpart of `examples/operator_video.py` (reference:
examples/operator_api_video_paf.example.cpp — the --post flag selects the
parser family, as in the C++ CLI).
"""
import argparse

import numpy as np

from hyperpose_torch import Config, Model
from hyperpose_torch.examples import POST_TO_MODEL, engine_for
from hyperpose_torch.utils.human import draw_humans


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("--post", choices=sorted(POST_TO_MODEL), default="paf")
    ap.add_argument("--output", default="video_out.mp4")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Config.reset()
    Config.set_model_type(Config.MODEL[POST_TO_MODEL[args.post]])
    cfg = Config.get_config(create_dirs=False)
    engine = engine_for(cfg, None, args.device, max_batch_size=args.batch)
    print(f"warmup: {engine.warmup():.1f}s")

    topo = Model.get_topology(cfg)
    cap = cv2.VideoCapture(args.source)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    writer = None

    def write(batch, results):
        nonlocal writer
        for img, humans in zip(batch, results):
            out = draw_humans(img, humans, topo)
            if writer is None:
                writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                         (out.shape[1], out.shape[0]))
            writer.write(cv2.cvtColor(out, cv2.COLOR_RGB2BGR))

    frames, batch = 0, []
    while True:
        ok, frame = cap.read()
        if not ok or (args.limit and frames >= args.limit):
            break
        batch.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        frames += 1
        if len(batch) == args.batch:
            write(batch, engine.inference(batch))
            batch = []
    if batch:
        pad = batch + [np.zeros_like(batch[0])] * (args.batch - len(batch))
        write(batch, engine.inference(pad)[:len(batch)])
    cap.release()
    if writer is not None:
        writer.release()
    print(f"{frames} frames, {engine.stats.fps:.1f} model fps -> {args.output}")


if __name__ == "__main__":
    main()
