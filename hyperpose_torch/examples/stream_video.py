"""Stream-API example: pipelined video inference for any parser family.

Counterpart of `examples/stream_video.py` (reference:
examples/stream_api_video_{paf,pose_proposal}.example.cpp — --post selects
the family).
"""
import argparse

from hyperpose_torch import Config, Model
from hyperpose_torch.examples import POST_TO_MODEL, engine_for
from hyperpose_torch.runtime.stream import StreamProcessor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("output", nargs="?", default="stream_out.mp4")
    ap.add_argument("--post", choices=sorted(POST_TO_MODEL), default="paf")
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--max_batch_size", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Config.reset()
    Config.set_model_type(Config.MODEL[POST_TO_MODEL[args.post]])
    if args.backbone:
        Config.set_model_backbone(Config.BACKBONE[args.backbone])
    cfg = Config.get_config(create_dirs=False)
    engine = engine_for(cfg, args.weights, args.device,
                        max_batch_size=args.max_batch_size)
    print(f"warmup: {engine.warmup():.1f}s")

    stream = StreamProcessor(engine)
    stream.add_queue_monitor(1000)
    print(stream.process_video(args.source, args.output, topology=Model.get_topology(cfg)))


if __name__ == "__main__":
    main()
