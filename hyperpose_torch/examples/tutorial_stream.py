"""Tutorial: the minimum stream-API program.

Counterpart of `examples/tutorial_stream.py` (reference:
examples/stream_api_video_{paf,pose_proposal}.example.cpp — the five-line
stream setup; --post selects the parser family).

Usage:  python -m hyperpose_torch.examples.tutorial_stream in.mp4 out.mp4 --post ppn
"""
import argparse

from hyperpose_torch import Config, Model
from hyperpose_torch.examples import POST_TO_MODEL
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.runtime.stream import StreamProcessor
from hyperpose_torch.utils.weights import random_flax_weights


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("output", nargs="?", default="tutorial_stream_out.mp4")
    ap.add_argument("--post", choices=sorted(POST_TO_MODEL), default="paf")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. configure the model family
    Config.reset()
    Config.set_model_type(Config.MODEL[POST_TO_MODEL[args.post]])
    cfg = Config.get_config(create_dirs=False)

    # 2. build the model and its weights (an npz, or seeded random)
    model = Model.get_model(cfg)
    weights = args.weights or random_flax_weights(model, seed=0)

    # 3. the engine: normalize, network and the family's decode on the device
    engine = PoseEngine(
        model, weights, input_hw=(cfg.model.hin, cfg.model.win),
        fused_decode=Model._fused_decode_for(cfg, model), device=args.device,
    )
    engine.warmup()

    # 4. pipelined stream: reader -> preprocess pool -> device -> writer
    stream = StreamProcessor(engine)
    print(stream.process_video(args.source, args.output, topology=Model.get_topology(cfg)))


if __name__ == "__main__":
    main()
