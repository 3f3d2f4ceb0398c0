"""Build an inference engine once and serialize it for fast cold starts.

Counterpart of `examples/gen_serialized_engine.py` (reference:
examples/gen_serialized_engine.example.cpp:19-48 — builds a TensorRT engine
once and saves the serialized plan; here the step traced by `torch.export`,
with the hand-written kernels as `hyperpose::` operators, plus the weights).
"""
import argparse

from hyperpose_torch import Config
from hyperpose_torch.examples import engine_for
from hyperpose_torch.runtime.engine import PoseEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="LightweightOpenpose")
    ap.add_argument("--backbone", default="Vggtiny")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--max_batch_size", type=int, default=8)
    ap.add_argument("--out_prefix", default="./engine/tinyvgg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Config.reset()
    Config.set_model_type(Config.MODEL[args.model])
    Config.set_model_backbone(Config.BACKBONE[args.backbone])
    cfg = Config.get_config(create_dirs=False)
    engine = engine_for(cfg, args.weights, args.device,
                        max_batch_size=args.max_batch_size)
    print(f"warmup: {engine.warmup():.1f}s")
    paths = engine.save(args.out_prefix)
    for kind, path in paths.items():
        print(f"{kind}: {path}")
    # Reload without retracing:
    PoseEngine.load_executable(paths["executable"])
    print("reloaded the serialized step")


if __name__ == "__main__":
    main()
