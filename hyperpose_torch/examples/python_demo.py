"""Single-image / folder demo: the counterpart of the repository's
`python_demo.py` (reference: python_demo.py).

    python -m hyperpose_torch.examples.python_demo --image_dir imgs --device cpu
"""
import argparse
import glob
import os

from hyperpose_torch import Config


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="hyperpose-torch demo")
    parser.add_argument("--model_type", type=str, default="LightweightOpenpose",
                        choices=[m.name for m in Config.MODEL])
    parser.add_argument("--model_backbone", type=str, default="Default",
                        choices=[b.name for b in Config.BACKBONE])
    parser.add_argument("--model_name", type=str, default="default_name")
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./demo_output")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    Config.set_model_name(args.model_name)
    Config.set_model_type(Config.MODEL[args.model_type])
    Config.set_model_backbone(Config.BACKBONE[args.model_backbone])
    config = Config.get_config()

    import cv2

    from hyperpose_torch.examples import engine_for
    from hyperpose_torch.utils.human import draw_humans

    weights = args.weights or os.path.join(config.model.model_dir, "newest_model.npz")
    if os.path.exists(weights):
        print(f"loaded weights: {weights}")
    else:
        print(f"WARNING: no weights at {weights}; using seeded random weights")
        weights = None
    engine = engine_for(config, weights, args.device, max_batch_size=4)
    print(f"engine warmup: {engine.warmup():.1f}s")

    os.makedirs(args.output_dir, exist_ok=True)
    paths = sorted(p for p in glob.glob(os.path.join(args.image_dir, "*"))
                   if p.lower().endswith((".jpg", ".jpeg", ".png")))
    for i in range(0, len(paths), 4):
        chunk = paths[i:i + 4]
        images = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in chunk]
        for path, img, humans in zip(chunk, images, engine.inference(images)):
            out = draw_humans(img, humans, engine.topology)
            dst = os.path.join(args.output_dir, os.path.basename(path))
            cv2.imwrite(dst, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
            print(f"{os.path.basename(path)}: {len(humans)} humans -> {dst}")
    print(f"engine throughput: {engine.stats.fps:.1f} fps")


if __name__ == "__main__":
    main()
