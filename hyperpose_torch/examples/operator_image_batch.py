"""Operator-API example: batched image inference for any parser family.

Counterpart of `examples/operator_image_batch.py` (reference:
examples/operator_api_batched_images_{paf,pose_proposal,pifpaf}.example.cpp
— one program per parser there; --post selects the family here).
"""
import argparse
import glob

from hyperpose_torch import Config, Model
from hyperpose_torch.examples import POST_TO_MODEL, engine_for
from hyperpose_torch.utils.human import draw_humans


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("image_dir", nargs="?", default="./images")
    ap.add_argument("--post", choices=sorted(POST_TO_MODEL), default="paf")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Config.reset()
    Config.set_model_type(Config.MODEL[POST_TO_MODEL[args.post]])
    cfg = Config.get_config(create_dirs=False)
    engine = engine_for(cfg, args.weights, args.device)
    print(f"warmup: {engine.warmup():.1f}s")

    topo = Model.get_topology(cfg)
    paths = sorted(glob.glob(f"{args.image_dir}/*.jpg"))[:engine.max_batch_size]
    images = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB) for p in paths]
    for path, img, humans in zip(paths, images, engine.inference(images)):
        out = draw_humans(img, humans, topo)
        dst = path.replace(".jpg", "_pose.png")
        cv2.imwrite(dst, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        print(f"{path}: {len(humans)} humans -> {dst}")
    print(f"throughput: {engine.stats.fps:.1f} fps")


if __name__ == "__main__":
    main()
