"""Tutorial: the minimum end-to-end prediction program.

Counterpart of `examples/tutorial_minimum.py` (reference:
examples/tutorial_api_minimum_operator.example.cpp — build an engine, run
one image, draw the skeletons).
"""
import argparse

from hyperpose_torch import Config, Model
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.human import draw_humans
from hyperpose_torch.utils.weights import random_flax_weights


def main(argv=None):
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("image")
    ap.add_argument("weights", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. Configure the model family and backbone (reference: Config setters).
    Config.reset()
    Config.set_model_type(Config.MODEL.LightweightOpenpose)
    Config.set_model_backbone(Config.BACKBONE.Vggtiny)
    cfg = Config.get_config(create_dirs=False)

    # 2. Build the model and its weights (the trained npz, or seeded random).
    model = Model.get_model(cfg)
    weights = args.weights or random_flax_weights(model, seed=0)

    # 3. One engine call: normalize, network and decode on the device.
    engine = PoseEngine(model, weights, input_hw=(cfg.model.hin, cfg.model.win),
                        device=args.device)
    img = cv2.cvtColor(cv2.imread(args.image), cv2.COLOR_BGR2RGB)
    humans = engine.inference([img])[0]

    # 4. Draw.
    out = draw_humans(img, humans, Model.get_topology(cfg))
    cv2.imwrite("tutorial_out.png", cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
    print(f"{len(humans)} humans -> tutorial_out.png")


if __name__ == "__main__":
    main()
