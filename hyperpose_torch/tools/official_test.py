"""Test-server submission of the PyTorch port: the counterpart of the JAX
package's `official_test.py` (reference: official_test.py), with its flags
and `--device` (cuda, the default, raises when no GPU is found; or cpu).
Writes `pd_ann.json` (COCO results of the test
split; the val split where a dataset has no test split) under the
config's test directory and prints its path.

    python -m hyperpose_torch.tools.official_test --model_backbone Vggtiny \\
        --weights weights/flagship_tinyvgg.npz --dataset_path ./data
"""
from __future__ import annotations

import argparse

from .. import config as Config
from .eval import check_device, configure, load_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hyperpose-torch test submission")
    p.add_argument("--model_type", type=str, default="LightweightOpenpose",
                   choices=[m.name for m in Config.MODEL])
    p.add_argument("--model_backbone", type=str, default="Default",
                   choices=[b.name for b in Config.BACKBONE])
    p.add_argument("--model_name", type=str, default="default_name")
    p.add_argument("--dataset_type", type=str, default="MSCOCO",
                   choices=[d.name for d in Config.DATA])
    p.add_argument("--dataset_path", type=str, default="./data")
    p.add_argument("--test_num", type=int, default=None)
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the step runs: cuda (the default; raises when "
                        "no GPU is found) or cpu")
    return p.parse_args(argv)


def run(argv=None) -> str:
    """Parse `argv`, write the submission json and return its path."""
    from .. import models as Model
    from ..data.base import get_dataset

    args = parse_args(argv)
    device = check_device(args.device)
    config = configure(args)
    model, _ = load_model(config, args.weights)
    test = Model.get_test(config)
    out = test(model, get_dataset(config), limit=args.test_num, device=device)
    print(f"submission json: {out}")
    return out


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
