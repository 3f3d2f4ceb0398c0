"""Evaluation entry point of the PyTorch port: the counterpart of the JAX
package's `eval.py` (reference: eval.py CLI surface), with its flags and
three more: `--device` (where the step runs: cuda, the default, raises when
no GPU is found; or cpu), `--quantize N` (calibrate on the first N scenes
of the tune split and evaluate in int8) and `--calib_path` (that split).
The network runs in the config's dtype, bfloat16, as in `eval.py`. Prints
the dataset's metrics dict.

    python -m hyperpose_torch.tools.eval --synthetic \\
        --model_type LightweightOpenpose --model_backbone Vggtiny \\
        --weights weights/flagship_tinyvgg.npz --eval_num 100
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os

from .. import config as Config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# 100 held-out train scenes (ids 1601-1700 of the seed-0 synthetic set), the
# calibration split of int8 evaluation.
TUNE_SPLIT = os.path.join(REPO, "data_synth_1600_tune1600_100")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="hyperpose-torch evaluation")
    parser.add_argument("--model_type", type=str,
                        default="LightweightOpenpose",
                        choices=[m.name for m in Config.MODEL])
    parser.add_argument("--model_backbone", type=str, default="Default",
                        choices=[b.name for b in Config.BACKBONE])
    parser.add_argument("--model_name", type=str, default="default_name")
    parser.add_argument("--dataset_type", type=str, default="MSCOCO",
                        choices=[d.name for d in Config.DATA])
    parser.add_argument("--dataset_version", type=str, default="2017")
    parser.add_argument("--dataset_path", type=str, default="./data")
    parser.add_argument("--eval_num", type=int, default=None,
                        help="number of images to evaluate (None = all)")
    parser.add_argument("--multiscale", action="store_true")
    parser.add_argument("--weights", type=str, default=None,
                        help="npz weights path (the JAX package's flat flax "
                             "layout); defaults to <model_dir>/newest_model.npz")
    parser.add_argument("--input_hw", type=str, default=None,
                        help="override model input as HxW (e.g. 240x320); "
                        "output grid scales by the family stride")
    parser.add_argument("--synthetic", action="store_true",
                        help="evaluate on the deterministic synthetic "
                             "multi-person benchmark (generated under "
                             "--dataset_path when missing; see ACCURACY.md)")
    parser.add_argument("--synthetic_seed", type=int, default=0)
    parser.add_argument("--synthetic_train_scenes", type=int, default=None,
                        help="match a dataset generated with this train-split "
                             "size; any existing dir with >= this many train "
                             "scenes is accepted as-is")
    parser.add_argument("--ppn_decoder", type=str, default=None,
                        help="PoseProposal decode-threshold overrides as "
                             "k=v[,k=v...] (e.g. thresh_part_score=0.1,"
                             "min_parts=3)")
    parser.add_argument("--quantize", type=int, default=0, metavar="N",
                        help="calibrate on the first N scenes of --calib_path "
                             "and evaluate with every calibrated conv in int8")
    parser.add_argument("--calib_path", type=str, default=TUNE_SPLIT,
                        help="COCO-layout dataset whose train images calibrate "
                             "--quantize (default: the committed tune split)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the step runs: cuda (the default; raises "
                             "when no GPU is found) or cpu")
    return parser.parse_args(argv)


def parse_ppn_decoder(spec: str) -> dict:
    """Parse k=v[,k=v...] decode-threshold overrides, validating keys against
    PpnDecoderConfig fields and parsing numbers tolerantly (int then float,
    so negative ints stay ints)."""
    from ..ops.ppn_decode import PpnDecoderConfig

    valid = {f.name for f in dataclasses.fields(PpnDecoderConfig)}
    kv = {}
    for item in spec.split(","):
        if item.count("=") != 1:
            raise SystemExit(
                f"--ppn_decoder: bad token {item!r} (expected key=value)")
        k, v = (s.strip() for s in item.split("="))
        if k not in valid:
            raise SystemExit(
                f"--ppn_decoder: unknown key {k!r} "
                f"(valid: {', '.join(sorted(valid))})")
        try:
            kv[k] = int(v)
        except ValueError:
            try:
                kv[k] = float(v)
            except ValueError:
                raise SystemExit(
                    f"--ppn_decoder: non-numeric value {v!r} for {k!r}")
    return kv


def check_device(device: str):
    """`torch.device(device)`; a CUDA device without a GPU raises."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda, but torch finds no CUDA device; pass --device cpu "
            "to run on the CPU")
    return dev


def configure(args):
    """Set the config from `args` (generating the synthetic set where asked)
    and return it."""
    Config.reset()
    Config.set_model_name(args.model_name)
    Config.set_model_type(Config.MODEL[args.model_type])
    Config.set_model_backbone(Config.BACKBONE[args.model_backbone])
    Config.set_dataset_type(Config.DATA[args.dataset_type])
    Config.set_dataset_version(getattr(args, "dataset_version", "2017"))
    if getattr(args, "input_hw", None):
        hin, win = (int(v) for v in args.input_hw.lower().split("x"))
        # keep the family's hout/hin ratio (stride): read defaults first
        base = Config.get_config(create_dirs=False)
        stride_h = base.model.hin // base.model.hout
        stride_w = base.model.win // base.model.wout
        Config.set_model_inout(hin=hin, win=win, hout=hin // stride_h,
                               wout=win // stride_w)
    if getattr(args, "synthetic", False):
        from ..data.synthetic import ensure_synthetic_dataset

        kw = {}
        if args.synthetic_train_scenes:
            kw["n_train"] = args.synthetic_train_scenes
        args.dataset_path = ensure_synthetic_dataset(
            args.dataset_path, seed=args.synthetic_seed, **kw
        )
        if args.dataset_type == "MPII":
            # the MPII-format twin lives under <root>/mpii
            args.dataset_path = os.path.join(args.dataset_path, "mpii")
    Config.set_dataset_path(args.dataset_path)
    if getattr(args, "ppn_decoder", None):
        Config.set_ppn_decoder(**parse_ppn_decoder(args.ppn_decoder))
    return Config.get_config()


def load_model(config, weights: str | None):
    """The configured network with `weights` (default
    <model_dir>/newest_model.npz) loaded, and the flax-layout weights it
    holds; seeded random weights (seed 0) when the file is missing."""
    from .. import models as Model
    from ..utils.weights import load_flax_weights, random_flax_weights, read_flax_weights

    model = Model.get_model(config)
    path = weights or os.path.join(config.model.model_dir, "newest_model.npz")
    if os.path.exists(path):
        flat = read_flax_weights(path)
        print(f"loaded weights from {path}")
    else:
        flat = random_flax_weights(model, seed=0)
        print(f"WARNING: {path} not found, evaluating seeded random weights")
    load_flax_weights(model, flat)
    return model, flat


def calibration_batches(path: str, n: int, input_hw, batch: int) -> list:
    """The first `n` train images of the COCO-layout dataset at `path`,
    read as RGB and resized to `input_hw`, as uint8 [batch, H, W, 3]
    batches (the last one may be shorter)."""
    import cv2
    import numpy as np

    paths = sorted(glob.glob(os.path.join(path, "train*", "*.jpg")))[:n]
    if not paths:
        raise FileNotFoundError(f"no calibration images under {path}/train*/")
    h, w = input_hw
    frames = np.stack([
        cv2.resize(cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB), (w, h)) for p in paths
    ])
    return [frames[i:i + batch] for i in range(0, len(frames), batch)]


def quantize_for_eval(model, weights, batches, device, fused_decode=None):
    """Calibrate `model` on `batches` (uint8, on `device`, through
    `fused_decode` where the family has one) and swap every calibrated conv
    for an int8 conv quantized from the float32 `weights`; returns the model
    and the scale table."""
    import torch

    from .. import quant

    model = model.to(device).eval()
    dtype = getattr(model, "dtype", torch.float32)

    def forward(b):
        x = torch.as_tensor(b).to(device)
        if fused_decode is not None:
            fused_decode(x)
        else:
            model(x.to(dtype) / 255.0)

    scales = quant.calibrate(model, batches, forward)
    return quant.quantize_model(model, scales, weights=weights), scales


def build_evaluator(args, config, device):
    """The model of `args` with its weights (int8 where `--quantize`) in an
    `Evaluator` on `device`."""
    from .. import models as Model
    from ..data.base import get_dataset

    model, flat = load_model(config, args.weights)
    dataset = get_dataset(config)
    if args.quantize:
        batches = calibration_batches(args.calib_path, args.quantize,
                                      (config.model.hin, config.model.win),
                                      config.eval.batch_size)
        model, _ = quantize_for_eval(model, flat, batches, device,
                                     Model._fused_decode_for(config, model))
        print(f"int8: calibrated on {args.quantize} scenes of {args.calib_path}")
    return Model.evaluator(config, model, dataset, device, args.multiscale)


def run(argv=None):
    """Parse `argv`, evaluate, print and return (metrics, evaluator)."""
    args = parse_args(argv)
    device = check_device(args.device)
    config = configure(args)
    config.eval.multiscale = args.multiscale
    ev = build_evaluator(args, config, device)
    metrics = ev.evaluate(limit=args.eval_num, eval_dir=config.eval.vis_dir)
    print(metrics)
    return metrics, ev


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
