"""Training entry point of the PyTorch port: the counterpart of the JAX
package's `train.py` (reference: train.py CLI surface), with its flags and
one more, `--device` (where the step runs: cuda, the default, raises when
no GPU is found; or cpu). The checkpoint goes to
`<save_dir>/<model_name>/model_dir/ckpt` and the weights to
`.../model_dir/newest_model.npz`, in the flat flax layout both packages
load.

    python -m hyperpose_torch.tools.train --synthetic \\
        --model_type LightweightOpenpose --model_backbone Vggtiny --n_step 1000
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .. import config as Config
from .eval import check_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="hyperpose-torch training")
    parser.add_argument("--model_type", type=str, default="LightweightOpenpose",
                        choices=[m.name for m in Config.MODEL])
    parser.add_argument("--model_backbone", type=str, default="Default",
                        choices=[b.name for b in Config.BACKBONE])
    parser.add_argument("--model_name", type=str, default="default_name")
    parser.add_argument("--dataset_type", type=str, default="MSCOCO",
                        choices=[d.name for d in Config.DATA])
    parser.add_argument("--dataset_version", type=str, default="2017")
    parser.add_argument("--dataset_path", type=str, default="./data")
    parser.add_argument("--train_type", type=str, default="Single_train",
                        choices=[t.name for t in Config.TRAIN])
    parser.add_argument("--kf_optimizer", "--sync_type", dest="sync_type", type=str,
                        default="Sync_sgd", choices=[s.name for s in Config.SYNC])
    parser.add_argument("--optim_type", type=str, default="Adam",
                        choices=[o.name for o in Config.OPTIM])
    parser.add_argument("--use_official_dataset",
                        type=lambda s: s.lower() not in ("0", "false", "no", ""),
                        default=True)
    parser.add_argument("--useradd_data_path", type=str, default=None,
                        help="dir with images/ + anno.json of user-labeled data mixed "
                             "into training (reference: train.py:54,97-113)")
    parser.add_argument("--domainadapt_data_path", type=str, default=None)
    parser.add_argument("--log_interval", type=int, default=None)
    parser.add_argument("--vis_interval", type=int, default=None)
    parser.add_argument("--save_interval", type=int, default=None)
    parser.add_argument("--n_step", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--lr_init", type=float, default=None)
    parser.add_argument("--lr_decay_every_step", type=int, default=None)
    parser.add_argument("--lr_decay_factor", type=float, default=None)
    parser.add_argument("--grad_clip_norm", type=float, default=None,
                        help="global-norm gradient clip (0 disables)")
    parser.add_argument("--ppn_lambda", type=str, default=None,
                        help="PoseProposal loss-weight overrides as k=v[,k=v...] over "
                             "lmd_{rsp,iou,coor,size,limb} (reference defaults: "
                             "config_ppn.py)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--input_hw", type=str, default=None,
                        help="override model input as HxW (e.g. 240x320); output grid "
                             "scales by the family stride")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on the deterministic synthetic multi-person "
                             "benchmark (generated under --dataset_path when missing; "
                             "see ACCURACY.md)")
    parser.add_argument("--synthetic_seed", type=int, default=0)
    parser.add_argument("--synthetic_train_scenes", type=int, default=None,
                        help="enlarge the synthetic TRAIN split to this many scenes "
                             "(per-scene seeding keeps the val split byte-identical; "
                             "see data/synthetic.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the step runs: cuda (the default; raises when no "
                             "GPU is found) or cpu")
    return parser.parse_args(argv)


def configure(args):
    """Set the config from `args` (generating the synthetic set where asked)
    and return it, as the JAX package's `train.py` does."""
    Config.reset()
    Config.set_model_name(args.model_name)
    Config.set_model_type(Config.MODEL[args.model_type])
    Config.set_model_backbone(Config.BACKBONE[args.model_backbone])
    Config.set_dataset_type(Config.DATA[args.dataset_type])
    Config.set_dataset_version(args.dataset_version)
    if args.input_hw:
        hin, win = (int(v) for v in args.input_hw.lower().split("x"))
        # keep the family's hout/hin ratio (stride): read defaults first
        base = Config.get_config(create_dirs=False)
        stride_h = base.model.hin // base.model.hout
        stride_w = base.model.win // base.model.wout
        Config.set_model_inout(hin=hin, win=win, hout=hin // stride_h, wout=win // stride_w)
    if args.synthetic:
        from ..data.synthetic import ensure_synthetic_dataset

        kw = {}
        if args.synthetic_train_scenes:
            kw["n_train"] = args.synthetic_train_scenes
        args.dataset_path = ensure_synthetic_dataset(args.dataset_path,
                                                     seed=args.synthetic_seed, **kw)
        if args.dataset_type == "MPII":
            # the MPII-format twin lives under <root>/mpii
            args.dataset_path = os.path.join(args.dataset_path, "mpii")
    Config.set_dataset_path(args.dataset_path)
    Config.set_train_type(Config.TRAIN[args.train_type])
    Config.set_kungfu_option(Config.SYNC[args.sync_type])
    Config.set_optim_type(Config.OPTIM[args.optim_type])
    Config.set_official_dataset(args.use_official_dataset)
    Config.set_compute_dtype(args.compute_dtype)
    if args.useradd_data_path:
        image_dir = os.path.join(args.useradd_data_path, "images")
        with open(os.path.join(args.useradd_data_path, "anno.json")) as f:
            anno_json = json.load(f)
        paths, targets = [], []
        for image_path, anno in anno_json["annotations"].items():
            paths.append(os.path.join(image_dir, image_path))
            targets.append({"kpt": anno["keypoints"], "mask": None,
                            "bbx": anno["bbox"], "labeled": 1})
        Config.set_useradd_data(paths, targets, scale_rate=1)
    if args.vis_interval:
        Config.set_vis_interval(args.vis_interval)
    if args.domainadapt_data_path:
        Config.set_domainadapt_dataset(glob.glob(os.path.join(args.domainadapt_data_path, "*")))
    if args.log_interval:
        Config.set_log_interval(args.log_interval)
    if args.save_interval:
        Config.set_save_interval(args.save_interval)
    if args.batch_size:
        Config.set_batch_size(args.batch_size)
    if args.lr_init:
        Config.set_learning_rate(args.lr_init)
    if args.lr_decay_every_step or args.lr_decay_factor:
        Config.set_lr_decay(args.lr_decay_every_step, args.lr_decay_factor)
    if args.grad_clip_norm is not None:
        Config.set_grad_clip_norm(args.grad_clip_norm)
    if args.ppn_lambda:
        valid = {"lmd_rsp", "lmd_iou", "lmd_coor", "lmd_size", "lmd_limb"}
        for item in args.ppn_lambda.split(","):
            k, v = (s.strip() for s in item.split("="))
            if k not in valid:
                raise SystemExit(f"--ppn_lambda: unknown key {k!r}")
            Config._set("model", k, float(v))
    config = Config.get_config()
    if args.n_step:
        config.train.n_step = args.n_step
    return config


def run(argv=None):
    """Parse `argv`, train, and return (trained model, config)."""
    args = parse_args(argv)
    device = check_device(args.device)
    config = configure(args)
    from .. import models as Model
    from ..data.base import get_dataset

    model = Model.get_model(config)
    train = Model.get_train(config)
    return train(model, get_dataset(config), device=device), config


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
