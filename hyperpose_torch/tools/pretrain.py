"""Backbone ImageNet pretraining entry point of the PyTorch port: the
counterpart of the JAX package's `pretrain.py` (reference: pretrain.py),
with its flags and one more: `--device` (where the steps run: cuda, the
default, raises when no GPU is found; or cpu). The steps compute in float32,
as the JAX loop's do, with TF32 off. The
checkpoint goes to `<pretrain_model_dir>/ckpt` and the weights to
`<pretrain_model_dir>/newest_<Backbone>.npz`, which `Trainer.init_state`
grafts into a family model's backbone.

    python -m hyperpose_torch.tools.pretrain --synthetic --n_step 1000
"""
from __future__ import annotations

import argparse

from .. import config as Config
from .eval import check_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hyperpose-torch backbone pretraining")
    p.add_argument("--model_backbone", type=str, default="Vggtiny",
                   choices=[b.name for b in Config.BACKBONE if b.name != "Default"])
    p.add_argument("--pretrain_dataset_path", type=str, default="./data/imagenet")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n_step", type=int, default=None)
    p.add_argument("--lr_init", type=float, default=None)
    p.add_argument("--lr_decay_step", type=int, default=None)
    p.add_argument("--val_interval", type=int, default=None)
    p.add_argument("--log_interval", type=int, default=None)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="pretrain on the deterministic synthetic shape/color "
                        "classification twin (generated under "
                        "--pretrain_dataset_path when missing)")
    p.add_argument("--synthetic_seed", type=int, default=0)
    p.add_argument("--image_size", type=int, default=None,
                   help="train/val crop size (default: 96 with --synthetic, "
                        "else 224 like the reference)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the steps run: cuda (the default; raises when no "
                        "GPU is found) or cpu")
    return p.parse_args(argv)


def run(argv=None):
    """Parse `argv`, pretrain, print the JAX entry point's summary lines and
    return (model, history, config)."""
    args = parse_args(argv)
    device = check_device(args.device)
    image_size = args.image_size or (96 if args.synthetic else 224)
    if args.synthetic:
        from ..data.synthetic import ensure_synthetic_imagenet

        args.pretrain_dataset_path = ensure_synthetic_imagenet(
            args.pretrain_dataset_path
            if args.pretrain_dataset_path != "./data/imagenet"
            else "./data_synth_imagenet",
            seed=args.synthetic_seed,
        )
    Config.reset()
    Config.set_pretrain(True)
    Config.set_pretrain_dataset_path(args.pretrain_dataset_path)
    for k in ("batch_size", "lr_init", "lr_decay_step", "val_interval",
              "log_interval", "save_interval"):
        v = getattr(args, k)
        if v is not None:
            Config._set("pretrain", k, v)
    config = Config.get_config()

    from ..models.backbones import BACKBONES
    from ..train.pretrain import load_imagenet_splits, single_pretrain

    train_ds, val_ds = load_imagenet_splits(config.pretrain.pretrain_dataset_path,
                                            image_size=image_size)
    model, history = single_pretrain(
        BACKBONES[args.model_backbone], config, dataset=train_ds, val_dataset=val_ds,
        n_step=args.n_step, device=device)
    if history["log"]:
        first, last = history["log"][0], history["log"][-1]
        print(f"pretrain: loss {first['loss']:.3f} -> {last['loss']:.3f}, "
              f"top1 {first['top1']:.3f} -> {last['top1']:.3f}")
    if history["val"]:
        print(f"final val: {history['val'][-1]}")
    print(f"lr events: {history['lr_events']}")
    return model, history, config


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
