"""Analytical FLOPs of a configured model: the counterpart of the JAX
package's `measure_flops.py` (reference: measure_flops.py), with its flags
and one more, `--device` (where the forward runs: cuda, the default, raises
when no GPU is found; cpu; or meta, which counts from the shapes alone).

Prints the floating-point operations of one frame's forward at the
configured input size (`utils/export.measure_flops`: convolutions and
matmuls, a multiply-add counting 2) and the parameter count, which equals
the flax module's `params` leaves.

    python -m hyperpose_torch.tools.measure_flops --model_type Pifpaf --device cpu
"""
from __future__ import annotations

import argparse

from .. import config as Config
from .eval import check_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hyperpose-torch FLOP count")
    p.add_argument("--model_type", type=str, default="LightweightOpenpose",
                   choices=[m.name for m in Config.MODEL])
    p.add_argument("--model_backbone", type=str, default="Default",
                   choices=[b.name for b in Config.BACKBONE])
    p.add_argument("--device", type=str, default="cuda",
                   help="where the forward runs: cuda (the default; raises when no GPU "
                        "is found), cpu, or meta (shapes alone)")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Parse `argv` and count; returns {"flops": of one frame, "params":
    the parameter count, "hw": the input size}."""
    import torch

    from .. import models as Model
    from ..utils.export import measure_flops

    args = parse_args(argv)
    device = check_device(args.device)
    Config.reset()
    Config.set_model_type(Config.MODEL[args.model_type])
    Config.set_model_backbone(Config.BACKBONE[args.model_backbone])
    cfg = Config.get_config(create_dirs=False)
    model = Model.get_model(cfg).to(device).eval()
    hw = (cfg.model.hin, cfg.model.win)
    x = torch.zeros((1, *hw, 3), dtype=model.dtype, device=device)
    stats = measure_flops(model, x)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{args.model_type} ({args.model_backbone}) @ {hw[0]}x{hw[1]}: "
          f"{stats['flops'] / 1e9:.2f} GFLOP/frame, {n_params / 1e6:.2f} M params")
    return {"flops": stats["flops"], "params": n_params, "hw": hw}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
