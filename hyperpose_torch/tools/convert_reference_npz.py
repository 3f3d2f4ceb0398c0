"""Convert a reference TensorLayer npz_dict checkpoint to the package's weight
format: the counterpart of the JAX package's `scripts/convert_reference_npz.py`,
with its flags and one more, `--device` (where the model is built: cuda, the
default, raises when no GPU is found; or cpu).

    python -m hyperpose_torch.tools.convert_reference_npz --model LightweightOpenpose \\
        --backbone Vggtiny --src newest_model.npz --dst converted.npz --device cpu
    python -m hyperpose_torch.tools.convert_reference_npz ... --report   # alignment only

(reference: Model/train.py:319 save_weights(format='npz_dict') produces the
source files; the model-zoo .npz checkpoints in the reference README use
this format.) The output is the flat flax npz both packages load, in
float32. A family with a structural order (`utils/tl_orders.py`
ORDER_KEYS) is imported layer by layer; any other by the kind-stream
matcher, strict unless `--lenient`, the weights it leaves unassigned those
the trainer draws (seed 0).
"""
from __future__ import annotations

import argparse
import json

from .eval import check_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="LightweightOpenpose")
    ap.add_argument("--backbone", default="Default")
    ap.add_argument("--src", required=True, help="reference npz_dict file")
    ap.add_argument("--dst", default=None, help="output weights file")
    ap.add_argument("--report", action="store_true",
                    help="print the alignment report and exit")
    ap.add_argument("--lenient", action="store_true",
                    help="import what aligns, skip the rest")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the model is built: cuda (the default; raises when no "
                         "GPU is found) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Parse `argv`, print the alignment report and, unless `--report`,
    write the converted weights; returns {"report", "dst" (None with
    `--report`)}."""
    import torch

    from .. import Config, Model
    from ..train.checkpoint import save_weights_npz
    from ..train.init import flax_init_on_cpu_
    from ..train.trainer import as_master
    from ..utils.tl_orders import ORDER_KEYS
    from ..utils.weights_import import compare_report, import_npz_dict, import_tl_checkpoint

    args = parse_args(argv)
    device = check_device(args.device)
    Config.reset()
    Config.set_model_type(Config.MODEL[args.model])
    Config.set_model_backbone(Config.BACKBONE[args.backbone])
    cfg = Config.get_config(create_dirs=False)
    # float32 weights, as flax keeps its parameters whatever the compute dtype
    model = as_master(Model.get_model(cfg))
    flax_init_on_cpu_(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    report = compare_report(model, args.src)
    print(json.dumps(report, indent=2))
    if args.report:
        return {"report": report, "dst": None}
    order_key = ORDER_KEYS.get(args.model)
    if order_key is not None:
        # exact structural import (layer-sequence + bias folding)
        import_tl_checkpoint(model, args.src, order_key)
    else:
        import_npz_dict(model, args.src, strict=not args.lenient)
    dst = args.dst or args.src.replace(".npz", "_converted.npz")
    save_weights_npz(model, dst)
    print(f"wrote {dst}")
    return {"report": report, "dst": dst}


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
