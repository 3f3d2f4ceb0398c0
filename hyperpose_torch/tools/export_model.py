"""Export a configured model for deployment: the counterpart of the JAX
package's `export_model.py` (reference: export_pb.py:66-104 frozen graph,
examples/gen_serialized_engine.example.cpp serialized TensorRT engine), with
its flags and one more, `--device` (where the program is traced and runs:
cuda, the default, raises when no GPU is found; or cpu).

It writes `<output_dir>/<model_name>.npz`, the weights in the flat flax
layout both packages load, and with `--format stablehlo` (the default) the
serialized program `<model_name>.pt2` (`torch.export`, the port's
counterpart of the JAX package's StableHLO): the forward on uint8 images,
or with `--with_decode` the engine's whole step, forward and decoder with
their kernels (`PoseEngine.save`). `--format pb` writes the frozen TensorFlow
graph `frozen_<model_name>.pb`, `tflite` and `tflite_uint8` the flatbuffer
`<model_name>.tflite` (float, or fully uint8-quantized on 8 representative
inputs from `default_rng(0)`), as the JAX script does: the float32 forward of
a float32 copy of the engine's model, captured on `--device` and lowered to
TF ops (`utils/tf_lower.py`). These need TensorFlow, which the GPU machine
lacks: without it the tool raises ImportError before it writes anything.

    python -m hyperpose_torch.tools.export_model --model_backbone Vggtiny \\
        --weights weights/flagship_tinyvgg.npz --with_decode --device cpu
    python -m hyperpose_torch.tools.export_model --model_backbone Vggtiny \\
        --weights weights/flagship_tinyvgg.npz --format pb tflite --device cpu
"""
from __future__ import annotations

import argparse
import copy
import os

from .. import config as Config
from .eval import check_device

TF_FORMATS = ("pb", "tflite", "tflite_uint8")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="hyperpose-torch model export")
    p.add_argument("--model_type", type=str, default="LightweightOpenpose",
                   choices=[m.name for m in Config.MODEL])
    p.add_argument("--model_backbone", type=str, default="Default",
                   choices=[b.name for b in Config.BACKBONE])
    p.add_argument("--model_name", type=str, default="default_name")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="./export")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--with_decode", action="store_true",
                   help="serialize forward+decode instead of forward only")
    p.add_argument("--format", nargs="*", default=["stablehlo"],
                   choices=["stablehlo", "pb", "tflite", "tflite_uint8"],
                   help="extra interchange artifacts (reference: "
                   "export_pb.py / export_tflite.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the program is traced and runs: cuda (the default; "
                        "raises when no GPU is found) or cpu")
    return p.parse_args(argv)


def initial_weights(model):
    """Flat flax-layout float32 weights of `model` as the trainer draws them
    (`train/init.py`, seed 0), on a float32 copy: the JAX script's
    `model.init(PRNGKey(0))` when no checkpoint is found."""
    import torch

    from ..train.init import flax_init_on_cpu_
    from ..train.trainer import as_master
    from ..utils.weights import state_dict_to_flax

    twin = as_master(copy.deepcopy(model).cpu())
    flax_init_on_cpu_(twin, torch.Generator().manual_seed(0))
    return state_dict_to_flax(twin.state_dict())


def build_engine(cfg, weights: str | None, batch_size: int, device):
    """(engine, weights path it loaded or None): the configured model on
    `device` with the checkpoint `weights` (default
    `<model_dir>/newest_model.npz`) when that file exists, else
    `initial_weights`; its family's decode and topology."""
    from .. import models as Model
    from ..runtime.engine import PoseEngine
    from ..utils.weights import read_flax_weights

    model = Model.get_model(cfg)
    path = weights or os.path.join(cfg.model.model_dir, "newest_model.npz")
    loaded = path if os.path.exists(path) else None
    variables = read_flax_weights(path) if loaded else initial_weights(model)
    engine = PoseEngine(model, variables, input_hw=(cfg.model.hin, cfg.model.win),
                        max_batch_size=batch_size, topology=Model.get_topology(cfg),
                        fused_decode=Model._fused_decode_for(cfg, model), device=device)
    return engine, loaded


def _forward_module(engine):
    """The engine's forward alone as a module (its weights the program's),
    uint8 images -> its output maps, the lists of per-stage maps left out as
    the JAX script leaves them."""
    from torch import nn

    class Forward(nn.Module):
        def __init__(self):
            super().__init__()
            self.model = engine.model

        def forward(self, images_u8):
            out = self.model(images_u8.to(engine.dtype) / 255.0)
            return {k: v for k, v in out.items() if not isinstance(v, (list, tuple))}

    return Forward()


def run(argv=None) -> dict:
    """Parse `argv` and export; returns {"weights": npz path, "executable":
    pt2 path or None, "pb": path or None, "tflite": path or None, "flops":
    per batch, "loaded": checkpoint or None, "engine"}."""
    import torch

    from ..runtime.engine import _EngineStep
    from ..utils.export import (
        export_npz, export_serialized, import_tensorflow, measure_flops,
    )

    args = parse_args(argv)
    if set(TF_FORMATS) & set(args.format):
        import_tensorflow()     # raises before anything is written
    device = check_device(args.device)
    Config.reset()
    Config.set_model_name(args.model_name)
    Config.set_model_type(Config.MODEL[args.model_type])
    Config.set_model_backbone(Config.BACKBONE[args.model_backbone])
    cfg = Config.get_config(create_dirs=False)
    engine, loaded = build_engine(cfg, args.weights, args.batch_size, device)
    if loaded:
        print(f"loaded {loaded}")

    os.makedirs(args.output_dir, exist_ok=True)
    prefix = os.path.join(args.output_dir, args.model_name)
    npz = export_npz(engine.variables, prefix + ".npz")
    print(f"weights -> {npz}")
    fn = _EngineStep(engine) if args.with_decode else _forward_module(engine)
    example = torch.zeros(engine.input_batch_shape(args.batch_size), dtype=torch.uint8,
                          device=device)
    exe = None
    if "stablehlo" in args.format:
        exe = export_serialized(fn, (example,), prefix + ".pt2")
        print(f"serialized executable -> {exe}")
    pb, tfl = export_tf(args, engine)
    stats = measure_flops(fn, example)
    print(f"analytical cost: {stats['flops'] / 1e9:.2f} GFLOP / batch "
          "(convolutions and matmuls; bytes accessed are not counted)")
    return {"weights": npz, "executable": exe, "pb": pb, "tflite": tfl,
            "flops": stats["flops"], "loaded": loaded, "engine": engine}


def export_tf(args, engine) -> tuple:
    """The `--format pb / tflite / tflite_uint8` artifacts of the engine's
    model at (batch_size, H, W, 3): a float32 copy of it holding the
    engine's float32 weights (not their bf16 rounding). Returns (pb path or
    None, tflite path or None)."""
    import numpy as np

    from ..utils.export import export_pb, export_tflite
    from ..utils.tf_lower import float32_copy
    from ..utils.weights import load_flax_weights

    formats = set(args.format)
    if not set(TF_FORMATS) & formats:
        return None, None
    model = float32_copy(engine.model)
    if model is not engine.model and engine.variables is not None:
        load_flax_weights(model, engine.variables)
    shape = (args.batch_size, *engine.input_hw, 3)
    pb = tfl = None
    if "pb" in formats:
        pb = export_pb(model, shape, os.path.join(args.output_dir,
                                                  f"frozen_{args.model_name}.pb"))
        print(f"frozen graph -> {pb}")
    if {"tflite", "tflite_uint8"} & formats:
        rep = None
        if "tflite_uint8" in formats:
            rng = np.random.default_rng(0)
            rep = [rng.random(shape, np.float32) for _ in range(8)]
        tfl = export_tflite(model, np.zeros(shape, np.float32),
                            os.path.join(args.output_dir, f"{args.model_name}.tflite"),
                            representative_inputs=rep,
                            quantize_uint8="tflite_uint8" in formats)
        print(f"tflite -> {tfl}")
    return pb, tfl


def main(argv=None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
