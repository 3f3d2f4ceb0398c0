"""The system under test: the PyTorch port, `hyperpose_torch`, built from a
configuration file. This is the one module of the benchmark that imports
the port; the reference imports nothing of it."""
from __future__ import annotations

import torch


def _model_class(name: str):
    from hyperpose_torch.models import openpose

    return getattr(openpose, name)


def serving_model(cfg: dict, weights: dict):
    """(model, weights) of the configuration's served form: the model in its
    compute dtype, and the flax weights remapped for that form (`serve_form`
    "fused_stem": TinyVGG's fused stem; else the class as it trains)."""
    kwargs = {"dtype": getattr(torch, cfg["dtype"])}
    if cfg["program"].get("serve_form") == "fused_stem":
        from hyperpose_torch.models import backbones

        kwargs["backbone"] = backbones.VggTinyFusedStem
        weights = backbones.remap_vggtiny_to_fused(weights)
    return _model_class(cfg["program"]["model"])(**kwargs), weights


def build_engine(cfg: dict, weights: dict, batch: int, device):
    """A `PoseEngine` of the configuration at `batch` on `device`."""
    from hyperpose_torch.runtime.engine import PoseEngine

    model, weights = serving_model(cfg, weights)
    return PoseEngine(model, weights, input_hw=tuple(cfg["input_hw"]),
                      max_batch_size=batch, device=device)


def int8_engine(engine, calibration_u8):
    """The port's own int8 serving path on `engine` (every calibrated conv
    in int8, bf16 activations), calibrated on a uint8 batch: the control."""
    from hyperpose_torch import quant

    return quant.quantize_engine(engine, [calibration_u8])


def stream_processor(engine):
    from hyperpose_torch.runtime.stream import StreamProcessor

    return StreamProcessor(engine)


def build_trainer(cfg: dict, weights: dict, batch: int, device, model_dir: str):
    """The port's `Trainer` of the configuration's training form, its
    parameters set to the flax `weights` and a fresh optimizer."""
    from hyperpose_torch import Model
    from hyperpose_torch import config as Config
    from hyperpose_torch.train.trainer import Trainer, make_optimizer
    from hyperpose_torch.utils.weights import load_flax_weights

    t = cfg["train"]
    Config.reset()
    Config.set_model_name("posebench")
    Config.set_model_type(Config.MODEL[t["model_type"]])
    Config.set_model_backbone(Config.BACKBONE[t["backbone"]])
    Config.set_compute_dtype(cfg["dtype"])
    Config.set_batch_size(int(batch))
    Config.set_learning_rate(float(t["lr"]))
    h, w = cfg["input_hw"]
    Config.set_model_inout(hin=h, win=w, hout=h // 8, wout=w // 8)
    conf = Config.get_config(create_dirs=False)
    Config.reset()
    conf.train.weight_decay_factor = float(t["weight_decay"])
    conf.model.model_dir = model_dir
    trainer = Trainer(conf, Model.get_model(conf), Model.get_topology(conf).limbs, device=device)
    load_flax_weights(trainer.model, weights)
    trainer.optimizer = make_optimizer(conf, trainer.params)
    return trainer


def trainer_state(trainer) -> dict:
    """The trainer's parameters and its Adam's moments ("params", "mu",
    "nu": float32 numpy arrays keyed by flax path) and its update count."""
    from hyperpose_torch.utils.weights import state_dict_to_flax

    names = [n for n, p in trainer.model.named_parameters() if p.requires_grad]

    def flax(tensors) -> dict:
        flat = state_dict_to_flax({n: t.detach().clone() for n, t in zip(names, tensors)})
        return {k: v for k, v in flat.items() if k.startswith("params/")}

    opt = trainer.optimizer
    return {"params": flax(trainer.params), "mu": flax(opt.mu), "nu": flax(opt.nu),
            "count": int(opt.count)}
