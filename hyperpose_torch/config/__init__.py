"""Typed configuration system of the PyTorch port.

A copy of `hyperpose_tpu/config/__init__.py` with the same names and
behaviour, so a script written against either package configures both. It
mirrors the reference's Config facade — the same enums, knobs, defaults and
`set_*` / `get_config()` surface (reference: hyperpose/Config/__init__.py:44-546,
Config/define.py:1-42, Config/config_{opps,lopps,mbtopps,ppn,pifpaf,pretrain}.py)
— but built on frozen-by-convention dataclasses instead of module-global
edicts, so configs are explicit values that can also be constructed directly.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from enum import Enum
from typing import Any


class BACKBONE(Enum):
    Default = 0
    Mobilenetv1 = 1
    Mobilenetv2 = 2
    MobilenetDilated = 3
    MobilenetThin = 4
    MobilenetSmall = 5
    Vggtiny = 6
    Vgg19 = 7
    Vgg16 = 8
    Resnet18 = 9
    Resnet50 = 10
    # Extension of the JAX package: TinyVGG with a space-to-depth stem
    # (models/backbones.py VggTinyS2D); no reference counterpart.
    VggtinyS2D = 11


class MODEL(Enum):
    Openpose = 0
    LightweightOpenpose = 1
    PoseProposal = 2
    MobilenetThinOpenpose = 3
    Pifpaf = 4


class DATA(Enum):
    MSCOCO = 0
    MPII = 1
    USERDEF = 2
    MULTIPLE = 3


class TRAIN(Enum):
    Single_train = 0
    Parallel_train = 1


class SYNC(Enum):
    """Distributed gradient-exchange modes, the JAX package's equivalents of
    the reference's KungFu options (reference: Config/define.py:33-36):
    Sync_sgd -> gradient all-reduce; Sync_avg -> weight averaging;
    Pair_avg -> pairwise gossip averaging. The port runs each across the
    ranks of a `torch.distributed` group (`parallel/`)."""

    Sync_sgd = 0
    Sync_avg = 1
    Pair_avg = 2


# Backwards-compatible alias matching the reference enum name.
KUNGFU = SYNC


class OPTIM(Enum):
    Adam = 0
    RMSprop = 1
    SGD = 2


@dataclasses.dataclass
class ModelConfig:
    model_type: MODEL = MODEL.LightweightOpenpose
    model_name: str = "default_name"
    model_backbone: BACKBONE = BACKBONE.Default
    n_pos: int = 19
    num_channels: int = 128
    hin: int = 368
    win: int = 432
    hout: int = 46
    wout: int = 54
    data_format: str = "channels_last"  # the models take NHWC images
    model_dir: str = ""
    # PoseProposal-specific knobs (reference: config_ppn.py)
    K_size: int = 18
    L_size: int = 17
    hnei: int = 9
    wnei: int = 9
    lmd_rsp: float = 0.25
    lmd_iou: float = 1.0
    lmd_coor: float = 5.0
    lmd_size: float = 5.0
    lmd_limb: float = 0.5
    # PoseProposal decode-threshold overrides: dict of PpnDecoderConfig
    # field overrides ({thresh_part_score, thresh_edge_score,
    # thresh_nms_iou, min_parts, ...}). None keeps the reference parser's
    # constants (reference: src/pose_proposal.cpp:24-31 parser defaults).
    # A net trained with MSE response losses is under-confident relative
    # to painted targets, so trained deployments tune this on held-out
    # data (scripts/tune_ppn_decode.py).
    ppn_decoder: Any = None
    # Custom component hooks (reference: Config/__init__.py:512-535)
    # model_arch: user-supplied callable (config) -> nn.Module replacing
    # the built-in architectures (reference: Config/__init__.py:176-203
    # set_model_arch; consumed at Model/__init__.py:44-46).
    model_arch: Any = None
    custom_parts: Any = None
    custom_limbs: Any = None
    custom_augmentor: Any = None
    custom_preprocessor: Any = None
    custom_postprocessor: Any = None
    custom_visualizer: Any = None
    # Compute dtype for the conv path ("bfloat16" for serving, "float32"
    # for parity with the reference).
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 8
    save_interval: int = 5000
    n_step: int = 1000000
    lr_init: float = 1e-4
    lr_decay_every_step: int = 136120
    lr_decay_factor: float = 0.666
    lr_decay_steps: tuple[int, ...] = ()
    lr_decay_duration: int = 0
    weight_decay_factor: float = 2e-4
    train_type: TRAIN = TRAIN.Single_train
    optim_type: OPTIM = OPTIM.Adam
    sync_type: SYNC = SYNC.Sync_sgd
    vis_interval: int = 1000
    log_interval: int = 100
    vis_dir: str = ""
    # Devices per data-parallel axis; 0 = all available.
    n_devices: int = 0
    spatial_parallel: int = 1
    # Accumulate gradients over N micro-batches before each optimizer
    # update (effective batch = batch_size * grad_accum_steps). An
    # alternative to adding data-parallel workers when HBM bounds the
    # per-step batch; no reference analog.
    grad_accum_steps: int = 1
    # global-norm gradient clip (0/None disables); stabilizes the 6-stage
    # staged-sum loss at bf16 + aggressive lrs
    grad_clip_norm: float = 0.0
    # Weight of the adversarial domain-adaptation generator loss
    # (reference: Model/train.py:230-262 dmadapt g-loss term).
    lambda_adapt: float = 1.0


@dataclasses.dataclass
class EvalConfig:
    batch_size: int = 8
    vis_dir: str = ""
    multiscale: bool = False


@dataclasses.dataclass
class TestConfig:
    vis_dir: str = ""


@dataclasses.dataclass
class DataConfig:
    dataset_type: DATA = DATA.MSCOCO
    dataset_version: str = "2017"
    dataset_path: str = "./data"
    dataset_filter: Any = None
    vis_dir: str = ""
    official_flag: bool = True
    userdef_dataset: Any = None
    useradd_flag: bool = False
    useradd_scale_rate: int = 1
    useradd_train_img_paths: Any = None
    useradd_train_targets: Any = None
    domainadapt_flag: bool = False
    domainadapt_scale_rate: int = 1
    domainadapt_train_img_paths: Any = None


@dataclasses.dataclass
class LogConfig:
    log_interval: int = 100
    log_path: str = ""


@dataclasses.dataclass
class PretrainConfig:
    enable: bool = False
    lr_init: float = 5e-4
    batch_size: int = 32
    total_step: int = 370_000_000
    log_interval: int = 100
    val_interval: int = 5000
    save_interval: int = 5000
    weight_decay_factor: float = 1e-5
    pretrain_dataset_path: str = "./data/imagenet"
    pretrain_model_dir: str = "./save_dir/pretrain_backbone"
    val_num: int = 20000
    lr_decay_step: int = 170000


@dataclasses.dataclass
class Config:
    model: ModelConfig
    train: TrainConfig
    eval: EvalConfig
    test: TestConfig
    data: DataConfig
    log: LogConfig
    pretrain: PretrainConfig


def _defaults_for(model_type: MODEL) -> Config:
    """Per-model default knobs (reference: Config/config_*.py)."""
    m = ModelConfig(model_type=model_type)
    t = TrainConfig()
    e = EvalConfig()
    if model_type == MODEL.Openpose:  # config_opps.py
        t = TrainConfig(batch_size=4, save_interval=2000,
                        weight_decay_factor=1e-4)
        e = EvalConfig(batch_size=22)
    elif model_type in (MODEL.LightweightOpenpose,
                        MODEL.MobilenetThinOpenpose):  # config_lopps/mbtopps
        t = TrainConfig(batch_size=8, save_interval=5000,
                        weight_decay_factor=2e-4)
        e = EvalConfig(batch_size=8)
    elif model_type == MODEL.PoseProposal:  # config_ppn.py
        m = ModelConfig(
            model_type=model_type, n_pos=18, hin=384, win=384,
            hout=12, wout=12,
        )
        t = TrainConfig(batch_size=22, save_interval=5000, n_step=1040000,
                        lr_decay_factor=0.9, weight_decay_factor=5e-4)
        e = EvalConfig(batch_size=22)
    elif model_type == MODEL.Pifpaf:  # config_pifpaf.py
        m = ModelConfig(model_type=model_type, n_pos=17)
        t = TrainConfig(batch_size=4, save_interval=2000,
                        lr_decay_factor=0.2,
                        lr_decay_steps=(777920, 848640),
                        lr_decay_duration=35360,
                        weight_decay_factor=1e-5)
        e = EvalConfig(batch_size=4)
    return Config(
        model=m, train=t, eval=e, test=TestConfig(), data=DataConfig(),
        log=LogConfig(), pretrain=PretrainConfig(),
    )


# ---------------------------------------------------------------------------
# Imperative facade (same call pattern as the reference's Config module).
# ---------------------------------------------------------------------------

_overrides: dict[str, dict[str, Any]] = {
    "model": {}, "train": {}, "eval": {}, "test": {}, "data": {},
    "log": {}, "pretrain": {},
}


def _set(section: str, key: str, value: Any) -> None:
    _overrides[section][key] = value


def reset() -> None:
    for section in _overrides.values():
        section.clear()


def set_model_name(name: str) -> None:
    _set("model", "model_name", name)


def set_model_type(model_type: MODEL) -> None:
    _set("model", "model_type", model_type)


def set_model_backbone(backbone: BACKBONE) -> None:
    _set("model", "model_backbone", backbone)


def set_model_inout(hin=None, win=None, hout=None, wout=None) -> None:
    for k, v in dict(hin=hin, win=win, hout=hout, wout=wout).items():
        if v is not None:
            _set("model", k, v)


def set_data_format(data_format: str) -> None:
    if data_format != "channels_last":
        raise ValueError(
            "the models take channels_last (NHWC) images only; "
            "the port keeps the JAX package's layout"
        )


def set_compute_dtype(dtype: str) -> None:
    _set("model", "compute_dtype", dtype)


def set_train_type(train_type: TRAIN) -> None:
    _set("train", "train_type", train_type)


def set_optim_type(optim_type: OPTIM) -> None:
    _set("train", "optim_type", optim_type)


def set_kungfu_option(option: SYNC) -> None:
    """Kept under the reference's name; selects the gradient-sync mode."""
    _set("train", "sync_type", option)


set_sync_option = set_kungfu_option


def set_batch_size(batch_size: int) -> None:
    _set("train", "batch_size", batch_size)


def set_learning_rate(lr: float) -> None:
    _set("train", "lr_init", lr)


def set_lr_decay(every_step: int | None = None,
                 factor: float | None = None) -> None:
    """Stepwise lr decay knobs (reference: config Train.lr_decay_every_step
    / lr_decay_factor, mutated via the edict in Config.config_ppn.py etc.;
    the reference defaults target million-step runs — short runs want
    explicit boundaries)."""
    if every_step is not None:
        _set("train", "lr_decay_every_step", every_step)
        # explicit every-N decay overrides any per-model boundary schedule
        # (config_pifpaf.py sets million-step boundaries that would
        # otherwise silently shadow this knob)
        _set("train", "lr_decay_steps", ())
    if factor is not None:
        _set("train", "lr_decay_factor", factor)


def set_ppn_decoder(**overrides) -> None:
    """Override PoseProposal decode thresholds (PpnDecoderConfig fields:
    thresh_part_score, thresh_edge_score, thresh_nms_iou, min_parts, ...).
    The defaults mirror the reference parser's constants
    (src/pose_proposal.cpp:24-31); trained models pick their operating
    point with scripts/tune_ppn_decode.py."""
    _set("model", "ppn_decoder", overrides or None)


def set_train_devices(n_devices: int, spatial_parallel: int = 1) -> None:
    _set("train", "n_devices", n_devices)
    _set("train", "spatial_parallel", spatial_parallel)


def set_dataset_type(dataset_type: DATA) -> None:
    _set("data", "dataset_type", dataset_type)


def set_dataset_version(version: str) -> None:
    _set("data", "dataset_version", version)


def set_dataset_path(path: str) -> None:
    _set("data", "dataset_path", path)


def set_dataset_filter(f) -> None:
    _set("data", "dataset_filter", f)


def set_official_dataset(flag: bool) -> None:
    _set("data", "official_flag", flag)


def set_userdef_dataset(dataset) -> None:
    _set("data", "userdef_dataset", dataset)
    _set("data", "dataset_type", DATA.USERDEF)


def set_useradd_data(img_paths, targets, scale_rate: int = 1) -> None:
    _set("data", "useradd_flag", True)
    _set("data", "useradd_train_img_paths", img_paths)
    _set("data", "useradd_train_targets", targets)
    _set("data", "useradd_scale_rate", scale_rate)


def set_domainadapt_dataset(train_img_paths, scale_rate: int = 1) -> None:
    _set("data", "domainadapt_flag", True)
    _set("data", "domainadapt_train_img_paths", train_img_paths)
    _set("data", "domainadapt_scale_rate", scale_rate)


def set_model_arch(model_arch) -> None:
    """Replace the built-in architecture with a user-defined one.

    `model_arch` is either an `nn.Module` instance or a callable
    `(config) -> module`; the module must take and return what the built-in
    family it replaces does
    (reference: Config/__init__.py:176-203)."""
    _set("model", "model_arch", model_arch)


def set_multiple_dataset(multiple_dataset_configs) -> None:
    """Train over a concatenation of datasets
    (reference: Config/__init__.py:425-427)."""
    _set("data", "dataset_type", DATA.MULTIPLE)
    _set("data", "userdef_dataset", list(multiple_dataset_configs))


def set_vis_interval(interval: int) -> None:
    """(reference: Config/__init__.py:508-511)."""
    _set("train", "vis_interval", interval)


def set_grad_accum_steps(steps: int) -> None:
    """Gradient accumulation: optimizer updates apply every `steps`
    micro-batches (a large-effective-batch knob of the JAX package; no reference
    analog)."""
    _set("train", "grad_accum_steps", int(steps))


def set_grad_clip_norm(norm: float) -> None:
    """Global-norm gradient clipping (0 disables)."""
    _set("train", "grad_clip_norm", float(norm))


def set_custom_parts(parts) -> None:
    _set("model", "custom_parts", parts)


def set_custom_limbs(limbs) -> None:
    _set("model", "custom_limbs", limbs)


def set_custom_augmentor(augmentor) -> None:
    """(reference: Config/__init__.py:522-524)."""
    _set("model", "custom_augmentor", augmentor)


def set_custom_preprocessor(preprocessor) -> None:
    """Replaces the on-device target generator; called as
    preprocessor(kpts, valid, ...) inside the training step
    (reference: Config/__init__.py:526-528)."""
    _set("model", "custom_preprocessor", preprocessor)


def set_custom_postprocessor(postprocessor) -> None:
    """Replaces the batched decoder (reference: Config/__init__.py:530-532)."""
    _set("model", "custom_postprocessor", postprocessor)


def set_custom_visualizer(visualizer) -> None:
    """(reference: Config/__init__.py:534-536)."""
    _set("model", "custom_visualizer", visualizer)


def set_log_interval(interval: int) -> None:
    _set("log", "log_interval", interval)


def set_save_interval(interval: int) -> None:
    _set("train", "save_interval", interval)


def set_pretrain(enable: bool) -> None:
    _set("pretrain", "enable", enable)


def set_pretrain_dataset_path(path: str) -> None:
    _set("pretrain", "pretrain_dataset_path", path)


_LOGGERS_CONFIGURED = False


def get_config(create_dirs: bool = True) -> Config:
    """Merge per-model defaults with accumulated set_* overrides, create
    save directories and loggers (reference: Config/__init__.py:44-172)."""
    global _LOGGERS_CONFIGURED
    model_type = _overrides["model"].get(
        "model_type", MODEL.LightweightOpenpose
    )
    cfg = _defaults_for(model_type)
    for section, values in _overrides.items():
        target = getattr(cfg, section)
        for k, v in values.items():
            if not hasattr(target, k):
                raise AttributeError(f"unknown config key {section}.{k}")
            setattr(target, k, v)

    # MPII openpose topologies carry 15 parts + background
    # (reference: openpose/define.py MpiiPart; Model/__init__.py dataset
    # dispatch).
    if (
        cfg.data.dataset_type == DATA.MPII
        and cfg.model.model_type in (
            MODEL.Openpose, MODEL.LightweightOpenpose,
            MODEL.MobilenetThinOpenpose,
        )
        and "n_pos" not in _overrides["model"]
    ):
        cfg.model.n_pos = 16
    # PoseProposal on MPII: 16 parts incl. Instance, 15 limbs
    # (reference: pose_proposal/define.py:82-101 MpiiPart/MpiiLimb).
    if (
        cfg.data.dataset_type == DATA.MPII
        and cfg.model.model_type == MODEL.PoseProposal
        and "n_pos" not in _overrides["model"]
    ):
        cfg.model.n_pos = 16
        if "K_size" not in _overrides["model"]:
            cfg.model.K_size = 16
        if "L_size" not in _overrides["model"]:
            cfg.model.L_size = 15

    name = cfg.model.model_name
    base = f"./save_dir/{name}"
    cfg.model.model_dir = cfg.model.model_dir or f"{base}/model_dir"
    cfg.train.vis_dir = cfg.train.vis_dir or f"{base}/train_vis_dir"
    cfg.eval.vis_dir = cfg.eval.vis_dir or f"{base}/eval_vis_dir"
    cfg.test.vis_dir = cfg.test.vis_dir or f"{base}/test_vis_dir"
    cfg.data.vis_dir = cfg.data.vis_dir or "./save_dir/data_vis_dir"
    cfg.log.log_path = cfg.log.log_path or f"{base}/log.txt"

    if create_dirs:
        for d in [cfg.model.model_dir, cfg.train.vis_dir, cfg.eval.vis_dir,
                  cfg.test.vis_dir, cfg.data.vis_dir]:
            os.makedirs(d, exist_ok=True)
        if not _LOGGERS_CONFIGURED:
            configure_loggers(cfg.log.log_path)
            _LOGGERS_CONFIGURED = True
    return cfg


def configure_loggers(log_path: str) -> None:
    """Four named loggers with stream+file handlers
    (reference: Config/__init__.py:115-169)."""
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fmt = logging.Formatter("%(asctime)s [%(name)s] %(levelname)s %(message)s")
    for name in ["INFO", "DATA", "MODEL", "TRAIN"]:
        logger = logging.getLogger(f"hyperpose_torch.{name}")
        logger.setLevel(logging.INFO)
        logger.propagate = False  # avoid double logs via the root handler
        if not logger.handlers:
            sh = logging.StreamHandler()
            sh.setFormatter(fmt)
            fh = logging.FileHandler(log_path)
            fh.setFormatter(fmt)
            logger.addHandler(sh)
            logger.addHandler(fh)
