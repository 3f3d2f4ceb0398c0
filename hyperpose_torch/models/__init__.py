"""Model facade of the PyTorch port: enum-driven construction of the pose
networks and their decoders, the serving half of
`hyperpose_tpu/models/__init__.py` (reference: hyperpose/Model/__init__.py:24-393).

    from hyperpose_torch import Config, Model

    Config.set_model_type(Config.MODEL.LightweightOpenpose)
    cfg = Config.get_config()
    model = Model.get_model(cfg)

The networks are `nn.Module`s that take NHWC images in [0, 1] (see
`openpose.py`, `pose_proposal.py`, `pifpaf.py`); their weights load from the
JAX package's flat npz (`utils/weights.py`). `get_evaluate` and `get_test`
build the `Evaluator` (`eval/evaluate.py`). The training half:
`get_loss_fn`, `get_augmentor`, `get_preprocessor` (the family's target
generator, `data/targets.py`) and `get_train` (the `Trainer`,
`train/trainer.py`), `get_pretrain` (`train/pretrain.py`) and
`get_visualizer` (`utils/visualize.py`).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
from torch import nn

from ..config import BACKBONE, DATA, MODEL, Config
from ..ops.paf_decode import PafDecoderConfig, paf_decode_batch
from ..ops.pifpaf_decode import PifPafDecoderConfig, pifpaf_decode_batch
from ..ops.ppn_decode import PpnDecoderConfig, ppn_decode_batch
from ..utils.topology import (
    COCO_TOPOLOGY, MPII_TOPOLOGY, PIFPAF_TOPOLOGY, PPN_MPII_TOPOLOGY, PPN_TOPOLOGY,
    Topology, instance_part_idx,
)
from .backbones import BACKBONES
from .openpose import (
    LightWeightOpenPose, MobilenetSmallOpenpose, MobilenetThinOpenpose, OpenPose,
    openpose_loss,
)
from .pifpaf import Pifpaf, pifpaf_fused_decode, pifpaf_loss
from .pose_proposal import PoseProposal, pose_proposal_loss, ppn_fused_decode

# Default backbone per model family (reference: Model/__init__.py:24-142).
_DEFAULT_BACKBONES = {
    MODEL.Openpose: "Vgg19",
    MODEL.LightweightOpenpose: "MobilenetDilated",
    MODEL.MobilenetThinOpenpose: "MobilenetThin",
    MODEL.PoseProposal: "Resnet18",
    MODEL.Pifpaf: "Resnet50",
}


def get_topology(config: Config) -> Topology:
    mt = config.model.model_type
    if config.model.custom_parts is not None:
        topo = config.model.custom_parts
        if config.model.custom_limbs is not None:
            topo = dataclasses.replace(
                topo, limbs=np.asarray(config.model.custom_limbs, np.int32))
        return topo
    if mt == MODEL.PoseProposal:
        if config.data.dataset_type == DATA.MPII:
            return PPN_MPII_TOPOLOGY
        return PPN_TOPOLOGY
    if mt == MODEL.Pifpaf:
        return PIFPAF_TOPOLOGY
    if config.data.dataset_type == DATA.MPII:
        return MPII_TOPOLOGY
    return COCO_TOPOLOGY


def _dtype_of(config: Config) -> torch.dtype:
    return torch.bfloat16 if config.model.compute_dtype == "bfloat16" else torch.float32


def get_backbone(config: Config):
    name = config.model.model_backbone
    if name == BACKBONE.Default:
        return BACKBONES[_DEFAULT_BACKBONES[config.model.model_type]]
    return BACKBONES[name.name]


def get_model(config: Config) -> nn.Module:
    """Construct the network for the configured type and backbone
    (reference: Model/__init__.py:24-142). A `model_arch` replaces it: an
    `nn.Module` is returned as it is, any other callable is called with the
    config."""
    if config.model.model_arch is not None:
        arch = config.model.model_arch
        return arch if isinstance(arch, nn.Module) else arch(config)
    mt = config.model.model_type
    dtype = _dtype_of(config)
    topo = get_topology(config)
    backbone = get_backbone(config)
    n_pos = config.model.n_pos
    n_limbs = topo.n_limbs

    if mt == MODEL.Openpose:
        return OpenPose(n_confmaps=n_pos, n_pafmaps=2 * n_limbs,
                        backbone=backbone, dtype=dtype)
    if mt == MODEL.LightweightOpenpose:
        return LightWeightOpenPose(
            n_confmaps=n_pos, n_pafmaps=2 * n_limbs,
            num_channels=config.model.num_channels,
            backbone=backbone, dtype=dtype,
        )
    if mt == MODEL.MobilenetThinOpenpose:
        return MobilenetThinOpenpose(
            n_confmaps=n_pos, n_pafmaps=2 * n_limbs,
            backbone=backbone, dtype=dtype,
        )
    if mt == MODEL.PoseProposal:
        m = config.model
        return PoseProposal(
            K=m.K_size, L=m.L_size, hnei=m.hnei, wnei=m.wnei,
            hin=m.hin, win=m.win, backbone=backbone, dtype=dtype,
            lmd_rsp=m.lmd_rsp, lmd_iou=m.lmd_iou, lmd_coor=m.lmd_coor,
            lmd_size=m.lmd_size, lmd_limb=m.lmd_limb,
        )
    if mt == MODEL.Pifpaf:
        # As in the JAX package, the configured backbone is not passed: the
        # PifPaf trunk stays ResNet50 (`Pifpaf(backbone=...)` takes another).
        return Pifpaf(
            n_pos=n_pos, n_limbs=n_limbs,
            hin=config.model.hin, win=config.model.win, dtype=dtype,
        )
    raise ValueError(f"unknown model type {mt}")


def get_loss_fn(config: Config):
    """The family's loss: `pose_proposal_loss(model, predict, targets)`,
    `pifpaf_loss(predict, targets)` or `openpose_loss(predict, conf, paf,
    mask)`."""
    mt = config.model.model_type
    if mt == MODEL.PoseProposal:
        return pose_proposal_loss
    if mt == MODEL.Pifpaf:
        return pifpaf_loss
    return openpose_loss


def get_augmentor(config: Config):
    """(reference: Model/__init__.py:292-310 get_augmentor)."""
    from ..data.augment import BasicAugmentor

    if config.model.custom_augmentor is not None:
        return config.model.custom_augmentor
    topo = get_topology(config)
    return BasicAugmentor(hin=config.model.hin, win=config.model.win,
                          flip_list=topo.flip_list)


def get_preprocessor(config: Config):
    """The family's target generator (`data/targets.py`), run on the device
    of the keypoints it is given (reference: Model/__init__.py:312-333
    get_preprocessor)."""
    from ..data import targets as T

    if config.model.custom_preprocessor is not None:
        return config.model.custom_preprocessor
    topo = get_topology(config)
    m = config.model
    mt = m.model_type
    if mt == MODEL.PoseProposal:
        return partial(T.ppn_targets, limbs=topo.limbs, in_hw=(m.hin, m.win),
                       out_hw=(m.hout, m.wout), nei=(m.hnei, m.wnei))
    if mt == MODEL.Pifpaf:
        return partial(T.pifpaf_targets, limbs=topo.limbs, in_hw=(m.hin, m.win),
                       out_hw=(m.hout, m.wout))
    return partial(T.openpose_targets, limbs=topo.limbs, in_hw=(m.hin, m.win),
                   out_hw=(m.hout, m.wout))


def get_train(config: Config):
    """`train(model, dataset, device="cuda")`: the dataset's training
    records through `TrainPipeline` and the family's augmentor into the
    `Trainer` on `device` (and, with domain adaptation, the unlabeled images
    through `UnlabeledPipeline`); returns the trained model, whose weights
    are also in `<model_dir>/newest_model.npz` (reference:
    Model/__init__.py:147-211). Single_train and Parallel_train map to the
    same `Trainer`, which spans every rank of the process group when one is
    initialised."""
    from ..data.pipeline import TrainPipeline
    from ..train.trainer import Trainer

    topo = get_topology(config)

    def train(model, dataset, device="cuda"):
        trainer = Trainer(config, model, topo.limbs, device=device)
        augmentor = get_augmentor(config)
        pipeline = TrainPipeline(
            dataset.get_train_records(), augmentor, batch_size=config.train.batch_size,
            out_hw=(config.model.hout, config.model.wout), n_parts=config.model.n_pos,
        )
        unlabeled = None
        if config.data.domainadapt_flag:
            from ..train.domainadapt import UnlabeledPipeline

            unlabeled = UnlabeledPipeline(config.data.domainadapt_train_img_paths, augmentor,
                                          batch_size=config.train.batch_size)
        try:
            return trainer.train(pipeline, unlabeled_pipeline=unlabeled)
        finally:
            pipeline.stop()
            if unlabeled is not None:
                unlabeled.stop()

    return train


def _ppn_decoder_config(config: Config, topo: Topology) -> PpnDecoderConfig:
    cfg = PpnDecoderConfig(instance_part=instance_part_idx(topo))
    if config.model.ppn_decoder:
        cfg = dataclasses.replace(cfg, **dict(config.model.ppn_decoder))
    return cfg


def get_postprocessor(config: Config):
    """The batched decoder of the configured family, on the device of its
    inputs (reference: Model/__init__.py:335-356 get_postprocessor):
    PAF `post(conf, paf)`, PoseProposal `post(pred)` on restored
    coordinates, PifPaf `post(raw_fields)`; each returns DecodedSkeletons.
    A `custom_postprocessor` is returned as it is."""
    if config.model.custom_postprocessor is not None:
        return config.model.custom_postprocessor
    topo = get_topology(config)
    m = config.model
    mt = m.model_type
    if mt == MODEL.PoseProposal:
        return partial(
            ppn_decode_batch, cfg=_ppn_decoder_config(config, topo),
            hnei=m.hnei, wnei=m.wnei, in_hw=(m.hin, m.win), topology=topo,
        )
    if mt == MODEL.Pifpaf:
        return partial(
            pifpaf_decode_batch, cfg=PifPafDecoderConfig(), stride=m.hin // m.hout,
            in_hw=(m.hin, m.win), topology=topo,
        )
    cfg = PafDecoderConfig(n_parts=topo.n_parts, n_limbs=topo.n_limbs)
    return partial(paf_decode_batch, cfg=cfg, topology=topo)


def _custom_fused(model: nn.Module, post, restore: bool):
    """A fused step around a `custom_postprocessor` (the JAX package's
    `_fused_decode_for` calls `get_postprocessor`, so a custom one replaces
    the family's decode inside the step): the network, PoseProposal's
    `restore_coor` where `restore`, then `post`."""
    model.eval()

    def decode(out: dict, image_hw=None):
        if restore:
            hout, wout = out["c"].shape[1:3]
            rx, ry, rw, rh = model.restore_coor(out["x"], out["y"], out["w"], out["h"],
                                                hout, wout)
            out = {**out, "x": rx, "y": ry, "w": rw, "h": rh}
        return post(out)

    def body(images_u8: torch.Tensor):
        return decode(model(images_u8.to(model.dtype) / 255.0))

    fused = torch.inference_mode()(body)
    fused.body, fused.decode = body, decode
    fused.rebuild = lambda other: _custom_fused(other, post, restore)
    return fused


def _fused_decode_for(config: Config, model: nn.Module):
    """The `PoseEngine(fused_decode=...)` step of the non-PAF families
    (uint8 images -> DecodedSkeletons), built from the config as
    `get_postprocessor` builds the decoder; None for the PAF family, which
    the engine decodes itself."""
    mt = config.model.model_type
    m = config.model
    if mt not in (MODEL.PoseProposal, MODEL.Pifpaf):
        return None
    if m.custom_postprocessor is not None:
        return _custom_fused(model, m.custom_postprocessor, mt == MODEL.PoseProposal)
    topo = get_topology(config)
    if mt == MODEL.PoseProposal:
        return ppn_fused_decode(model, _ppn_decoder_config(config, topo), topo)
    return pifpaf_fused_decode(model, PifPafDecoderConfig(), m.hin // m.hout,
                               (m.hin, m.win), topo)


def evaluator(config: Config, model: nn.Module, dataset, device="cuda", multiscale=False):
    """The `Evaluator` of `model` on `dataset` with the config's input size,
    eval batch size and its family's decode (`_fused_decode_for`)."""
    from ..eval.evaluate import Evaluator

    return Evaluator(
        model, dataset, input_hw=(config.model.hin, config.model.win),
        output_converter=dataset.output_converter, topology=get_topology(config),
        batch_size=config.eval.batch_size, multiscale=multiscale,
        fused_decode=_fused_decode_for(config, model), device=device,
    )


def get_evaluate(config: Config):
    """`evaluate(model, dataset, limit=None, device="cuda")` -> the dataset's
    metrics dict, on the config's input size, eval batch size and
    multiscale flag (reference: Model/__init__.py:213-250). The model
    carries its weights."""

    def evaluate(model, dataset, limit=None, device="cuda"):
        ev = evaluator(config, model, dataset, device, config.eval.multiscale)
        return ev.evaluate(limit=limit, eval_dir=config.eval.vis_dir)

    return evaluate


def get_test(config: Config):
    """`test(model, dataset, limit=None, device="cuda")` -> the path of the
    submission json it writes (reference: Model/__init__.py:252-290)."""

    def test(model, dataset, limit=None, device="cuda"):
        ev = evaluator(config, model, dataset, device, False)
        return ev.test(limit=limit, test_dir=config.test.vis_dir)

    return test


def get_visualizer(config: Config):
    """The config's custom visualizer, or a `Visualizer` of its topology
    writing under `train.vis_dir`."""
    from ..utils.visualize import Visualizer

    if config.model.custom_visualizer is not None:
        return config.model.custom_visualizer
    return Visualizer(topology=get_topology(config), save_dir=config.train.vis_dir)


def get_pretrain(config: Config):
    """`single_pretrain(backbone_cls, ...)` bound to `config` (reference:
    Model/__init__.py:144, Model/pretrain.py:39)."""
    from ..train.pretrain import single_pretrain

    return partial(single_pretrain, config=config)
