"""Single-device training of the PyTorch port.

A port of `hyperpose_tpu/train/trainer.py` (reference: Model/train.py:94-325
single_train): one step on the device builds the family's targets from the
keypoints, runs the network in train mode (BatchNorm on batch statistics,
updating its running statistics as flax does), adds the L2 term of the
conv and dense kernels, and applies optax's update equations
(`train/optim.py`). Parameters, BatchNorm statistics and optimizer state
are float32, as flax keeps them; with the config's bfloat16 compute dtype
the forward runs under `torch.autocast`, which casts the float32 master
weights to bfloat16 at each conv, as a flax module with `dtype=bfloat16`
and float32 `param_dtype` does. A float32 step runs with TF32 off (the
flags restored after it), so it computes in float32 as the JAX package
does on the CPU.

The multi-device modes (Sync_avg, Pair_avg, spatial parallelism) are not
ported yet.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..config import MODEL, OPTIM, SYNC, Config
from ..data.targets import openpose_targets
from ..models.openpose import openpose_loss
from ..ops.image import no_tf32
from .checkpoint import CheckpointManager, save_weights_npz
from .init import flax_init_
from .metrics import MetricManager
from .optim import Optimizer

logger = logging.getLogger("hyperpose_torch.TRAIN")


def staged_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """step -> learning rate, in float32 as the JAX schedule computes it:
    lr_init scaled by lr_decay_factor every lr_decay_every_step steps, or at
    each of `lr_decay_steps` when it is set (reference:
    Model/train.py:126,214-216,283-286; config_pifpaf.py)."""
    t = cfg.train
    lr0, f = np.float32(t.lr_init), np.float32(t.lr_decay_factor)

    def schedule(step: int) -> float:
        if t.lr_decay_steps:
            factor = np.float32(1.0)
            for boundary in t.lr_decay_steps:
                if step >= boundary:
                    factor = np.float32(factor * f)
            return float(lr0 * factor)
        n = np.float32(step // t.lr_decay_every_step)
        return float(lr0 * np.power(f, n))

    return schedule


def make_optimizer(cfg: Config, params) -> Optimizer:
    """The config's optimizer over `params` (optax.adam / rmsprop / sgd with
    their defaults on `staged_lr_schedule`), behind global-norm clipping when
    `grad_clip_norm` is set and averaging `grad_accum_steps` steps'
    gradients when it is above 1 (optax.MultiSteps)."""
    kind = {OPTIM.Adam: "adam", OPTIM.RMSprop: "rmsprop"}.get(cfg.train.optim_type, "sgd")
    return Optimizer(params, kind, staged_lr_schedule(cfg),
                     clip_norm=cfg.train.grad_clip_norm or 0.0,
                     accum_steps=cfg.train.grad_accum_steps)


def kernel_params(model: nn.Module) -> list[torch.Tensor]:
    """The parameters whose flax leaf is named `kernel`: conv and dense
    weights (not BatchNorm scales, biases, PReLU slopes or SeparableConv's
    `dw_kernel` / `pw_kernel`, which flax names otherwise)."""
    return [p for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] == "weight" and p.ndim in (2, 4)]


def l2_regularization(model: nn.Module, weight_decay: float) -> torch.Tensor:
    """weight_decay * the sum of squares of every kernel (reference:
    Model/common.py:168-173 regulize_loss)."""
    return weight_decay * sum(torch.sum(torch.square(w)) for w in kernel_params(model))


def as_master(model: nn.Module, dtype: torch.dtype = torch.float32) -> nn.Module:
    """`model` with parameters and statistics in `dtype`, and every `dtype`
    attribute of its modules (the input cast of the networks) `dtype`: the
    compute dtype is then the trainer's autocast."""
    model.to(dtype)
    for mod in model.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = dtype
    return model


def check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Trainer(device='cuda'), but torch finds no CUDA device; pass "
            "device='cpu' to train on the CPU")
    return dev


class Trainer:
    """Train-loop driver of every model family on one device: targets +
    forward + loss + update in one step, checkpoint and resume, metric
    logging, periodic weight export, and adversarial domain adaptation
    (reference: single_train; Model/train.py:230-262 optimize_step_dmadapt).

    `model` is the configured network (`models.get_model`); the trainer
    makes it float32 and runs its forward in the config's compute dtype.
    `device` is where the step runs: the CPU only when asked for. The
    initial weights are drawn from seed 0 and the discriminator's from 1,
    as the JAX trainer's PRNGKey(0) and PRNGKey(1). `master_dtype` float64
    makes the reference step that a float32 step is held to (`twin`): it
    computes in float64 whatever the config's compute dtype."""

    def __init__(self, config: Config, model: nn.Module, limbs, device="cuda",
                 master_dtype: torch.dtype = torch.float32):
        t = config.train
        if t.sync_type != SYNC.Sync_sgd or t.spatial_parallel > 1:
            raise NotImplementedError(
                f"sync_type {t.sync_type.name} / spatial_parallel {t.spatial_parallel}: "
                "the multi-device modes are not ported yet (ROADMAP Queue 1 #6); "
                "the port trains Sync_sgd on one device")
        self.device = check_device(device)
        self.config = config
        self.master_dtype = master_dtype
        self.compute_dtype = (torch.bfloat16 if config.model.compute_dtype == "bfloat16"
                              and master_dtype == torch.float32 else master_dtype)
        self.model = as_master(model, master_dtype).to(self.device)
        if self.device.type == "cuda":
            self.model = self.model.to(memory_format=torch.channels_last)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.limbs = np.asarray(limbs)
        self.metric_manager = MetricManager()
        self.ckpt = CheckpointManager(config.model.model_dir)
        self.optimizer: Optimizer | None = None
        self.targets_loss = self._family_targets_loss(
            config, self.model, self.limbs, (config.model.hin, config.model.win),
            (config.model.hout, config.model.wout))
        self.domainadapt = bool(config.data.domainadapt_flag)
        self.discriminator: nn.Module | None = None
        self.d_optimizer: Optimizer | None = None

    # -- precision -------------------------------------------------------------

    def _precision(self):
        """TF32 off around a float32 step; nothing for bfloat16."""
        return no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)

    def _inputs(self, images) -> torch.Tensor:
        """uint8 NHWC images -> the network's input, / 255 in the compute
        dtype as the JAX step forms it."""
        x = torch.as_tensor(np.asarray(images)).to(self.device, non_blocking=True)
        return x.to(self.compute_dtype) / 255.0

    # -- targets and losses ----------------------------------------------------

    @staticmethod
    def _family_targets_loss(cfg, model, limbs, in_hw, out_hw):
        """(predict, kpts, valid, mask, bbxs) -> (loss, parts): the family's
        targets, built on the device, and its loss (replaces the reference's
        per-algorithm PreProcessor + cal_loss pairing,
        Model/__init__.py:312-333)."""
        mt = cfg.model.model_type
        if mt == MODEL.PoseProposal:
            from ..data.targets import ppn_targets
            from ..models import get_topology
            from ..models.pose_proposal import pose_proposal_loss
            from ..utils.topology import instance_part_idx

            inst = instance_part_idx(get_topology(cfg))

            def ppn_fn(predict, kpts, valid, mask, bbxs):
                targets = ppn_targets(kpts, valid, bbxs, limbs, in_hw, out_hw,
                                      nei=(cfg.model.hnei, cfg.model.wnei), instance_idx=inst)
                return pose_proposal_loss(model, predict, targets)

            return ppn_fn
        if mt == MODEL.Pifpaf:
            from ..data.targets import pifpaf_targets
            from ..models.pifpaf import pifpaf_loss

            def pifpaf_fn(predict, kpts, valid, mask, bbxs):
                return pifpaf_loss(predict, pifpaf_targets(kpts, valid, limbs, in_hw, out_hw,
                                                           mask=mask))

            return pifpaf_fn
        # OpenPose family. Model confidence channels = parts + background;
        # the keypoint array may carry a dead background row (converter
        # convention) that must not become a target channel.
        n_parts = cfg.model.n_pos - 1

        def opps_fn(predict, kpts, valid, mask, bbxs):
            targets = openpose_targets(kpts[:, :, :n_parts], valid[:, :, :n_parts], limbs,
                                       in_hw, out_hw, mask=mask)
            return openpose_loss(predict, targets["conf_map"], targets["paf_map"], mask)

        return opps_fn

    # -- state -----------------------------------------------------------------

    def init_state(self) -> None:
        """flax-initialized parameters (`train/init.py`, drawn from a
        generator seeded with 0), the pretrained-backbone graft of
        `<pretrain_model_dir>/newest_<Backbone>.npz` when that file exists
        (reference: Model/train.py:191-195), and a fresh optimizer."""
        cfg = self.config
        self._init_on_cpu(self.model, torch.Generator().manual_seed(0))
        backbone = getattr(self.model, "backbone", None)
        if isinstance(backbone, nn.Module):
            pre_npz = os.path.join(cfg.pretrain.pretrain_model_dir,
                                   f"newest_{type(backbone).__name__}.npz")
            if os.path.exists(pre_npz):
                from .pretrain import load_pretrained_backbone

                n = load_pretrained_backbone(self.model, pre_npz)
                logger.info("loaded pretrained backbone %s (%d tensors)", pre_npz, n)
        self.optimizer = make_optimizer(cfg, self.params)

    @staticmethod
    def _init_on_cpu(model: nn.Module, gen: torch.Generator) -> None:
        """`flax_init_` drawn on a contiguous CPU copy of `model` and copied
        into it, so every device and memory layout starts from the same
        numbers (a generator fills a tensor in memory order, and the card's
        model is channels-last)."""
        shadow = copy.deepcopy(model).to("cpu").to(memory_format=torch.contiguous_format)
        shadow = flax_init_(shadow, gen).state_dict()
        with torch.no_grad():
            for k, v in model.state_dict().items():
                v.copy_(shadow[k])

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """The backbone features (`ret_backbone`) of `x` in eval mode, in the
        master dtype (the discriminator's)."""
        model = self.model
        was = model.ret_backbone
        model.eval()
        model.ret_backbone = True
        try:
            with self._autocast():
                return model(x)["backbone_features"].to(self.master_dtype)
        finally:
            model.ret_backbone = was
            model.train()

    def init_dmadapt_state(self) -> None:
        """The discriminator sized to the backbone features, flax-initialized
        (seed 1), and its Adam on the staged schedule."""
        from .domainadapt import Discriminator

        cfg = self.config
        with torch.no_grad(), self._precision():
            dummy = torch.zeros((1, cfg.model.hin, cfg.model.win, 3), dtype=self.compute_dtype,
                                device=self.device)
            feats = self._features(dummy)
        disc = Discriminator(feats.shape[-1], tuple(feats.shape[1:3]))
        flax_init_(disc, torch.Generator().manual_seed(1))
        self.discriminator = disc.to(self.device)
        self.d_optimizer = Optimizer(list(disc.parameters()), "adam", staged_lr_schedule(cfg))

    def twin(self, master_dtype: torch.dtype = torch.float64) -> "Trainer":
        """A trainer on the same device at this one's state (weights,
        statistics, optimizer and discriminator) with `master_dtype`
        parameters and compute: the float64 reference of a step."""
        tw = Trainer(self.config, copy.deepcopy(self.model), self.limbs, device=self.device,
                     master_dtype=master_dtype)
        tw.optimizer = make_optimizer(self.config, tw.params)
        tw.optimizer.load_state_dict(self.optimizer.state_dict())
        if self.discriminator is not None:
            tw.discriminator = copy.deepcopy(self.discriminator).to(master_dtype)
            tw.d_optimizer = Optimizer(list(tw.discriminator.parameters()), "adam",
                                       staged_lr_schedule(self.config))
            tw.d_optimizer.load_state_dict(self.d_optimizer.state_dict())
        return tw

    def state_dict(self, step: int) -> dict:
        state = {"step": int(step), "model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict()}
        if self.discriminator is not None:
            # Discriminator checkpointed alongside the pose model
            # (reference: Model/train.py:202-207,322-325).
            state["discriminator"] = self.discriminator.state_dict()
            state["d_optimizer"] = self.d_optimizer.state_dict()
        return state

    def load_state_dict(self, state: dict) -> int:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.discriminator is not None and "discriminator" in state:
            self.discriminator.load_state_dict(state["discriminator"])
            self.d_optimizer.load_state_dict(state["d_optimizer"])
        return int(state["step"])

    # -- steps -----------------------------------------------------------------

    def _batch(self, batch: dict) -> tuple:
        dev = self.device

        def put(key, dtype=None):
            t = torch.as_tensor(np.asarray(batch[key])).to(dev, non_blocking=True)
            return t if dtype is None else t.to(dtype)

        return (self._inputs(batch["images"]), put("kpts", torch.float32),
                put("valid", torch.bool), put("mask", torch.float32), put("bbxs", torch.float32))

    def loss_and_grads(self, batch: dict, grads: bool = True) -> tuple[dict, list[torch.Tensor]]:
        """The step before its update: targets, the train-mode forward
        (which advances the BatchNorm statistics), the loss, and its
        gradients with respect to `self.params` (none, and no autograd
        graph, with `grads=False`). Returns (metrics, grads): the family's
        loss parts, `loss_re`, `pd_loss` and `total_loss` as 0-d tensors on
        the device."""
        with self._precision(), torch.set_grad_enabled(grads):
            x, kpts, valid, mask, bbxs = self._batch(batch)
            self.model.train()
            with self._autocast():
                predict = self.model(x)
            pd_loss, parts = self.targets_loss(predict, kpts, valid, mask, bbxs)
            re_loss = l2_regularization(self.model, self.config.train.weight_decay_factor)
            total = pd_loss + re_loss
            grads = torch.autograd.grad(total, self.params) if grads else []
        out = dict(parts, loss_re=re_loss, pd_loss=pd_loss, total_loss=total)
        return {k: v.detach() for k, v in out.items()}, list(grads)

    def step(self, batch: dict, unlabeled=None) -> dict[str, torch.Tensor]:
        """One training step on a `TrainPipeline` batch (and, with domain
        adaptation, a uint8 batch of unlabeled images). Returns the step's
        metrics (`loss_and_grads`'s, and `g_loss`, `d_loss` with domain
        adaptation)."""
        if self.domainadapt:
            return self.dmadapt_step(batch, unlabeled)[0]
        metrics, grads = self.loss_and_grads(batch)
        with self._precision():
            self.optimizer.step(grads)
        return metrics

    def dmadapt_step(self, batch: dict, unlabeled) -> tuple[dict, list, list]:
        """One step of domain adaptation: pose loss + L2 + lambda_adapt x the
        generator loss, whose unlabeled backbone features are read in eval
        mode on the statistics from before the step, then a discriminator
        update on detached features of both streams after it (reference:
        Model/train.py:230-262,475-507 optimize_step_dmadapt; the JAX
        trainer's `_build_dmadapt_step`). Returns (metrics, the network's
        gradients, the discriminator's)."""
        with self._precision():
            return self._dmadapt_step(batch, unlabeled)

    def _dmadapt_step(self, batch: dict, unlabeled) -> tuple[dict, list, list]:
        from .domainadapt import bce_logits, discriminator_losses

        x_l, kpts, valid, mask, bbxs = self._batch(batch)
        x_u = self._inputs(unlabeled)
        disc = self.discriminator
        u_feats = self._features(x_u)
        with self._autocast():
            predict = self.model(x_l)
        pd_loss, parts = self.targets_loss(predict, kpts, valid, mask, bbxs)
        re_loss = l2_regularization(self.model, self.config.train.weight_decay_factor)
        u_logits = disc(u_feats)
        g_loss = bce_logits(u_logits, torch.ones_like(u_logits))
        total = pd_loss + re_loss + self.config.train.lambda_adapt * g_loss
        grads = torch.autograd.grad(total, self.params)
        self.optimizer.step(grads)
        with torch.no_grad():
            l_feats, u_feats = self._features(x_l), self._features(x_u)
        _, d_loss = discriminator_losses(disc(l_feats), disc(u_feats))
        d_grads = torch.autograd.grad(d_loss, list(disc.parameters()))
        self.d_optimizer.step(d_grads)
        out = dict(parts, loss_re=re_loss, pd_loss=pd_loss, g_loss=g_loss, total_loss=total,
                   d_loss=d_loss)
        return {k: v.detach() for k, v in out.items()}, list(grads), list(d_grads)

    # -- loop ------------------------------------------------------------------

    def train(self, pipeline, n_step: int | None = None, visualizer=None,
              unlabeled_pipeline=None) -> nn.Module:
        """Train for `n_step` steps (default the config's) on `pipeline`'s
        batches, resuming from the newest checkpoint under
        `<model_dir>/ckpt` when there is one; log every `log_interval`
        steps, checkpoint and write `<model_dir>/newest_model.npz` every
        `save_interval` steps and at the end. Returns the model."""
        if visualizer is not None:
            raise NotImplementedError(
                "the training visualizer is not ported yet (ROADMAP Queue 1 #7)")
        cfg = self.config
        n_step = n_step or cfg.train.n_step
        self.init_state()
        unlabeled_iter = None
        if self.domainadapt:
            if unlabeled_pipeline is None:
                raise ValueError(
                    "domainadapt_flag is set but no unlabeled_pipeline was given "
                    "(see train.domainadapt.UnlabeledPipeline)")
            self.init_dmadapt_state()
            unlabeled_iter = unlabeled_pipeline
        start_step = 0
        restored_step, restored = self.ckpt.restore(map_location=self.device)
        if restored is not None:
            start_step = self.load_state_dict(restored)
            logger.info("resumed from step %d", start_step)

        mm = self.metric_manager
        log_every, save_every = cfg.log.log_interval, cfg.train.save_interval
        it = iter(pipeline)
        for step_idx in range(start_step, n_step):
            try:
                batch = next(it)
            except StopIteration:
                logger.info("pipeline exhausted at step %d", step_idx)
                break
            unlabeled = None
            if unlabeled_iter is not None:
                unlabeled = (next(unlabeled_iter) if hasattr(unlabeled_iter, "__next__")
                             else unlabeled_iter.next())
            metrics = self.step(batch, unlabeled)
            if (step_idx + 1) % log_every == 0:
                mm.update_dict({k: float(v) for k, v in metrics.items()})
                logger.info("step %d: %s [%s]", step_idx + 1, mm.report_train(),
                            mm.report_timing(log_every))
            if (step_idx + 1) % save_every == 0:
                self.save(step_idx + 1)
        self.save(n_step)
        return self.model

    def save(self, step: int) -> str:
        """Checkpoint the training state at `step` and write the model's
        weights as `<model_dir>/newest_model.npz` (the flat flax layout both
        packages load). Returns the npz path."""
        self.ckpt.save(step, self.state_dict(step))
        npz_path = os.path.join(self.config.model.model_dir, "newest_model.npz")
        save_weights_npz(self.model, npz_path)
        logger.info("saved checkpoint at step %d -> %s", step, npz_path)
        return npz_path

