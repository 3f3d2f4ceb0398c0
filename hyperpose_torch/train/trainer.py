"""Training of the PyTorch port, on one device or across ranks.

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

Under `torch.distributed` (`tools/train.py` under `torchrun`) the trainer
spans every rank of the default group, as the JAX trainer spans every
device: each rank steps on its rows of rank 0's global batch, in the
config's `sync_type` (`parallel/train_step.py` Sync_sgd: BatchNorm over the
global batch and averaged gradients, the one-device step on the global
batch; `parallel/sync_modes.py` Sync_avg / Pair_avg: local steps, then the
weights exchanged), and rank 0 alone writes checkpoints. With
`spatial_parallel` sp > 1 the ranks form a dp x sp mesh, as the JAX
trainer's (`parallel/mesh.py` `make_mesh`): the sp ranks of a dp shard
each hold its images' rows and run the forward with a halo exchange around
every conv (`parallel/spatial.py`), the step equal to the one-device step
on the global batch.
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
from ..models.backbones import cross_rank_batchnorm
from ..models.openpose import openpose_loss
from ..ops.image import no_tf32
from ..parallel import mesh, spatial
from ..parallel.sync_modes import local_step
from ..parallel.train_step import sync_sgd_step
from ..utils import tracing
from .checkpoint import CheckpointManager, save_weights_npz
from .init import flax_init_, flax_init_on_cpu_
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
    """Train-loop driver of every model family: targets + forward + loss +
    update in one step, checkpoint and resume, metric logging, periodic
    weight export and map images, and adversarial domain adaptation
    (reference: single_train, parallel_train; Model/train.py:230-262
    optimize_step_dmadapt).

    `model` is the configured network (`models.get_model`); the trainer
    makes it float32 and runs its forward in the config's compute dtype.
    `device` is where the step runs: the CPU only when asked for. The
    initial weights are drawn from seed 0 and the discriminator's from 1,
    as the JAX trainer's PRNGKey(0) and PRNGKey(1). `master_dtype` float64
    makes the reference step that a float32 step is held to (`twin`): it
    computes in float64 whatever the config's compute dtype.

    With a process group initialised, the trainer joins it (`group`,
    `rank`, `world`) as a dp x sp mesh, sp the config's `spatial_parallel`:
    sp must divide the world size, dp = world / sp must divide the batch
    (the losses divide by the local batch), the world must equal
    `n_devices` when that is set, and Pair_avg needs an even dp. At dp = 1
    every `sync_type` runs the one-device step, as the JAX trainer's does
    on one device (and on a mesh with dp = 1). Under Sync_sgd with sp > 1
    the forward is row-sharded (`row_shard`); Sync_avg and Pair_avg with
    dp > 1 run each dp shard's whole local step on every one of its sp
    ranks, as the JAX sync step shards images on "dp" alone, and exchange
    the weights among the ranks of one sp index (`group`, the "dp"
    group)."""

    def __init__(self, config: Config, model: nn.Module, limbs, device="cuda",
                 master_dtype: torch.dtype = torch.float32):
        t = config.train
        self.group, self.rank, self.world = None, mesh.rank(), mesh.world_size()
        self.sp = max(int(t.spatial_parallel), 1)
        if t.n_devices and t.n_devices != self.world:
            raise ValueError(f"n_devices {t.n_devices} but {self.world} ranks")
        if self.world % self.sp:
            raise ValueError(f"{self.world} ranks are not dp x sp with spatial_parallel "
                             f"{self.sp}")
        self.dp = self.world // self.sp
        if t.batch_size % self.dp:
            raise ValueError(f"batch {t.batch_size} not divisible by {self.dp} ranks "
                             "(the losses divide by the local batch)"
                             + (f"; spatial_parallel {self.sp}" if self.sp > 1 else ""))
        self.sync_mode = None
        self.world_group = torch.distributed.group.WORLD if self.world > 1 else None
        self.group = self.world_group
        if self.dp > 1 and t.sync_type != SYNC.Sync_sgd:
            self.sync_mode = "sync_avg" if t.sync_type == SYNC.Sync_avg else "pair_avg"
            if self.sync_mode == "pair_avg" and self.dp % 2:
                raise ValueError(f"Pair_avg needs an even number of ranks, got {self.dp}")
        self.sp_index, self.sp_group = self.rank % self.sp, None
        if self.sp > 1:
            dp_sp = mesh.dp_sp_mesh(self.sp)
            self.sp_group = dp_sp.get_group("sp")
            if self.sync_mode is not None:
                self.group = dp_sp.get_group("dp")
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
        self.row_shard = None
        if self.sp > 1 and self.sync_mode is None:
            self.row_shard = spatial.make_shard(self.model, config.model.hin, self.sp_group,
                                                master_dtype, self.device)

    # -- precision -------------------------------------------------------------

    def _precision(self):
        """TF32 off around a float32 step; nothing for bfloat16."""
        return no_tf32() if self.compute_dtype == torch.float32 else contextlib.nullcontext()

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.compute_dtype == torch.bfloat16)

    def _batchnorm_group(self):
        """The train-mode forward's BatchNorm scope: across the ranks under
        Sync_sgd, this rank's batch alone otherwise."""
        return cross_rank_batchnorm(self.group if self.sync_mode is None else None)

    def _forward(self, x: torch.Tensor) -> dict:
        """The model's outputs on `x`; row-sharded, on this rank's rows with
        the halos (`parallel/spatial.py`), the maps then gathered over the
        sp ranks, so every one of them holds its dp shard's whole maps."""
        if self.row_shard is None:
            return self.model(x)
        with spatial.row_sharded(self.row_shard):
            return spatial.gather_outputs(self.model(x),
                                          getattr(self.model, "output_row_dims", None))

    @property
    def _l2_here(self) -> bool:
        """Whether this rank differentiates the objective's terms that do
        not pass through the gathered maps (the L2 term): row-sharded, the
        first sp rank alone, so that the sum of the sp ranks' gradients
        counts them once."""
        return self.row_shard is None or self.sp_index == 0

    def rank_part(self, batch: dict, unlabeled, r: int) -> tuple:
        """Rank `r`'s part of a global batch (and of a batch of unlabeled
        images): its dp shard's rows [d*B/dp, (d+1)*B/dp), d = r // sp,
        and row-sharded, only its rows of the images."""
        d = r // self.sp
        part = mesh.local_rows(batch, d, self.dp)
        unl = None if unlabeled is None else mesh.local_rows(unlabeled, d, self.dp)
        if self.row_shard is not None:
            lo, hi = self.row_shard.bounds[r % self.sp], self.row_shard.bounds[r % self.sp + 1]
            part = dict(part, images=part["images"][:, lo:hi])
            unl = None if unl is None else unl[:, lo:hi]
        return part, unl

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
        flax_init_on_cpu_(self.model, torch.Generator().manual_seed(0))
        backbone = getattr(self.model, "backbone", None)
        if isinstance(backbone, nn.Module):
            pre_npz = os.path.join(cfg.pretrain.pretrain_model_dir,
                                   f"newest_{type(backbone).__name__}.npz")
            if os.path.exists(pre_npz):
                from .pretrain import load_pretrained_backbone

                n = load_pretrained_backbone(self.model, pre_npz)
                logger.info("loaded pretrained backbone %s (%d tensors)", pre_npz, n)
        mesh.broadcast_state_(list(self.model.state_dict().values()), self.world_group)
        self.optimizer = make_optimizer(cfg, self.params)

    def _features(self, x: torch.Tensor, rows: bool = False) -> torch.Tensor:
        """The backbone features (`ret_backbone`) of `x` in eval mode, in the
        master dtype (the discriminator's); with `rows`, of this rank's rows
        of the images, gathered over the sp ranks where row-sharded."""
        model = self.model
        was = model.ret_backbone
        model.eval()
        model.ret_backbone = True
        try:
            with self._autocast():
                if rows and self.row_shard is not None:
                    with spatial.row_sharded(self.row_shard):
                        feats = spatial.gather_rows(model(x)["backbone_features"], 1)
                    return feats.to(self.master_dtype)
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
        mesh.broadcast_state_(list(disc.state_dict().values()), self.world_group)
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

    def loss_and_grads(self, batch: dict, grads: bool = True,
                       l2: bool = True) -> tuple[dict, list[torch.Tensor]]:
        """This rank's step before its update and any exchange: targets, the
        train-mode forward (which advances the BatchNorm statistics, taken
        over every rank under Sync_sgd), the loss, and its gradients with
        respect to `self.params` (none, and no autograd graph, with
        `grads=False`). Returns (metrics, grads): the family's loss parts,
        `loss_re`, `pd_loss` and `total_loss` as 0-d tensors on the device;
        with `l2=False` (the Sync_avg / Pair_avg step) the parts and
        `total_loss`, the family loss alone.

        Device spans (`utils/tracing.py`): `trainer/forward` (the batch's
        copy to the device and the autocast forward), `trainer/loss` (the
        targets, the family loss and the L2 term) and, with `grads`,
        `trainer/backward` (`torch.autograd.grad`)."""
        dev = self.device
        with self._precision(), torch.set_grad_enabled(grads), self._batchnorm_group():
            with tracing.span("trainer/forward", device=dev):
                x, kpts, valid, mask, bbxs = self._batch(batch)
                self.model.train()
                with self._autocast():
                    predict = self._forward(x)
            with tracing.span("trainer/loss", device=dev):
                pd_loss, parts = self.targets_loss(predict, kpts, valid, mask, bbxs)
                if l2:
                    re_loss = l2_regularization(self.model, self.config.train.weight_decay_factor)
                    total = pd_loss + re_loss
                    out = dict(parts, loss_re=re_loss, pd_loss=pd_loss, total_loss=total)
                    objective = total if self._l2_here else pd_loss
                else:
                    objective = total = pd_loss
                    out = dict(parts, total_loss=total)
            if grads:
                with tracing.span("trainer/backward", device=dev):
                    grads = torch.autograd.grad(objective, self.params)
            else:
                grads = []
        return {k: v.detach() for k, v in out.items()}, list(grads)

    def step(self, batch: dict, unlabeled=None, step_idx: int = 0) -> dict[str, torch.Tensor]:
        """One training step on this rank's rows of a `TrainPipeline` batch
        (the whole batch on one process; and, with domain adaptation, a uint8
        batch of unlabeled images). `step_idx` picks Pair_avg's pairing.
        Returns the step's metrics, averaged over the ranks
        (`loss_and_grads`'s, and `g_loss`, `d_loss` with domain
        adaptation). Sync_avg and Pair_avg skip domain adaptation across
        ranks, as the JAX trainer's sync branch comes before its dmadapt
        branch.

        Span `trainer/step` (host only; count `images`, this rank's rows).
        The Sync_sgd step holds `loss_and_grads`' spans and
        `trainer/optimizer`; the domain-adaptation step records
        `trainer/step` only, and Sync_avg / Pair_avg record `loss_and_grads`'
        spans in it but no `trainer/optimizer`."""
        with tracing.span("trainer/step", images=len(batch["images"])):
            if self.sync_mode is not None:
                return local_step(self, batch, step_idx, self.sync_mode)
            if self.domainadapt:
                return self.dmadapt_step(batch, unlabeled)[0]
            return sync_sgd_step(self, batch)

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
        u_feats = self._features(x_u, rows=True)
        with self._autocast(), self._batchnorm_group():
            predict = self._forward(x_l)
        pd_loss, parts = self.targets_loss(predict, kpts, valid, mask, bbxs)
        re_loss = l2_regularization(self.model, self.config.train.weight_decay_factor)
        u_logits = disc(u_feats)
        g_loss = bce_logits(u_logits, torch.ones_like(u_logits))
        adapt = self.config.train.lambda_adapt * g_loss
        total = pd_loss + re_loss + adapt
        objective = total if self._l2_here else pd_loss + adapt
        grads = list(torch.autograd.grad(objective, self.params))
        mesh.all_reduce_mean_(grads, self.group, self.dp)
        self.optimizer.step(grads)
        with torch.no_grad():
            l_feats, u_feats = self._features(x_l, rows=True), self._features(x_u, rows=True)
        _, d_loss = discriminator_losses(disc(l_feats), disc(u_feats))
        d_grads = list(torch.autograd.grad(d_loss, list(disc.parameters())))
        # the same on the sp ranks of a dp shard: the mean over the world is
        # the mean over "dp"
        mesh.all_reduce_mean_(d_grads, self.group)
        self.d_optimizer.step(d_grads)
        out = dict(parts, loss_re=re_loss, pd_loss=pd_loss, g_loss=g_loss, total_loss=total,
                   d_loss=d_loss)
        out = mesh.mean_metrics({k: v.detach() for k, v in out.items()}, self.group)
        return out, grads, d_grads

    # -- loop ------------------------------------------------------------------

    def train(self, pipeline, n_step: int | None = None, visualizer=None,
              unlabeled_pipeline=None) -> nn.Module:
        """Train for `n_step` steps (default the config's) on `pipeline`'s
        batches, resuming from the newest checkpoint under
        `<model_dir>/ckpt` when there is one; log every `log_interval`
        steps, checkpoint and write `<model_dir>/newest_model.npz` every
        `save_interval` steps and at the end, and hand `visualizer` the
        maps of the batch's first image every `vis_interval` steps. Across
        ranks, rank 0 reads the pipelines and sends each rank its rows of
        the global batch (one scatter a step), every rank steps on its
        rows, and rank 0 alone writes (the others wait at a barrier) and
        visualizes. Returns the model."""
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
        vis_every = cfg.train.vis_interval
        it = iter(pipeline) if self.rank == 0 else None
        for step_idx in range(start_step, n_step):
            batch = parts = None
            if self.rank == 0:
                batch = next(it, None)
                parts = [None] * self.world
                if batch is not None:
                    unlabeled = None
                    if unlabeled_iter is not None:
                        unlabeled = np.asarray(
                            next(unlabeled_iter) if hasattr(unlabeled_iter, "__next__")
                            else unlabeled_iter.next())
                    parts = [self.rank_part(batch, unlabeled, r) for r in range(self.world)]
            part = mesh.scatter_object(parts, self.world_group)
            if part is None:
                logger.info("pipeline exhausted at step %d", step_idx)
                break
            metrics = self.step(*part, step_idx)
            if (step_idx + 1) % log_every == 0:
                mm.update_dict({k: float(v) for k, v in metrics.items()})
                logger.info("step %d: %s [%s]", step_idx + 1, mm.report_train(),
                            mm.report_timing(log_every))
            if visualizer is not None and (step_idx + 1) % vis_every == 0 and self.rank == 0:
                self._visualize(visualizer, batch, step_idx + 1)
            if (step_idx + 1) % save_every == 0:
                self.save(step_idx + 1)
        self.save(n_step)
        return self.model

    def save(self, step: int) -> str:
        """Checkpoint the training state at `step` and write the model's
        weights as `<model_dir>/newest_model.npz` (the flat flax layout both
        packages load): on rank 0, the other ranks waiting for it at a
        barrier. Returns the npz path."""
        npz_path = os.path.join(self.config.model.model_dir, "newest_model.npz")
        if self.rank == 0:
            self.ckpt.save(step, self.state_dict(step))
            save_weights_npz(self.model, npz_path)
            logger.info("saved checkpoint at step %d -> %s", step, npz_path)
        if self.world_group is not None:
            torch.distributed.barrier(self.world_group)
        return npz_path

    def _visualize(self, visualizer, batch: dict, step: int) -> None:
        """The first image of `batch`, the network's eval-mode conf and PAF
        maps of it and their targets, handed to
        `visualizer.visualize_maps` (reference: Model/train.py:303-307,567):
        the OpenPose family only; a failure is logged and never stops
        training."""
        if self.config.model.model_type in (MODEL.PoseProposal, MODEL.Pifpaf):
            return  # map-grid visualization is OpenPose-family specific
        try:
            m = self.config.model
            n_parts = m.n_pos - 1
            self.model.eval()
            with torch.no_grad(), self._precision(), self._autocast():
                out = self.model(self._inputs(batch["images"][:1]))
            kpts = torch.as_tensor(np.asarray(batch["kpts"][:1, :, :n_parts]),
                                   dtype=torch.float32, device=self.device)
            valid = torch.as_tensor(np.asarray(batch["valid"][:1, :, :n_parts]),
                                    dtype=torch.bool, device=self.device)
            targets = openpose_targets(kpts, valid, self.limbs, (m.hin, m.win),
                                       (m.hout, m.wout))
            visualizer.visualize_maps(
                np.asarray(batch["images"][0]),
                out["conf_map"][0].to(torch.float32).cpu().numpy(),
                out["paf_map"][0].to(torch.float32).cpu().numpy(),
                f"train_step_{step}",
                gt_conf=targets["conf_map"][0].cpu().numpy(),
                gt_paf=targets["paf_map"][0].cpu().numpy(),
            )
        except Exception as exc:  # visualization must never kill training
            logger.warning("visualization failed at step %d: %s", step, exc)
        finally:
            self.model.train()
