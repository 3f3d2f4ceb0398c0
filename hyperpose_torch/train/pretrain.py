"""ImageNet pretraining of the backbones, and the pretrained-backbone graft.

A port of `hyperpose_tpu/train/pretrain.py` (reference:
hyperpose/Model/pretrain.py:39-170 single_pretrain/single_val and
Dataset/imagenet_dataset/dataset.py:5-80 the folder-label dataset), on the
reference protocol: the backbone's `pretraining` variant (its classifier
head, `models/backbones.py`), Adam with the decayed-weights term on every
parameter and a learning rate kept in the optimizer's state, divided by 5
on the step schedule and after 3 validations that do not improve, periodic
top-1 / top-5 validation, and `newest_<Backbone>.npz` in the flat flax
layout, which `Trainer.init_state` grafts into a family model's backbone.

The port's functions take the model, which carries its weights, where the
JAX package's take (model, params, batch_stats): `single_val(model, ...)`,
`val_fn(model)`, and `single_pretrain` returns (model, history). A float32
run computes with TF32 off; `compute_dtype=torch.bfloat16` runs the forward
under autocast on float32 master weights, as `Trainer` does.
"""
from __future__ import annotations

import contextlib
import inspect
import logging
import os
from typing import Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ops.image import no_tf32
from ..utils.weights import flax_to_state_dict, state_dict_to_flax
from .checkpoint import CheckpointManager, load_npz_tree, save_weights_npz
from .init import flax_init_on_cpu_
from .metrics import MetricManager
from .optim import Optimizer

logger = logging.getLogger("hyperpose_torch.TRAIN")


class ImagenetDataset:
    """Folder-per-class image dataset
    (reference: Dataset/imagenet_dataset/dataset.py). Expects
    <root>/<class_name>/*.JPEG; class ids assigned by sorted folder name.
    `classes` may be passed to pin the id assignment (so a val split uses
    the train split's ids even if a class folder is missing). A copy of the
    JAX package's: the same numpy rng calls, so both yield the same
    batches."""

    def __init__(self, root: str, image_size: int = 224,
                 classes: list[str] | None = None):
        self.root = root
        self.image_size = image_size
        self.classes = classes if classes is not None else sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.samples: list[tuple[str, int]] = []
        for ci, cname in enumerate(self.classes):
            cdir = os.path.join(root, cname)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fname), ci))

    def batches(
        self, batch_size: int, rng: np.random.Generator, train: bool = True
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        import cv2

        order = rng.permutation(len(self.samples))
        s = self.image_size
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs = np.zeros((batch_size, s, s, 3), np.float32)
            labels = np.zeros((batch_size,), np.int32)
            for j, idx in enumerate(order[i:i + batch_size]):
                path, label = self.samples[idx]
                img = cv2.imread(path)
                if img is None:
                    continue
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                if train:
                    # random resized crop light variant
                    h, w = img.shape[:2]
                    scale = s / min(h, w)
                    img = cv2.resize(
                        img, (int(w * scale) + 1, int(h * scale) + 1)
                    )
                    oy = rng.integers(0, img.shape[0] - s + 1)
                    ox = rng.integers(0, img.shape[1] - s + 1)
                    img = img[oy:oy + s, ox:ox + s]
                    if rng.random() < 0.5:
                        img = img[:, ::-1]
                else:
                    img = cv2.resize(img, (s, s))
                imgs[j] = img / 255.0
                labels[j] = label
            yield imgs, labels


def load_imagenet_splits(
    root: str, image_size: int = 224
) -> tuple[ImagenetDataset, ImagenetDataset | None]:
    """(train, val) datasets. A pre-split layout <root>/{train,val}/<class>/
    is used when present; otherwise <root>/<class>/ with no val split."""
    tdir = os.path.join(root, "train")
    vdir = os.path.join(root, "val")
    if os.path.isdir(tdir):
        train = ImagenetDataset(tdir, image_size)
        val = ImagenetDataset(vdir, image_size, classes=train.classes) \
            if os.path.isdir(vdir) else None
        return train, val
    return ImagenetDataset(root, image_size), None


def _topk_acc(logits: np.ndarray, labels: np.ndarray, k: int) -> float:
    topk = np.argsort(-logits, axis=-1)[:, :k]
    return float(np.mean([l in t for l, t in zip(labels, topk)]))


def _model_device_dtype(model: nn.Module) -> tuple[torch.device, torch.dtype]:
    p = next(model.parameters())
    return p.device, p.dtype


def _nchw(images: np.ndarray, device, dtype) -> torch.Tensor:
    """NHWC float images in [0, 1] -> the backbone's NCHW input."""
    x = torch.as_tensor(images).to(device, non_blocking=True).permute(0, 3, 1, 2)
    x = x.to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


@torch.no_grad()
def single_val(
    model: nn.Module, dataset: ImagenetDataset, config: Config, batch_size: int = 64,
) -> dict[str, float]:
    """Validation top1/top5 (reference: Model/pretrain.py:144-170): the
    eval-mode forward in the model's parameter dtype (TF32 off), logits in
    float32, on up to `val_num` images of `dataset` in a seed-1 order."""
    p = config.pretrain
    device, dtype = _model_device_dtype(model)
    was_training = model.training
    model.eval()
    rng = np.random.default_rng(1)
    bs = min(batch_size, len(dataset.samples))
    top1 = top5 = n = 0
    try:
        with no_tf32():
            for images, labels in dataset.batches(bs, rng, train=False):
                logits = model(_nchw(images, device, dtype)).to(torch.float32).cpu().numpy()
                top1 += _topk_acc(logits, labels, 1) * len(labels)
                top5 += _topk_acc(logits, labels, 5) * len(labels)
                n += len(labels)
                if n >= p.val_num:
                    break
    finally:
        model.train(was_training)
    if n == 0:
        return {"top1": 0.0, "top5": 0.0, "n": 0}
    return {"top1": top1 / n, "top5": top5 / n, "n": n}


class PretrainStep:
    """One pretraining step of `model` on the card or the CPU: the
    train-mode forward (autocast in bfloat16; TF32 off otherwise), softmax
    cross-entropy of the float32 logits (float64 in a float64 run) against
    the integer labels, its gradients and the optimizer's update."""

    def __init__(self, model: nn.Module, optimizer: Optimizer, compute_dtype: torch.dtype):
        self.model, self.optimizer = model, optimizer
        self.device = _model_device_dtype(model)[0]
        self.compute_dtype = compute_dtype
        self.params = [p for p in model.parameters() if p.requires_grad]

    def loss_and_grads(self, images, labels):
        """(loss, logits, grads) of one batch; the BatchNorm statistics
        advance."""
        bf16 = self.compute_dtype == torch.bfloat16
        with contextlib.nullcontext() if bf16 else no_tf32():
            x = _nchw(images, self.device, self.compute_dtype)
            y = torch.as_tensor(np.asarray(labels)).to(self.device, torch.long)
            self.model.train()
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=bf16):
                logits = self.model(x)
            # float32 logits, as JAX casts them; float64 in a float64 run
            loss = F.cross_entropy(logits.to(torch.promote_types(logits.dtype, torch.float32)),
                                   y)
            grads = torch.autograd.grad(loss, self.params)
        return loss.detach(), logits.detach(), list(grads)

    def __call__(self, images, labels):
        loss, logits, grads = self.loss_and_grads(images, labels)
        self.optimizer.step(grads)
        return loss, logits


def pretrain_model(backbone_cls, image_size, device="cuda") -> nn.Module:
    """`backbone_cls(pretraining=True)` (for `image_size` inputs where its
    head flattens the features) with flax's initialization drawn from seed
    0 (the JAX loop's PRNGKey(0)) on a CPU copy, float32, on `device`
    (channels-last on the card)."""
    # the flattening heads' fan-in depends on the image size; the others' not
    takes_size = "image_size" in inspect.signature(backbone_cls).parameters
    model = backbone_cls(pretraining=True, **({"image_size": image_size} if takes_size else {}))
    flax_init_on_cpu_(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def pretrain_optimizer(model: nn.Module, config: Config) -> Optimizer:
    """optax.chain(add_decayed_weights(wd), inject_hyperparams(adam)(lr_init))
    over the model's parameters."""
    p = config.pretrain
    return Optimizer([q for q in model.parameters() if q.requires_grad], "adam",
                     p.lr_init, weight_decay=p.weight_decay_factor)


def single_pretrain(
    backbone_cls, config: Config, dataset: ImagenetDataset | None = None,
    val_dataset: ImagenetDataset | None = None, n_step: int | None = None,
    val_fn: Callable[[nn.Module], dict] | None = None, device="cuda",
    compute_dtype: torch.dtype = torch.float32,
):
    """Classification pretraining with top1/top5 tracking and lr/5 decay on
    BOTH the step schedule and 3 stuck validations
    (reference: Model/pretrain.py:39-142: `if step % lr_decay_step == 0:
    lr = lr/5` and `if stuck_time >= 3: lr = lr/5`). Checkpoints the model
    and the optimizer (its learning rate included) under
    `<pretrain_model_dir>/ckpt`, resuming from the newest, and writes
    `<pretrain_model_dir>/newest_<Backbone>.npz` for the Trainer's
    pretrained-backbone graft.

    `val_fn(model) -> {"top1": ...}` overrides the validation call (tests
    script it to drive the stuck branch deterministically). `device` is
    where the steps run (the CPU only when asked for); `compute_dtype`
    float32 (the JAX loop's, TF32 off) or bfloat16 (autocast on the float32
    weights). Returns (model, history), where history records logged
    loss/top1, lr-decay events and validations."""
    from .trainer import check_device

    p = config.pretrain
    dev = check_device(device)
    if dataset is None:
        dataset, val_dataset = load_imagenet_splits(p.pretrain_dataset_path)
    model = pretrain_model(backbone_cls, dataset.image_size, dev)
    opt = pretrain_optimizer(model, config)
    step = PretrainStep(model, opt, compute_dtype)

    mm = MetricManager()
    ckpt = CheckpointManager(p.pretrain_model_dir)
    nrng = np.random.default_rng(0)
    total = n_step or p.total_step
    history = {"log": [], "lr_events": [], "val": []}

    step_idx = 0
    restored_step, restored = ckpt.restore(map_location=dev)
    if restored is not None:
        step_idx = restored_step
        model.load_state_dict(restored["model"])
        opt.load_state_dict(restored["optimizer"])
        logger.info("pretrain resumed from step %d", step_idx)

    max_eval_acc, stuck_time = 0.0, 0
    npz_path = os.path.join(p.pretrain_model_dir, f"newest_{backbone_cls.__name__}.npz")

    def save(step_i):
        ckpt.save(step_i, {"step": int(step_i), "model": model.state_dict(),
                           "optimizer": opt.state_dict()})
        save_weights_npz(model, npz_path)
        logger.info("pretrain saved step %d -> %s", step_i, npz_path)

    while step_idx < total:
        for images, labels in dataset.batches(p.batch_size, nrng):
            loss, logits = step(images, labels)
            step_idx += 1
            # scheduled lr/5 (reference: pretrain.py:106-107)
            if step_idx % p.lr_decay_step == 0:
                opt.set_learning_rate(opt.learning_rate / 5.0)
                history["lr_events"].append(("schedule", step_idx))
            if step_idx % p.log_interval == 0:
                ln = logits.to(torch.float32).cpu().numpy()
                loss_f = float(loss)
                mm.update("pretrain/loss", loss_f)
                mm.update("pretrain/top1", _topk_acc(ln, labels, 1))
                mm.update("pretrain/top5", _topk_acc(ln, labels, 5))
                row = {"step": step_idx, "lr": opt.learning_rate, "loss": loss_f,
                       "top1": _topk_acc(ln, labels, 1)}
                history["log"].append(row)
                logger.info("pretrain step %d (lr %.2e): %s", step_idx,
                            row["lr"], mm.report_train())
            if step_idx % p.save_interval == 0:
                save(step_idx)
            # stuck-val lr/5 decay (reference: pretrain.py:126-142)
            if step_idx % p.val_interval == 0 and (
                val_fn is not None or val_dataset is not None
            ):
                if val_fn is not None:
                    v = val_fn(model)
                else:
                    v = single_val(model, val_dataset, config)
                acc = v["top1"]
                history["val"].append({"step": step_idx, **v})
                if acc < max_eval_acc:
                    stuck_time += 1
                else:
                    max_eval_acc = acc
                logger.info(
                    "pretrain val step %d: top1=%.4f max=%.4f stuck=%d",
                    step_idx, acc, max_eval_acc, stuck_time,
                )
                if stuck_time >= 3:
                    opt.set_learning_rate(opt.learning_rate / 5.0)
                    history["lr_events"].append(("stuck_val", step_idx))
                    stuck_time = 0
            if step_idx >= total:
                break
    save(step_idx)
    return model, history


def load_pretrained_backbone(model: nn.Module, npz_path: str) -> int:
    """Graft a pretrain checkpoint (newest_<Backbone>.npz, whose keys are
    the backbone's own: `params/block_0/conv/kernel`, ...) into `model`'s
    `backbone` submodule in place (reference: Model/train.py:191-195
    train_model.backbone.load_weight(pretrain_model_path)). Tolerant: only
    leaves of the same path and shape copy (the pretraining variant has
    extra scale-32 blocks and fc head parameters with no counterpart here).
    Returns the number of tensors copied."""
    pre = load_npz_tree(npz_path)
    own = state_dict_to_flax(model.state_dict())
    grafted = {}
    for name, arr in own.items():
        coll, *path = name.split("/")
        if coll not in pre or not path or path[0] != "backbone":
            continue
        node = pre[coll]
        for p in path[1:]:
            node = node.get(p) if isinstance(node, dict) else None
            if node is None:
                break
        if node is not None and not isinstance(node, dict) and np.shape(node) == arr.shape:
            grafted[name] = np.asarray(node, np.float32)
    with torch.no_grad():
        sd = model.state_dict()
        for key, t in flax_to_state_dict(grafted).items():
            sd[key].copy_(t)
    return len(grafted)
