"""Domain-adaptation discriminator of the PyTorch port.

A port of `hyperpose_tpu/train/domainadapt.py` `Discriminator`,
`bce_logits`, `discriminator_losses` and `UnlabeledPipeline` (reference:
hyperpose/Model/domainadapt.py:12-51 Discriminator and the adversarial g/d
losses wired into the train loop at Model/train.py:230-262). The trainer's
step that uses them is `Trainer.dmadapt_step` (`train/trainer.py`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbones import same_pads

_PLAN = ((512, 1), (256, 2), (128, 2), (64, 2), (32, 2))


class Discriminator(nn.Module):
    """5 SAME 3x3 convs with bias (`conv0` .. `conv4`: 512, 256/2, 128/2,
    64/2, 32/2) + 3 dense layers (`fc1` 128, `fc2` 32, `fc3` 1), leaky ReLU
    0.2 between them, over NHWC backbone features [B, H, W, C] -> one
    real/fake logit per image [B], in its parameters' dtype (float32, as
    the flax module's default).

    The conv output is flattened in NHWC order before `fc1`, as flax
    flattens it, so a flax Dense kernel carries across through the weight
    bridge. `in_channels` and `feat_hw` (the features' channels and H, W)
    size `fc1`, which flax infers at `init`."""

    def __init__(self, in_channels: int, feat_hw: tuple[int, int]):
        super().__init__()
        h, w = feat_hw
        cin = in_channels
        self.strides = []
        for i, (f, s) in enumerate(_PLAN):
            self.add_module(f"conv{i}", nn.Conv2d(cin, f, 3, stride=s, padding=1 if s == 1 else 0))
            self.strides.append(s)
            cin, h, w = f, -(-h // s), -(-w // s)
        self.fc1 = nn.Linear(cin * h * w, 128)
        self.fc2 = nn.Linear(128, 32)
        self.fc3 = nn.Linear(32, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.permute(0, 3, 1, 2).to(self.fc1.weight.dtype)
        for i, s in enumerate(self.strides):
            if s > 1:
                x = F.pad(x, same_pads(x.shape[-2:], 3, s))
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.leaky_relu(self.fc1(x), 0.2)
        x = F.leaky_relu(self.fc2(x), 0.2)
        return self.fc3(x)[:, 0]


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of logits clipped to [-30, 30]."""
    z = torch.clamp(logits, -30, 30)
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * labels
                      + torch.log1p(torch.exp(-z.abs())))


def discriminator_losses(labeled_logits: torch.Tensor,
                         unlabeled_logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(g_loss, d_loss): the discriminator separates labeled (1) from
    unlabeled (0) backbone features; the generator (backbone) is pushed to
    make unlabeled features look labeled (reference: domainadapt.py
    cal_loss)."""
    d_loss = 0.5 * (bce_logits(labeled_logits, torch.ones_like(labeled_logits))
                    + bce_logits(unlabeled_logits, torch.zeros_like(unlabeled_logits)))
    g_loss = bce_logits(unlabeled_logits, torch.ones_like(unlabeled_logits))
    return g_loss, d_loss


class UnlabeledPipeline:
    """Background loader of augmented unlabeled image batches, uint8
    [B, hin, win, 3] (reference: Dataset/dmadapt_dataset.py +
    train.py:292-295). `next()` blocks for a batch; `stop()` ends the
    workers."""

    def __init__(self, image_paths, augmentor, batch_size: int,
                 n_workers: int = 1, prefetch: int = 2, seed: int = 0):
        import queue
        import threading

        import numpy as np

        self.paths = list(image_paths)
        self.augmentor = augmentor
        self.batch_size = batch_size
        self._q = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()

        def worker(wid):
            import cv2

            rng = np.random.default_rng(seed + wid)
            while not self._stop.is_set():
                batch = np.zeros((batch_size, augmentor.hin, augmentor.win, 3), np.uint8)
                count = 0
                while count < batch_size and not self._stop.is_set():
                    path = self.paths[int(rng.integers(len(self.paths)))]
                    img = cv2.imread(path)
                    if img is None:
                        continue
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                    self.augmentor.rng = rng
                    batch[count] = self.augmentor.process_only_image(img)
                    count += 1
                try:
                    self._q.put(batch, timeout=1.0)
                except queue.Full:
                    continue

        for wid in range(n_workers):
            threading.Thread(target=worker, args=(wid,), daemon=True).start()

    def next(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
