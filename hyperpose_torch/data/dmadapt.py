"""Unlabeled-image dataset for domain-adaptation training (the PyTorch
port's copy of `hyperpose_tpu/data/dmadapt.py`).

(reference: hyperpose/Dataset/dmadapt_dataset.py:5-19 Domainadapt_dataset —
a bare image-path generator feeding the adversarial discriminator stream,
Model/train.py:292-295.)
"""
from __future__ import annotations

import logging
import queue
import threading

import numpy as np

logger = logging.getLogger("hyperpose_torch.DATA")


class DomainAdaptDataset:
    """Iterates augmented unlabeled images as uint8 [B, hin, win, 3] batches."""

    def __init__(self, image_paths: list[str]):
        if not image_paths:
            raise ValueError("DomainAdaptDataset needs image paths")
        self.image_paths = list(image_paths)

    def batches(self, augmentor, batch_size: int, seed: int = 0):
        """Endless generator of augmented unlabeled batches."""
        import cv2

        rng = np.random.default_rng(seed)
        aug = augmentor.spawn(seed + 17)
        buf = []
        while True:
            for idx in rng.permutation(len(self.image_paths)):
                img = cv2.imread(self.image_paths[idx])
                if img is None:
                    continue
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                buf.append(aug.process_only_image(img))
                if len(buf) == batch_size:
                    yield np.stack(buf)
                    buf = []


class PrefetchingLoader:
    """Background-thread wrapper that keeps `depth` batches ready."""

    def __init__(self, generator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            for item in generator:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        while not self._stop.is_set():
            yield self._q.get()

    def stop(self):
        self._stop.set()
