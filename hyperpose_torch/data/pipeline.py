"""Host-side training input pipeline of the PyTorch port.

A copy of `hyperpose_tpu/data/pipeline.py` with the same names and
behaviour. It replaces the reference's tf.data generator + py_function
worker stack (reference: hyperpose/Model/train.py:53-70,142-150 —
shuffle(4096), py_function(augment+preprocess), batch, prefetch) with a
plain thread pool feeding a bounded queue. Target-map generation is NOT done
here — it runs on the device inside the training step (data.targets) — so
the host only decodes JPEGs, augments, and packs fixed-shape uint8/keypoint
batches. OpenCV is imported by the workers, not with the module.
"""
from __future__ import annotations

import logging
import queue
import threading

import numpy as np

from .augment import MISSING, BasicAugmentor
from .base import TrainRecord, derive_bbxs

logger = logging.getLogger("hyperpose_torch.DATA")


class TrainPipeline:
    """Iterable of fixed-shape training batches.

    Yields dicts:
      images [B, hin, win, 3] uint8
      kpts   [B, max_people, n_parts, 2] float32 (MISSING where absent)
      valid  [B, max_people, n_parts] bool
      mask   [B, hout, wout, 1] float32 don't-care weights
      bbxs   [B, max_people, 4] float32 (x0, y0, w, h) in augmented pixels
    """

    def __init__(
        self, records: list[TrainRecord], augmentor: BasicAugmentor,
        batch_size: int, out_hw: tuple[int, int], max_people: int = 8,
        n_parts: int | None = None, n_workers: int = 4,
        loop: bool = True, shuffle: bool = True, seed: int = 0,
        prefetch: int = 4,
    ):
        if not records:
            raise ValueError("TrainPipeline needs at least one record")
        self.records = records
        self.augmentor = augmentor
        self.batch_size = int(batch_size)
        self.out_hw = tuple(out_hw)
        self.max_people = int(max_people)
        self.n_parts = int(
            n_parts if n_parts is not None else records[0].kpts.shape[1]
        )
        self.n_workers = max(int(n_workers), 1)
        self.loop = loop
        self.shuffle = shuffle
        self.seed = seed
        self._sample_q: queue.Queue = queue.Queue(
            maxsize=max(prefetch * self.batch_size, self.batch_size)
        )
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._epoch_lock = threading.Lock()
        self._order: list[int] = []
        self._cursor = 0
        self._exhausted = False
        self._inflight = 0

    # -- index feeding ---------------------------------------------------------

    def _next_index(self) -> int | None:
        """Thread-safe draw of the next record index (None = exhausted)."""
        with self._epoch_lock:
            if self._cursor >= len(self._order):
                if self._order and not self.loop:
                    self._exhausted = True
                    return None
                self._epoch = getattr(self, "_epoch", -1) + 1
                rng = np.random.default_rng(self.seed + self._epoch)
                order = np.arange(len(self.records))
                if self.shuffle:
                    rng.shuffle(order)
                self._order = order.tolist()
                self._cursor = 0
            idx = self._order[self._cursor]
            self._cursor += 1
            self._inflight += 1
            return idx

    # -- workers ----------------------------------------------------------------

    def _load_sample(self, rec: TrainRecord, aug: BasicAugmentor):
        import cv2

        img = cv2.imread(rec.image_path)
        if img is None:
            logger.warning("unreadable image %s", rec.image_path)
            return None
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        mask = rec.mask_fn() if rec.mask_fn is not None else None
        out = aug.process(img, rec.kpts, rec.valid, mask=mask)
        return out

    def _pack(self, out) -> dict[str, np.ndarray]:
        import cv2

        mp, np_ = self.max_people, self.n_parts
        kpts = np.full((mp, np_, 2), MISSING, np.float32)
        valid = np.zeros((mp, np_), bool)
        m = min(out.kpts.shape[0], mp)
        p = min(out.kpts.shape[1], np_)
        kpts[:m, :p] = out.kpts[:m, :p]
        valid[:m, :p] = out.valid[:m, :p]
        bbxs = np.zeros((mp, 4), np.float32)
        bbxs[:m] = derive_bbxs(kpts[:m], valid[:m])
        hout, wout = self.out_hw
        mask_small = cv2.resize(
            out.mask, (wout, hout), interpolation=cv2.INTER_AREA
        ).astype(np.float32)[..., None]
        return {
            "images": out.image, "kpts": kpts, "valid": valid,
            "mask": mask_small, "bbxs": bbxs,
        }

    def _worker(self, wid: int):
        aug = self.augmentor.spawn(self.seed * 1000 + wid)
        while not self._stop.is_set():
            idx = self._next_index()
            if idx is None:
                return
            sample = None
            try:
                out = self._load_sample(self.records[idx], aug)
                if out is not None:
                    sample = self._pack(out)
            except Exception as exc:  # one bad record must not kill training
                logger.warning("record %d failed: %s", idx, exc)
            if sample is None:
                with self._epoch_lock:
                    self._inflight -= 1
                continue
            while not self._stop.is_set():
                try:
                    self._sample_q.put(sample, timeout=0.2)
                    break
                except queue.Full:
                    continue
            with self._epoch_lock:
                self._inflight -= 1

    def _start(self):
        if self._started:
            return
        self._started = True
        for wid in range(self.n_workers):
            t = threading.Thread(
                target=self._worker, args=(wid,), daemon=True,
                name=f"train-pipeline-{wid}",
            )
            t.start()
            self._threads.append(t)

    # -- iteration ---------------------------------------------------------------

    def __iter__(self):
        self._start()
        while True:
            batch_samples = []
            while len(batch_samples) < self.batch_size:
                try:
                    batch_samples.append(self._sample_q.get(timeout=0.2))
                except queue.Empty:
                    if self._stop.is_set():
                        return
                    with self._epoch_lock:
                        done = (
                            self._exhausted
                            and self._inflight == 0
                            and self._sample_q.empty()
                        )
                    if done:
                        return
            yield {
                key: np.stack([s[key] for s in batch_samples])
                for key in batch_samples[0]
            }

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()
