"""Geometric training augmentation.

Replaces the reference's TensorLayer-based affine pipeline
(reference: hyperpose/Model/augmentor.py:16-69 BasicAugmentor — rotate
(-30, 30) degrees, zoom, random center offset, optional horizontal keypoint
flip via the per-dataset flip list, resize-crop to hin x win; image,
keypoints and don't-care mask all follow the same transform) with a single
composed 2x3 affine applied once by cv2.warpAffine.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Sentinel for absent keypoint coordinates (large negative so any
# grid/Gaussian math pushes them far out of range).
MISSING = -1000.0


@dataclasses.dataclass
class AugmentResult:
    image: np.ndarray   # [hin, win, 3] uint8
    kpts: np.ndarray    # [M, P, 2] float32, MISSING where invalid
    valid: np.ndarray   # [M, P] bool
    mask: np.ndarray    # [hin, win] float32 don't-care weights in [0, 1]


class BasicAugmentor:
    """Affine rotate + zoom + shift + flip + crop, keypoint-consistent.

    One transform matrix maps source-image pixels to the (hin, win) output;
    keypoints are mapped by the same matrix and invalidated when they leave
    the frame; the loss mask is warped with zero border so regions with no
    source pixels contribute no loss.
    """

    def __init__(
        self, hin: int, win: int, flip_list: np.ndarray | None = None,
        rotate_range: tuple[float, float] = (-30.0, 30.0),
        zoom_range: tuple[float, float] = (0.6, 0.95),
        shift_frac: float = 0.1, flip_prob: float = 0.5,
        rng: np.random.Generator | None = None,
    ):
        self.hin = int(hin)
        self.win = int(win)
        self.flip_list = (
            np.asarray(flip_list, np.int32) if flip_list is not None else None
        )
        self.rotate_range = rotate_range
        self.zoom_range = zoom_range
        self.shift_frac = shift_frac
        self.flip_prob = flip_prob
        self.rng = rng if rng is not None else np.random.default_rng()

    def spawn(self, seed: int) -> "BasicAugmentor":
        """An independent clone for a worker thread (numpy Generators are
        not safe to share across threads)."""
        return BasicAugmentor(
            self.hin, self.win, self.flip_list, self.rotate_range,
            self.zoom_range, self.shift_frac, self.flip_prob,
            np.random.default_rng(seed),
        )

    # -- transform sampling --------------------------------------------------

    def _sample_matrix(self, h: int, w: int) -> np.ndarray:
        """Source->target 2x3 affine: scale-to-fit * zoom, rotate about the
        image center, random center shift."""
        import cv2

        rng = self.rng
        theta = rng.uniform(*self.rotate_range)
        base = max(self.hin / h, self.win / w)
        zoom = rng.uniform(*self.zoom_range) * base
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), theta, zoom)
        # Recenter source center onto the output center, plus a random shift.
        dx = rng.uniform(-self.shift_frac, self.shift_frac) * self.win
        dy = rng.uniform(-self.shift_frac, self.shift_frac) * self.hin
        m[0, 2] += self.win / 2.0 - w / 2.0 + dx
        m[1, 2] += self.hin / 2.0 - h / 2.0 + dy
        return m

    @staticmethod
    def _apply_to_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
        return pts @ m[:, :2].T + m[:, 2]

    # -- public API -----------------------------------------------------------

    def process(
        self, image: np.ndarray, kpts: np.ndarray, valid: np.ndarray,
        mask: np.ndarray | None = None,
    ) -> AugmentResult:
        import cv2

        h, w = image.shape[:2]
        m = self._sample_matrix(h, w)
        out_img = cv2.warpAffine(
            image, m, (self.win, self.hin), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
        src_mask = (
            mask.astype(np.float32) if mask is not None
            else np.ones((h, w), np.float32)
        )
        out_mask = cv2.warpAffine(
            src_mask, m, (self.win, self.hin), flags=cv2.INTER_NEAREST,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )

        kpts = np.asarray(kpts, np.float32)
        valid = np.asarray(valid, bool)
        n_people, n_parts = kpts.shape[:2]
        new_kpts = self._apply_to_points(
            m, kpts.reshape(-1, 2)
        ).reshape(n_people, n_parts, 2)
        new_valid = (
            valid
            & (new_kpts[..., 0] >= 0) & (new_kpts[..., 0] < self.win)
            & (new_kpts[..., 1] >= 0) & (new_kpts[..., 1] < self.hin)
        )

        if self.flip_list is not None and self.rng.random() < self.flip_prob:
            out_img = np.ascontiguousarray(out_img[:, ::-1])
            out_mask = np.ascontiguousarray(out_mask[:, ::-1])
            new_kpts[..., 0] = self.win - 1 - new_kpts[..., 0]
            new_kpts = new_kpts[:, self.flip_list]
            new_valid = new_valid[:, self.flip_list]

        new_kpts = np.where(new_valid[..., None], new_kpts, MISSING)
        return AugmentResult(
            image=out_img, kpts=new_kpts.astype(np.float32),
            valid=new_valid, mask=out_mask,
        )

    def process_only_image(self, image: np.ndarray) -> np.ndarray:
        """Augment an image with no annotations (domain-adaptation unlabeled
        stream, reference: Model/train.py:292-295)."""
        import cv2

        h, w = image.shape[:2]
        m = self._sample_matrix(h, w)
        return cv2.warpAffine(
            image, m, (self.win, self.hin), flags=cv2.INTER_LINEAR,
            borderMode=cv2.BORDER_CONSTANT, borderValue=0,
        )
