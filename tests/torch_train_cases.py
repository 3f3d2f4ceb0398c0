"""Seeded inputs shared by the port's training parity tests
(tests/test_torch_{targets,losses,train}.py): keypoint arrays with every case
the target generators treat apart, and the configs of both packages.
"""
from __future__ import annotations

import numpy as np

MISSING = -1000.0   # data/augment.py MISSING, in both packages


def random_people(seed: int, b: int, m: int, p: int, hw: tuple[int, int]):
    """(kpts [b, m, p, 2] float32, valid [b, m, p] bool) in input pixels,
    uniform over the image, with: invalid keypoints, half of them at the
    MISSING sentinel and half left where they were; a person with no
    keypoint (all MISSING) in every image; two people whose keypoints share
    cells (the second is the first shifted by under a pixel); keypoints on
    the image's edges (x or y at 0, just inside the far edge, on the far
    edge itself, which lies outside the last cell) and one just outside
    (negative)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    kpts = np.stack([rng.uniform(0, w, (b, m, p)), rng.uniform(0, h, (b, m, p))], -1)
    kpts = kpts.astype(np.float32)
    valid = rng.random((b, m, p)) > 0.25
    if m >= 3:
        kpts[:, 1] = kpts[:, 0] + rng.uniform(-0.4, 0.4, (b, p, 2)).astype(np.float32)
        valid[:, 1] = valid[:, 0]
    kpts[0, 0, :5] = [(0.0, 0.0), (w - 1e-3, h - 1e-3), (w, h / 2), (w / 2, h), (-0.5, 3.0)]
    valid[0, 0, :5] = True
    drop = ~valid & (rng.random((b, m, p)) < 0.5)
    kpts[drop] = MISSING
    kpts[:, m - 1] = MISSING
    valid[:, m - 1] = False
    return kpts, valid


def bbxs_of(kpts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[b, m, 4] (x0, y0, w, h) boxes of the valid keypoints, as the
    training pipeline derives them."""
    from hyperpose_torch.data.base import derive_bbxs

    return np.stack([derive_bbxs(k, v) for k, v in zip(kpts, valid)]).astype(np.float32)


def crowd_mask(b: int, out_hw: tuple[int, int]) -> np.ndarray:
    """[b, h, w, 1] don't-care mask: 1 but for a block in each image."""
    h, w = out_hw
    mask = np.ones((b, h, w, 1), np.float32)
    for i in range(b):
        mask[i, i % h: i % h + 2, 1:3] = 0.0
    return mask
