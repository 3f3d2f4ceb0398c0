"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX stays
on the CPU (tests/conftest.py) and the port runs with device="cpu".
"""
from __future__ import annotations

import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_NPZ = os.path.join(REPO, "weights", "flagship_tinyvgg.npz")
SYNTH_NPZ = os.path.join(
    REPO, "hyperpose_torch", "assets", "synth_000000001601.npz"
)  # the same frame, decoded, for machines without OpenCV
SYNTH_JPG = os.path.join(
    REPO, "data_synth_1600_tune1600_100", "train2017", "synth_000000001601.jpg"
)

# Tier-1 runs six workers on a few cores: keep each test single-threaded.
torch.set_num_threads(1)


def flagship_flat() -> dict[str, np.ndarray]:
    with np.load(FLAGSHIP_NPZ) as data:
        return {k: data[k] for k in data.files}


def nest(flat: dict[str, np.ndarray]) -> dict:
    """Flat "a/b/c" arrays -> the nested variables dict flax expects."""
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def random_flat(seed: int) -> dict[str, np.ndarray]:
    """Random weights with the flagship's keys and shapes: fan-in-scaled
    kernels, BN scales and variances near 1, small biases and means."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, ref in flagship_flat().items():
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(ref.shape[:3]))
            arr = rng.standard_normal(ref.shape) * np.sqrt(1.0 / fan_in)
        elif leaf in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, ref.shape)
        else:
            arr = 0.1 * rng.standard_normal(ref.shape)
        out[name] = arr.astype(np.float32)
    return out


def synth_frame_rgb() -> np.ndarray:
    """The committed synthetic frame, decoded as RGB uint8."""
    import cv2

    return np.ascontiguousarray(cv2.imread(SYNTH_JPG)[..., ::-1])


def _blob(size=9, sigma=1.5):
    r = size // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    return np.exp(-(xx**2 + yy**2) / (2 * sigma**2)).astype(np.float32)


def tie_maps() -> np.ndarray:
    """[1, 46, 54, 18] maps with exact ties: a flat plateau (part 0), two
    bit-identical blobs (part 1: the argmax rounds must take the lower
    pixel index first), two identical plateaus (part 2) and a blob on the
    right border (part 3: the reflect mode's clipped "x+1" neighbour is the
    next row's x = 0)."""
    conf = np.zeros((1, 46, 54, 18), np.float32)
    conf[0, 10:16, 10:16, 0] = 0.8
    b = _blob()
    conf[0, 5:14, 30:39, 1] = b
    conf[0, 25:34, 8:17, 1] = b
    conf[0, 30:34, 30:34, 2] = 0.6
    conf[0, 8:12, 40:44, 2] = 0.6
    conf[0, 16:25, 49:54, 3] = b[:, :5]
    return conf
