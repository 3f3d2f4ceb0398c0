"""Weights the benchmark makes from `--seed` (or reads from a committed
checkpoint), in the flat flax layout that both the port and the reference
take. Seeded weights are drawn on the device in two large calls."""
from __future__ import annotations

import math
import os

import numpy as np
import torch


def _generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


# The mean of a^2 for a PReLU slope a uniform in [0.05, 0.5].
_SLOPE_SQ = (0.5 ** 3 - 0.05 ** 3) / (3 * 0.45)


def seeded_serving_weights(shapes: dict, seed: int, device) -> dict:
    """Random weights for a model served without a checkpoint, which keep
    the activations' scale through any depth: conv kernels normal with std
    sqrt(2 / ((1 + E[a^2]) x fan_in)), a the slope of the PReLU after the conv
    (0 for a ReLU), so that each layer passes its input's variance on; BN
    scales and variances uniform in [0.5, 1.5], PReLU slopes uniform in
    [0.05, 0.5], biases and BN means 0.1 x normal. Float32 tensors on
    `device`, keyed by flax path."""
    g = _generator(seed, device, 0)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    normal = torch.randn(sum(sizes.values()), generator=g, device=device)
    uniform = torch.rand(sum(sizes.values()), generator=g, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        n, leaf = sizes[k], k.rsplit("/", 1)[1]
        nrm, uni = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if leaf == "kernel":
            prelu = k.rsplit("/", 2)[0] + "/prelu/alpha" in shapes
            gain = 2.0 / (1.0 + (_SLOPE_SQ if prelu else 0.0))
            out[k] = nrm * math.sqrt(gain / math.prod(shape[:-1]))
        elif leaf in ("scale", "var"):
            out[k] = 0.5 + uni
        elif leaf == "alpha":
            out[k] = 0.05 + 0.45 * uni
        else:
            out[k] = 0.1 * nrm
    return out


def checkpoint_weights(path: str, root: str) -> dict:
    """A committed flat flax npz, relative to the checkout's root, as numpy."""
    with np.load(os.path.join(root, path)) as data:
        return {k: data[k] for k in data.files}


def make_weights(spec: dict, shapes: dict, seed: int, device, root: str) -> dict:
    """The weights a configuration's `weights` entry names: {"checkpoint":
    path} or {"seeded": "serving", "raised_biases": [...]}. Returns numpy
    float32 arrays keyed by flax path."""
    if "checkpoint" in spec:
        return checkpoint_weights(spec["checkpoint"], root)
    if spec["seeded"] != "serving":
        raise ValueError(f"unknown seeded weights {spec['seeded']!r}")
    weights = seeded_serving_weights(shapes, seed, device)
    for leaf in spec.get("raised_biases", ()):
        weights[f"params/{leaf}"] = weights[f"params/{leaf}"] + 1.0
    names = list(weights)
    flat = torch.cat([weights[k].reshape(-1) for k in names]).cpu().numpy()
    out, at = {}, 0
    for k in names:
        n = weights[k].numel()
        out[k] = flat[at:at + n].reshape(tuple(weights[k].shape))
        at += n
    return out
