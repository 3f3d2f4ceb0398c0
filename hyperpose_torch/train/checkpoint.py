"""Checkpoint / resume and npz weight export of the PyTorch port.

A port of `hyperpose_tpu/train/checkpoint.py`: `CheckpointManager` keeps
the training state (parameters, BatchNorm statistics, optimizer state, step
and the discriminator's state) as one `torch.save` file per step under
`<model_dir>/ckpt`, the newest `max_to_keep` of them; the npz functions
read and write the JAX package's flat flax layout
(`params/<path>/kernel`, ..., `batch_stats/<path>/mean|var`), so the
port's `newest_model.npz` loads into the JAX model and JAX's into the port.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch
from torch import nn

from ..utils.weights import load_flax_weights, state_dict_to_flax

_CKPT = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """`<model_dir>/ckpt/<step>.pt`, the newest `max_to_keep` kept."""

    def __init__(self, model_dir: str, max_to_keep: int = 3):
        self.path = os.path.abspath(os.path.join(model_dir, "ckpt"))
        self.max_to_keep = max_to_keep
        os.makedirs(self.path, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.path)
                      if (m := _CKPT.match(f)))

    def save(self, step: int, state: dict[str, Any]) -> str:
        """Write `state` (tensors moved to the CPU) for `step` atomically,
        then drop all but the newest `max_to_keep` checkpoints."""
        path = os.path.join(self.path, f"{int(step)}.pt")
        tmp = path + ".tmp"
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.path, f"{old}.pt"))
        return path

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, map_location=None):
        """(step, state) of `step` (default the latest), or (None, None)
        when there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        state = torch.load(os.path.join(self.path, f"{int(step)}.pt"),
                           map_location=map_location, weights_only=True)
        return step, state


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_weights_npz(variables, path: str) -> None:
    """Write a module's (or a state_dict's) parameters and BatchNorm
    statistics as the JAX package's flat npz (reference: npz_dict save,
    Model/train.py:318-319)."""
    if isinstance(variables, nn.Module):
        variables = variables.state_dict()
    np.savez(path, **state_dict_to_flax(variables))


def load_npz_tree(path: str) -> dict:
    """The nested dict a flat npz came from (no template needed; used by
    tolerant partial loads like the pretrained-backbone graft)."""
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            *parts, leaf = name.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = data[name]
    return tree


def load_weights_npz(model: nn.Module, path: str) -> nn.Module:
    """Load a flat npz written by either package's `save_weights_npz` into
    `model`: every weight must match a parameter or statistic of the model
    in name and shape, and fill all of them."""
    return load_flax_weights(model, path)

