"""The pretrained-backbone graft of the PyTorch port.

Only `load_pretrained_backbone` of `hyperpose_tpu/train/pretrain.py` is
ported: `Trainer.init_state` calls it. ImageNet pretraining itself
(`single_pretrain`, the dataset and the backbones' classifier heads) is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.weights import flax_to_state_dict, state_dict_to_flax
from .checkpoint import load_npz_tree


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
