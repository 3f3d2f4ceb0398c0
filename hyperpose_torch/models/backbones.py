"""Backbones in PyTorch: the flagship's TinyVGG.

Counterpart of `hyperpose_tpu/models/backbones.py` `ConvBN` and `VggTiny`
(reference: hyperpose/Model/backbones.py:343-391). Modules run NCHW; the
submodule names follow the flax module names, so the flat weight layout maps
one to one (`utils/weights.py`).
"""
from __future__ import annotations

import torch
from torch import nn


class ConvBN(nn.Module):
    """3x3 stride-1 Conv2d (no bias) + BatchNorm + ReLU.

    flax `padding="SAME"` for this conv is `padding=1`; BN eps is the flax
    module's 1e-5."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 3, padding=1, bias=False,
                              dtype=dtype)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class VggTiny(nn.Module):
    """TinyVGG at scale 8: conv-BN stacks 32-64 / 128-128 / 200x3 / 384x2
    with 3 pools, on RGB input.

    flax `nn.max_pool((2,2), (2,2), padding="SAME")` pads at the end on odd
    sizes, which is `ceil_mode=True`."""

    out_channels = 384
    _CFG = (32, 64, "pool", 128, 128, "pool", 200, 200, 200, "pool", 384, 384)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self._plan = []
        c, i = 3, 0
        for item in self._CFG:
            if item == "pool":
                self._plan.append(None)
                continue
            name = f"block_{i}"
            self.add_module(name, ConvBN(c, item, dtype=dtype))
            self._plan.append(name)
            c, i = item, i + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._plan:
            if name is None:
                x = nn.functional.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                x = getattr(self, name)(x)
        return x
