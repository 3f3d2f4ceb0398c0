"""Lightweight OpenPose in PyTorch.

Counterpart of `hyperpose_tpu/models/openpose.py` `LightWeightOpenPose`
(reference: hyperpose/Model/openpose/model/lw_openpose.py:12-198). The
network runs NCHW inside (channels-last memory is fine) and, like the flax
module, takes NHWC images and returns NHWC maps, so the decoder sees the
layout `paf_decode_batch` expects.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .backbones import ConvBN, MobilenetDilated

N_CONFMAPS = 19   # 18 COCO parts + background
N_PAFMAPS = 38    # x and y for each of the 19 limbs
N_CHANNELS = 128


def _conv(cin: int, cout: int, k: int, dtype: torch.dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=dtype)


class _LwConvBlock(nn.Module):
    """conv3x3 + BN(relu) (reference: lw_openpose.py:193-198 conv_block)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.cb = ConvBN(cin, features, dtype=dtype)

    def forward(self, x):
        return self.cb(x)


class _LwCpm(nn.Module):
    """1x1 conv + residual tower + end conv (reference: lw_openpose.py:106-121)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.init = _conv(cin, features, 1, dtype)
        self.m0 = _LwConvBlock(features, features, dtype)
        self.m1 = _LwConvBlock(features, features, dtype)
        self.m2 = _LwConvBlock(features, features, dtype)
        self.end = _conv(features, features, 3, dtype)

    def forward(self, x):
        x = torch.relu(self.init(x))
        y = self.m2(self.m1(self.m0(x)))
        return torch.relu(self.end(x + y))


class _LwHeads(nn.Module):
    """conf/paf heads: 1x1 conv(512, relu) + 1x1 conv(out)
    (reference: lw_openpose.py:129-141)."""

    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        self.conf1 = _conv(cin, 512, 1, dtype)
        self.conf2 = _conv(512, N_CONFMAPS, 1, dtype)
        self.paf1 = _conv(cin, 512, 1, dtype)
        self.paf2 = _conv(512, N_PAFMAPS, 1, dtype)

    def forward(self, x):
        conf = self.conf2(torch.relu(self.conf1(x)))
        paf = self.paf2(torch.relu(self.paf1(x)))
        return conf, paf


class _LwRefineBlock(nn.Module):
    """1x1 conv + 2 conv-BN blocks with residual
    (reference: lw_openpose.py:180-191 Refinement_block)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.init = _conv(cin, features, 1, dtype)
        self.c1 = _LwConvBlock(features, features, dtype)
        self.c2 = _LwConvBlock(features, features, dtype)

    def forward(self, x):
        x = torch.relu(self.init(x))
        return x + self.c2(self.c1(x))


class LightWeightOpenPose(nn.Module):
    """Lightweight OpenPose: backbone + cpm + init stage + 1 refinement stage.

    `dtype` is the compute and parameter type: float32 for parity with the
    JAX package, bfloat16 for serving. The backbone defaults to
    `MobilenetDilated`, as the flax module's does; the committed flagship
    checkpoint is `backbone=VggTiny` (or one of its serving forms)."""

    def __init__(self, backbone: Callable[..., nn.Module] = MobilenetDilated,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = backbone(dtype=dtype)
        c = N_CHANNELS
        self.cpm = _LwCpm(self.backbone.out_channels, c, dtype)
        self.init_m0 = _conv(c, c, 3, dtype)
        self.init_m1 = _conv(c, c, 3, dtype)
        self.init_m2 = _conv(c, c, 3, dtype)
        self.init_heads = _LwHeads(c, dtype)
        cin = c + N_CONFMAPS + N_PAFMAPS
        for i in range(5):
            self.add_module(f"ref_b{i}", _LwRefineBlock(cin, c, dtype))
            cin = c
        self.ref_heads = _LwHeads(c, dtype)

    def forward(self, x: torch.Tensor) -> dict:
        """x: NHWC images [B, H, W, 3]. Returns NHWC `conf_map`
        [B, H/8, W/8, 19] and `paf_map` [B, H/8, W/8, 38],
        plus the per-stage maps, as the flax module's dict."""
        bf = self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))
        feats = self.cpm(bf)
        y = torch.relu(self.init_m0(feats))
        y = torch.relu(self.init_m1(y))
        y = torch.relu(self.init_m2(y))
        conf0, paf0 = self.init_heads(y)
        z = torch.cat([feats, conf0, paf0], dim=1)
        for i in range(5):
            z = getattr(self, f"ref_b{i}")(z)
        conf1, paf1 = self.ref_heads(z)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return {
            "conf_map": nhwc(conf1), "paf_map": nhwc(paf1),
            "stage_confs": [nhwc(conf0), nhwc(conf1)],
            "stage_pafs": [nhwc(paf0), nhwc(paf1)],
        }
