"""PoseProposal in PyTorch.

Counterpart of `hyperpose_tpu/models/pose_proposal.py` `PoseProposal` and
its `restore_coor` (reference: hyperpose/Model/pose_proposal/model.py:37-119),
and of the PoseProposal branch of `hyperpose_tpu/models/__init__.py`
`_fused_decode_for` (`ppn_fused_decode`). The loss waits for the training
slice.

Like the flax module, the network takes NHWC images and returns, after a
float32 sigmoid, the grid maps c, i, x, y, w, h as NHWC [B, hout, wout, K]
and the limb edge tensor e as [B, L, hnei, wnei, hout, wout]. Every output
is a view of the head's one [B, 6K + L*hnei*wnei, hout, wout] tensor: the
head's channel l*hnei*wnei + dy*wnei + dx is e[:, l, dy, dx], so neither
the NCHW nor the channels-last head output is copied.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.ppn_decode import PpnDecoderConfig, ppn_decode_batch
from ..utils.topology import PPN_TOPOLOGY, Topology, instance_part_idx
from .backbones import ConvBN, Resnet18


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, 0.1)


class PoseProposal(nn.Module):
    """The backbone at stride 32 (ResNet18 by default) -> two 3x3
    ConvBN(512) with bias and leaky ReLU (slope 0.1) -> a 1x1 head with
    bias -> sigmoid in float32. `backbone` is a class built as
    `backbone(scale_size=32, dtype=dtype)`, as the flax module builds it.
    `hin` and `win` are the input size `restore_coor` scales to, as in the
    flax module; `dtype` is the compute and parameter type."""

    def __init__(self, K: int = 18, L: int = 17, hnei: int = 9, wnei: int = 9,
                 hin: int = 384, win: int = 384,
                 backbone: Callable[..., nn.Module] = Resnet18,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.K, self.L, self.hnei, self.wnei = K, L, hnei, wnei
        self.hin, self.win, self.dtype = hin, win, dtype
        self.backbone = backbone(scale_size=32, dtype=dtype)
        c = self.backbone.out_channels
        self.add1 = ConvBN(c, 512, dtype, act=_leaky_relu, bias=True)
        self.add2 = ConvBN(512, 512, dtype, act=_leaky_relu, bias=True)
        self.head = nn.Conv2d(512, 6 * K + hnei * wnei * L, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> dict:
        """x: NHWC images [B, H, W, 3]. Returns the flax module's dict of
        float32 views (see the module docstring)."""
        y = self.add2(self.add1(self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))))
        y = torch.sigmoid(self.head(y).to(torch.float32))
        k = self.K
        maps = y.permute(0, 2, 3, 1)
        out = {name: maps[..., i * k:(i + 1) * k] for i, name in enumerate("cixywh")}
        out["e"] = y[:, 6 * k:].unflatten(1, (self.L, self.hnei, self.wnei))
        return out

    def restore_coor(self, x, y, w, h, hout: int, wout: int):
        """Cell-relative -> input-pixel coordinates on NHWC [B, hout, wout, K]
        maps: (x + gx) * (win / wout), the scale formed in Python and
        applied in float32 as the flax module does."""
        gsx = self.win / wout
        gsy = self.hin / hout
        gx = torch.arange(wout, dtype=torch.float32, device=x.device).reshape(1, 1, wout, 1)
        gy = torch.arange(hout, dtype=torch.float32, device=x.device).reshape(1, hout, 1, 1)
        return (x + gx) * gsx, (y + gy) * gsy, w * self.win, h * self.hin


def ppn_fused_decode(model: PoseProposal, cfg: PpnDecoderConfig | None = None,
                     topology: Topology = PPN_TOPOLOGY):
    """The step `PoseEngine(..., fused_decode=...)` runs for PoseProposal:
    uint8 images [B, H, W, 3] -> /255 in the model dtype -> `model` ->
    `restore_coor` -> `ppn_decode_batch` -> DecodedSkeletons, on the images'
    device.

    The decode takes `cfg`, by default `PpnDecoderConfig` with
    `instance_part` from `topology` (the facade passes the thresholds of
    `Config.set_ppn_decoder`), and the model's own `hnei` / `wnei` and input
    size (`hin`, `win`), the values `restore_coor` and the head were built
    with. Puts `model` in eval mode. The step's `decode(outputs)` is its
    part after the network (`restore_coor`, then the decode), `body` the
    step outside inference mode (what `torch.export` traces), and
    `rebuild(other_model)` makes the same step on another model object (the
    int8 clone `quant.quantize_engine` makes)."""
    model.eval()
    if cfg is None:
        cfg = PpnDecoderConfig(instance_part=instance_part_idx(topology))

    def decode(out: dict):
        hout, wout = out["c"].shape[1:3]
        rx, ry, rw, rh = model.restore_coor(out["x"], out["y"], out["w"], out["h"], hout, wout)
        pred = {"c": out["c"], "i": out["i"], "x": rx, "y": ry, "w": rw, "h": rh,
                "e": out["e"]}
        return ppn_decode_batch(pred, cfg, model.hnei, model.wnei, (model.hin, model.win),
                                topology)

    def body(images_u8: torch.Tensor):
        return decode(model(images_u8.to(model.dtype) / 255.0))

    fused = torch.inference_mode()(body)
    fused.body = body
    fused.decode = decode
    fused.rebuild = lambda other: ppn_fused_decode(other, cfg, topology)
    return fused
