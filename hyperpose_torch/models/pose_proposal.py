"""PoseProposal in PyTorch.

Counterpart of `hyperpose_tpu/models/pose_proposal.py` `PoseProposal`, its
`restore_coor`, `_iou` and `pose_proposal_loss` (reference:
hyperpose/Model/pose_proposal/model.py:37-168), and of the PoseProposal
branch of `hyperpose_tpu/models/__init__.py` `_fused_decode_for`
(`ppn_fused_decode`).

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
    flax module; `dtype` is the compute and parameter type. `lmd_*` are the
    loss weights `pose_proposal_loss` reads (reference: config_ppn.py);
    `ret_backbone` adds the backbone's output, NHWC, as
    `backbone_features`."""

    def __init__(self, K: int = 18, L: int = 17, hnei: int = 9, wnei: int = 9,
                 hin: int = 384, win: int = 384,
                 backbone: Callable[..., nn.Module] = Resnet18,
                 dtype: torch.dtype = torch.float32, lmd_rsp: float = 0.25,
                 lmd_iou: float = 1.0, lmd_coor: float = 5.0, lmd_size: float = 5.0,
                 lmd_limb: float = 0.5, ret_backbone: bool = False):
        super().__init__()
        self.lmd_rsp, self.lmd_iou, self.lmd_coor = lmd_rsp, lmd_iou, lmd_coor
        self.lmd_size, self.lmd_limb, self.ret_backbone = lmd_size, lmd_limb, ret_backbone
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
        bf = self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))
        y = torch.sigmoid(self.head(self.add2(self.add1(bf))).to(torch.float32))
        k = self.K
        maps = y.permute(0, 2, 3, 1)
        out = {name: maps[..., i * k:(i + 1) * k] for i, name in enumerate("cixywh")}
        out["e"] = y[:, 6 * k:].unflatten(1, (self.L, self.hnei, self.wnei))
        if self.ret_backbone:
            out["backbone_features"] = bf.permute(0, 2, 3, 1)
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


def _iou(b1, b2):
    """IoU of center-format boxes (x, y, w, h) (reference: model.py cal_iou)."""
    x1, y1, w1, h1 = b1
    x2, y2, w2, h2 = b2
    ix = torch.relu(torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
                    - torch.maximum(x1 - w1 / 2, x2 - w2 / 2))
    iy = torch.relu(torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
                    - torch.maximum(y1 - h1 / 2, y2 - h2 / 2))
    inter = ix * iy
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-6)


def pose_proposal_loss(model: PoseProposal, predict: dict, target: dict,
                       eps: float = 1e-6) -> tuple[torch.Tensor, dict]:
    """(total, parts): the lambda-weighted squared errors of the response,
    IoU, coordinates, box sizes and limbs, each summed per image and
    averaged over the batch, with the ground truth's cell masks (reference:
    model.py:133-168 cal_loss). `target` is `data.targets.ppn_targets`'s."""
    pc, px, py = predict["c"], predict["x"], predict["y"]
    pw, ph, pi, pe = predict["w"], predict["h"], predict["i"], predict["e"]
    gc, gx, gy = target["c"], target["x"], target["y"]
    gw, gh, ge, gem = target["w"], target["h"], target["e"], target["e_mask"]

    hout, wout = gc.shape[1], gc.shape[2]
    ti = _iou(model.restore_coor(gx, gy, gw, gh, hout, wout),
              model.restore_coor(px, py, pw, ph, hout, wout))
    mask_point = torch.clamp_max(gc + torch.where(gc < 0.5, 1e-5, 0.0), 1.0)
    mask_edge = torch.clamp_max(gem + torch.where(gem < 0.5, 1e-5, 0.0), 1.0)
    half = torch.where(gc < 0.5, 0.5, 0.0)

    def msum(v):
        return v.sum(dim=tuple(range(1, v.ndim))).mean()

    def root(v):
        return torch.sqrt(v + eps)

    parts = {
        "loss_rsp": model.lmd_rsp * msum((gc - pc) ** 2),
        "loss_iou": model.lmd_iou * msum(gc * (ti - pi) ** 2),
        "loss_coor": model.lmd_coor * msum(
            mask_point * ((gx - px - half) ** 2 + (gy - py - half) ** 2)),
        "loss_size": model.lmd_size * msum(
            mask_point * ((root(gw) - root(pw)) ** 2 + (root(gh) - root(ph)) ** 2)),
        "loss_limb": model.lmd_limb * msum(mask_edge * (ge - pe) ** 2),
    }
    total = (parts["loss_rsp"] + parts["loss_iou"] + parts["loss_coor"] + parts["loss_size"]
             + parts["loss_limb"])
    return total, parts


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
