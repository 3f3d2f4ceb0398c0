"""PifPaf (composite fields) in PyTorch.

Counterpart of `hyperpose_tpu/models/pifpaf.py` `pixel_shuffle_nhwc` and
`Pifpaf` (reference: hyperpose/Model/pifpaf/model.py), and of the PifPaf
branch of `hyperpose_tpu/models/__init__.py` `_fused_decode_for`
(`pifpaf_fused_decode`). The losses wait for the training slice.

Like the flax module, the network takes NHWC images and returns raw
(pre-activation) NHWC fields:

  pif_conf  [B, H, W, P]     pif_vec  [B, H, W, P, 2]
  pif_bmin  [B, H, W, P]     pif_scale [B, H, W, P]
  paf_*     the same with the L limb fields and src/dst pairs.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.pifpaf_decode import PifPafDecoderConfig, pifpaf_decode_batch
from ..utils.topology import PIFPAF_TOPOLOGY, Topology
from .backbones import Resnet50

_MEAN = (0.485, 0.456, 0.406)   # ImageNet (reference: model.py:38-39)
_STD = (0.229, 0.224, 0.225)


def pixel_shuffle_nhwc(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """[B, H, W, C*s^2] -> [B, H*s, W*s, C] with the channels split as
    [s_y, s_x, C] (reference: pifpaf/utils.py:371-379). `nn.PixelShuffle`
    on NCHW splits them as [C, s_y, s_x], which is another layout."""
    b, h, w, c = x.shape
    oc = c // (scale * scale)
    x = x.reshape(b, h, w, scale, scale, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * scale, w * scale, oc)


class Pifpaf(nn.Module):
    """ImageNet normalization (in the model dtype) -> the stride-16 ResNet50
    trunk -> 1x1 heads with bias -> 2x pixel shuffle in float32, so the
    fields come out at stride 8. `backbone`, a class, replaces the trunk
    with `backbone(scale_size=32, dtype=dtype)`, as the flax module does
    (its fields then come out at half that backbone's stride). `hin` and
    `win` are the flax module's fields (the input size of the training
    targets); the forward does not read them. `dtype` is the compute and
    parameter type."""

    def __init__(self, n_pos: int = 17, n_limbs: int = 19, hin: int = 368, win: int = 432,
                 quad_size: int = 2, backbone: Callable[..., nn.Module] | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_pos, self.n_limbs, self.quad_size = n_pos, n_limbs, quad_size
        self.hin, self.win, self.dtype = hin, win, dtype
        if backbone is None:
            self.backbone = Resnet50(scale_size=32, use_pool=False, dtype=dtype)
        else:
            self.backbone = backbone(scale_size=32, dtype=dtype)
        q2 = quad_size ** 2
        c = self.backbone.out_channels
        self.pif_head = nn.Conv2d(c, n_pos * 5 * q2, 1, dtype=dtype)
        self.paf_head = nn.Conv2d(c, n_limbs * 9 * q2, 1, dtype=dtype)
        self.register_buffer("mean", torch.tensor(_MEAN, dtype=dtype),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD, dtype=dtype),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> dict:
        """x: NHWC images [B, H, W, 3] in 0..1. Returns the raw field dict
        of the flax module (float32)."""
        x = (x.to(self.dtype) - self.mean) / self.std
        bf = self.backbone(x.permute(0, 3, 1, 2))

        def fields(head, n, k):
            y = head(bf).permute(0, 2, 3, 1).to(torch.float32)
            y = pixel_shuffle_nhwc(y, self.quad_size)
            return y.reshape(*y.shape[:3], n, k)

        pif = fields(self.pif_head, self.n_pos, 5)
        paf = fields(self.paf_head, self.n_limbs, 9)
        return {
            "pif_conf": pif[..., 0],
            "pif_vec": pif[..., 1:3],
            "pif_bmin": pif[..., 3],
            "pif_scale": pif[..., 4],
            "paf_conf": paf[..., 0],
            "paf_src_vec": paf[..., 1:3],
            "paf_dst_vec": paf[..., 3:5],
            "paf_src_bmin": paf[..., 5],
            "paf_dst_bmin": paf[..., 6],
            "paf_src_scale": paf[..., 7],
            "paf_dst_scale": paf[..., 8],
        }


def pifpaf_fused_decode(
    model: Pifpaf,
    cfg: PifPafDecoderConfig = PifPafDecoderConfig(),
    stride: int | None = None,
    in_hw: tuple[int, int] | None = None,
    topology: Topology = PIFPAF_TOPOLOGY,
):
    """The step `PoseEngine(..., fused_decode=...)` runs for PifPaf:
    uint8 images [B, H, W, 3] -> /255 in the model dtype -> `model` ->
    `pifpaf_decode_batch` -> DecodedSkeletons, on the images' device.

    `stride` defaults to input height // field height and `in_hw` to the
    input size, as the JAX package derives them from its config
    (`get_postprocessor`: stride = hin // hout). Puts `model` in eval mode:
    the step is inference (BatchNorm on its running statistics). The step's
    `rebuild(other_model)` makes the same step on another model object (the
    int8 clone `quant.quantize_engine` makes); its `body` is the step
    outside inference mode (what `torch.export` traces)."""
    model.eval()

    def body(images_u8: torch.Tensor):
        out = model(images_u8.to(model.dtype) / 255.0)
        hw = in_hw or tuple(images_u8.shape[1:3])
        s = stride or hw[0] // out["pif_conf"].shape[1]
        return pifpaf_decode_batch(out, cfg, s, hw, topology)

    fused = torch.inference_mode()(body)
    fused.body = body
    fused.rebuild = lambda other: pifpaf_fused_decode(other, cfg, stride, in_hw, topology)
    return fused
