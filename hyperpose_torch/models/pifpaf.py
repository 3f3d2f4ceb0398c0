"""PifPaf (composite fields) in PyTorch.

Counterpart of `hyperpose_tpu/models/pifpaf.py` `pixel_shuffle_nhwc`,
`Pifpaf` and its losses `soft_clamp`, `bce_loss`, `laplace_loss`,
`scale_loss` and `pifpaf_loss` (reference: hyperpose/Model/pifpaf/model.py),
and of the PifPaf branch of `hyperpose_tpu/models/__init__.py`
`_fused_decode_for` (`pifpaf_fused_decode`).

Like the flax module, the network takes NHWC images and returns raw
(pre-activation) NHWC fields:

  pif_conf  [B, H, W, P]     pif_vec  [B, H, W, P, 2]
  pif_bmin  [B, H, W, P]     pif_scale [B, H, W, P]
  paf_*     the same with the L limb fields and src/dst pairs.

(`pif_bmin` and the `paf_*_bmin` fields are the Laplace log-scales the
losses read.)
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
    parameter type. `ret_backbone` adds the trunk's output, NHWC, as
    `backbone_features` (the flax call argument; domain adaptation reads
    it)."""

    def __init__(self, n_pos: int = 17, n_limbs: int = 19, hin: int = 368, win: int = 432,
                 quad_size: int = 2, backbone: Callable[..., nn.Module] | None = None,
                 dtype: torch.dtype = torch.float32, ret_backbone: bool = False):
        super().__init__()
        self.ret_backbone = ret_backbone
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
        out = {
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
        if self.ret_backbone:
            out["backbone_features"] = bf.permute(0, 2, 3, 1)
        return out


def soft_clamp(x: torch.Tensor, max_value: float = 5.0) -> torch.Tensor:
    """log-soften values above max_value (reference: model.py:95-100). The
    gradient at x == max_value is JAX's: `torch.maximum` splits a tie in
    half as `jnp.maximum` does (`clamp_min` would pass it whole)."""
    d = x - max_value
    return torch.where(x >= max_value,
                       max_value + torch.log1p(torch.maximum(d, torch.zeros_like(d))), x)


def _valid(gt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(not-NaN mask, gt with NaN as 0): NaN marks a don't-care target."""
    valid = ~torch.isnan(gt)
    return valid, torch.where(valid, gt, 0.0)


def bce_loss(pd_conf: torch.Tensor, gt_conf: torch.Tensor, focal_gamma: float = 1.0):
    """NaN-masked focal BCE on logits, summed and / batch (reference:
    model.py:101-120 Bce_loss)."""
    valid, gt = _valid(gt_conf)
    z = torch.clamp(pd_conf, -30, 30)
    bce = torch.maximum(z, torch.zeros_like(z)) - z * gt + torch.log1p(torch.exp(-z.abs()))
    bce = soft_clamp(bce)
    if focal_gamma != 0.0:
        p = torch.sigmoid(z)
        focal = 1.0 - (p * gt + (1 - p) * (1 - gt))
        if focal_gamma != 1.0:
            focal = (focal + 1e-4) ** focal_gamma
        bce = focal * bce * 0.5
    return torch.where(valid, bce, 0.0).sum() / pd_conf.shape[0]


def laplace_loss(pd_vec, pd_logb, gt_vec, gt_bmin):
    """NaN-masked Laplace regression of [..., 2] vectors with log-scale
    3 * tanh(logb / 3), summed and / batch (reference: model.py:122-146)."""
    valid = ~torch.isnan(gt_vec[..., 0])
    gvx = torch.where(valid, gt_vec[..., 0], 0.0)
    gvy = torch.where(valid, gt_vec[..., 1], 0.0)
    gbm = torch.where(valid, torch.nan_to_num(gt_bmin), 0.0)
    norm = torch.sqrt((pd_vec[..., 0] - gvx) ** 2 + (pd_vec[..., 1] - gvy) ** 2 + gbm ** 2)
    logb = 3.0 * torch.tanh(pd_logb / 3.0)
    loss = logb + soft_clamp(norm * torch.exp(-logb))
    return torch.where(valid, loss, 0.0).sum() / pd_vec.shape[0]


def scale_loss(pd_scale, gt_scale):
    """NaN-masked relative L1 on softplus scales, summed and / batch
    (reference: model.py:148-159). softplus is log(1 + e^x) as
    `jax.nn.softplus` computes it (`F.softplus` returns x beyond 20)."""
    valid, gt = _valid(gt_scale)
    pd = torch.logaddexp(pd_scale, torch.zeros_like(pd_scale))
    loss = soft_clamp((pd - gt).abs() / (10.0 * (0.1 + gt)))
    return torch.where(valid, loss, 0.0).sum() / pd_scale.shape[0]


def pifpaf_loss(predict: dict, target: dict) -> tuple[torch.Tensor, dict]:
    """(total, parts): the eight composite-field losses under the JAX
    package's names, every lambda 1 (reference: model.py:161-224 cal_loss)."""
    parts = {
        "loss_pif_conf": bce_loss(predict["pif_conf"], target["pif_conf"]),
        "loss_pif_vec": laplace_loss(predict["pif_vec"], predict["pif_bmin"],
                                     target["pif_vec"], target["pif_bmin"]),
        "loss_pif_scale": scale_loss(predict["pif_scale"], target["pif_scale"]),
        "loss_paf_conf": bce_loss(predict["paf_conf"], target["paf_conf"]),
        "loss_paf_src_vec": laplace_loss(predict["paf_src_vec"], predict["paf_src_bmin"],
                                         target["paf_src_vec"], target["paf_src_bmin"]),
        "loss_paf_dst_vec": laplace_loss(predict["paf_dst_vec"], predict["paf_dst_bmin"],
                                         target["paf_dst_vec"], target["paf_dst_bmin"]),
        "loss_paf_src_scale": scale_loss(predict["paf_src_scale"], target["paf_src_scale"]),
        "loss_paf_dst_scale": scale_loss(predict["paf_dst_scale"], target["paf_dst_scale"]),
    }
    return sum(parts.values()), parts


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
    outside inference mode (what `torch.export` traces), and its
    `decode(outputs, image_hw)` the part after the network, for images of
    `image_hw`."""
    model.eval()

    def decode(out: dict, image_hw):
        hw = in_hw or tuple(image_hw)
        s = stride or hw[0] // out["pif_conf"].shape[1]
        return pifpaf_decode_batch(out, cfg, s, hw, topology)

    def body(images_u8: torch.Tensor):
        return decode(model(images_u8.to(model.dtype) / 255.0), images_u8.shape[1:3])

    fused = torch.inference_mode()(body)
    fused.body, fused.decode = body, decode
    fused.rebuild = lambda other: pifpaf_fused_decode(other, cfg, stride, in_hw, topology)
    return fused
