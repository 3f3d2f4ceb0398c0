"""The OpenPose family in PyTorch: Lightweight-OpenPose, CMU OpenPose and
the MobileNet-Thin and MobileNet-Small OpenPose models.

Counterpart of `hyperpose_tpu/models/openpose.py` `LightWeightOpenPose`,
`prelu`, `PRelu`, `_ConvPRelu`, `_CmuStage`, `OpenPose`, `_SepBNBlock`,
`SeparableConv`, `_SepSmallBlock`, `_SepStage`, `_ThinSmallOpenPose`,
`MobilenetThinOpenpose`, `MobilenetSmallOpenpose` and `openpose_loss` (reference:
hyperpose/Model/openpose/model/{openpose,lw_openpose,mbv2_th_openpose,
mbv2_sm_openpose}.py). The networks run NCHW inside (channels-last memory is
fine) and, like the flax modules, take NHWC images and return NHWC maps
(`conf_map`, `paf_map`, the per-stage `stage_confs` and `stage_pafs`, and
with `ret_backbone` the `backbone_features`), so the decoder sees the layout
`paf_decode_batch` expects. Submodule names follow the flax module names, so
the flat weight layout maps one to one (`utils/weights.py`).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import tracing
from .backbones import (
    ConvBN, DepthwiseConv, FlaxBatchNorm2d, MobilenetDilated, MobilenetSmall, MobilenetThin,
    Vgg19,
)

N_CONFMAPS = 19   # 18 COCO parts + background
N_PAFMAPS = 38    # x and y for each of the 19 limbs
N_CHANNELS = 128


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _outputs(confs: list, pafs: list, feats: torch.Tensor | None) -> dict:
    """The flax modules' output dict, NHWC."""
    out = {"conf_map": _nhwc(confs[-1]), "paf_map": _nhwc(pafs[-1]),
           "stage_confs": [_nhwc(c) for c in confs],
           "stage_pafs": [_nhwc(p) for p in pafs]}
    if feats is not None:
        out["backbone_features"] = _nhwc(feats)
    return out


def _conv(cin: int, cout: int, k: int, dtype: torch.dtype) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, dtype=dtype)


class _LwConvBlock(nn.Module):
    """conv3x3 + BN(relu), BN decay 0.99 (reference: lw_openpose.py:193-198
    conv_block)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.cb = ConvBN(cin, features, dtype=dtype, momentum=0.99)

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

    def __init__(self, cin: int, n_confmaps: int, n_pafmaps: int, dtype: torch.dtype):
        super().__init__()
        self.conf1 = _conv(cin, 512, 1, dtype)
        self.conf2 = _conv(512, n_confmaps, 1, dtype)
        self.paf1 = _conv(cin, 512, 1, dtype)
        self.paf2 = _conv(512, n_pafmaps, 1, dtype)

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
    checkpoint is `backbone=VggTiny` (or one of its serving forms).
    `n_confmaps`, `n_pafmaps` and `num_channels` are the flax module's knobs
    (19, 38 and 128 for COCO); `ret_backbone` adds the backbone's output to
    the dict (the flax call argument)."""

    def __init__(self, backbone: Callable[..., nn.Module] = MobilenetDilated,
                 dtype: torch.dtype = torch.float32, n_confmaps: int = N_CONFMAPS,
                 n_pafmaps: int = N_PAFMAPS, num_channels: int = N_CHANNELS,
                 ret_backbone: bool = False):
        super().__init__()
        self.dtype, self.ret_backbone = dtype, ret_backbone
        self.backbone = backbone(dtype=dtype)
        c = num_channels
        self.cpm = _LwCpm(self.backbone.out_channels, c, dtype)
        self.init_m0 = _conv(c, c, 3, dtype)
        self.init_m1 = _conv(c, c, 3, dtype)
        self.init_m2 = _conv(c, c, 3, dtype)
        self.init_heads = _LwHeads(c, n_confmaps, n_pafmaps, dtype)
        cin = c + n_confmaps + n_pafmaps
        for i in range(5):
            self.add_module(f"ref_b{i}", _LwRefineBlock(cin, c, dtype))
            cin = c
        self.ref_heads = _LwHeads(c, n_confmaps, n_pafmaps, dtype)

    def forward(self, x: torch.Tensor) -> dict:
        """x: NHWC images [B, H, W, 3]. Returns NHWC `conf_map`
        [B, H/8, W/8, n_confmaps] and `paf_map` [B, H/8, W/8, n_pafmaps],
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
        return _outputs([conf0, conf1], [paf0, paf1], bf if self.ret_backbone else None)


# -- CMU OpenPose --------------------------------------------------------------------

def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """where(x >= 0, x, alpha * x) on NCHW x, alpha [C] in x's dtype (JAX
    `prelu`)."""
    return torch.where(x >= 0, x, alpha.view(1, -1, 1, 1) * x)


class PRelu(nn.Module):
    """Channel-wise PReLU with the slope `alpha` [C], cast to the input's
    dtype (flax `PRelu`)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.alpha.to(x.dtype))


class _ConvPRelu(nn.Module):
    """A SAME conv with bias (`conv`), then PReLU (`prelu`)."""

    def __init__(self, cin: int, features: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.conv = _conv(cin, features, k, dtype)
        self.prelu = PRelu(features, dtype)

    def forward(self, x):
        return self.prelu(self.conv(x))


class _CmuStage(nn.Module):
    """One CMU-OpenPose stage branch: a conv+PReLU tower `l<i>` of
    (features, ksize) layers, then the 1x1 `out` conv+PReLU
    (reference: openpose.py:119-199 Init_stage/Refinement_stage)."""

    def __init__(self, cin: int, n_out: int, plan: Sequence[tuple[int, int]],
                 dtype: torch.dtype):
        super().__init__()
        self._layers = []
        for i, (f, k) in enumerate(plan):
            self.add_module(f"l{i}", _ConvPRelu(cin, f, k, dtype))
            self._layers.append(f"l{i}")
            cin = f
        self.out = _ConvPRelu(cin, n_out, 1, dtype)

    def forward(self, x):
        for name in self._layers:
            x = getattr(self, name)(x)
        return self.out(x)


_CMU_INIT = [(128, 3), (128, 3), (128, 3), (512, 1)]
_CMU_REFINE = [(128, 7)] * 5 + [(128, 1)]


class OpenPose(nn.Module):
    """CMU OpenPose: the backbone (VGG19 by default), the cpm convs `cpm1`
    (256) and `cpm2` (128) with ReLU, the init stage `init_conf` /
    `init_paf`, and `n_refinements` stages `ref<i>_conf` / `ref<i>_paf` on
    the concat of the cpm features and the last stage's maps (reference:
    openpose/model/openpose.py:13-117). `num_channels` is kept as the flax
    module keeps it: its layers are 128 wide whatever it says.
    `ret_backbone` adds the cpm features (the flax module's
    `backbone_features`). Device spans (`utils/tracing.py`):
    `openpose/backbone` (the backbone, `cpm1` and `cpm2`) and
    `openpose/stages` (every stage; counts `stages` and `frames`)."""

    def __init__(self, n_confmaps: int = N_CONFMAPS, n_pafmaps: int = N_PAFMAPS,
                 num_channels: int = N_CHANNELS,
                 backbone: Callable[..., nn.Module] = Vgg19,
                 dtype: torch.dtype = torch.float32, n_refinements: int = 5,
                 ret_backbone: bool = False):
        super().__init__()
        del num_channels
        self.dtype, self.ret_backbone = dtype, ret_backbone
        self.n_refinements = n_refinements
        self.backbone = backbone(dtype=dtype)
        self.cpm1 = _conv(self.backbone.out_channels, 256, 3, dtype)
        self.cpm2 = _conv(256, 128, 3, dtype)
        self.init_conf = _CmuStage(128, n_confmaps, _CMU_INIT, dtype)
        self.init_paf = _CmuStage(128, n_pafmaps, _CMU_INIT, dtype)
        cin = 128 + n_confmaps + n_pafmaps
        for i in range(n_refinements):
            self.add_module(f"ref{i}_conf", _CmuStage(cin, n_confmaps, _CMU_REFINE, dtype))
            self.add_module(f"ref{i}_paf", _CmuStage(cin, n_pafmaps, _CMU_REFINE, dtype))

    def forward(self, x: torch.Tensor) -> dict:
        with tracing.span("openpose/backbone", device=x.device):
            feats = self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))
            feats = torch.relu(self.cpm2(torch.relu(self.cpm1(feats))))
        with tracing.span("openpose/stages", device=x.device, stages=1 + self.n_refinements,
                          frames=int(x.shape[0])):
            confs, pafs = [self.init_conf(feats)], [self.init_paf(feats)]
            for i in range(self.n_refinements):
                z = torch.cat([feats, confs[-1], pafs[-1]], dim=1)
                confs.append(getattr(self, f"ref{i}_conf")(z))
                pafs.append(getattr(self, f"ref{i}_paf")(z))
        return _outputs(confs, pafs, feats if self.ret_backbone else None)


# -- MobileNet-Thin and MobileNet-Small OpenPose ---------------------------------------

class _SepBNBlock(nn.Module):
    """The thin variant's stage block: the depthwise conv `dw` + BN `bn1`
    + act, then the 1x1 conv `pw` (no bias) + BN `bn2` + act; act (ReLU, or
    None for a stage's output block) runs after both BNs; BN decay 0.99
    (reference: mbv2_th_openpose.py:171-178)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 act: Callable | None = torch.relu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.dw = DepthwiseConv(cin, kernel, dtype=dtype)
        self.bn1 = FlaxBatchNorm2d(cin, 0.99, dtype=dtype)
        self.pw = nn.Conv2d(cin, features, 1, bias=False, dtype=dtype)
        self.bn2 = FlaxBatchNorm2d(features, 0.99, dtype=dtype)

    def forward(self, x):
        x = self.bn1(self.dw(x))
        if self.act is not None:
            x = self.act(x)
        x = self.bn2(self.pw(x))
        return x if self.act is None else self.act(x)


class SeparableConv(nn.Module):
    """One separable conv: the depthwise `dw_kernel` [cin, 1, k, k], the 1x1
    `pw_kernel` [features, cin, 1, 1], then `bias` added and act, with
    stride 1 and SAME padding (reference: mbv2_sm_openpose.py:166-170).

    Like the flax module, which calls `lax.conv_general_dilated` on bare
    parameters and is no `nn.Conv`, it holds bare parameters and no
    `nn.Conv2d`, so int8 calibration (which hooks every `nn.Conv2d`, as JAX
    intercepts every `nn.Conv`) leaves it float in both packages. The bias is
    added after the conv, in the activation dtype, as JAX adds it."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 act: Callable | None = torch.relu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.dw_kernel = nn.Parameter(torch.zeros(cin, 1, kernel, kernel, dtype=dtype))
        self.pw_kernel = nn.Parameter(torch.zeros(features, cin, 1, 1, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))

    def forward(self, x):
        k = self.dw_kernel.shape[-1]
        x = F.conv2d(x, self.dw_kernel.to(x.dtype), padding=k // 2, groups=x.shape[1])
        x = F.conv2d(x, self.pw_kernel.to(x.dtype)) + self.bias.to(x.dtype).view(1, -1, 1, 1)
        return x if self.act is None else self.act(x)


class _SepSmallBlock(nn.Module):
    """The small variant's stage block: `sep` (a SeparableConv with act) and
    BN `bn` (decay 0.999) + act, so the activation runs twice, as the
    reference builds it (mbv2_sm_openpose.py:166-171)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 act: Callable | None = torch.relu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.sep = SeparableConv(cin, features, kernel, act, dtype)
        self.bn = FlaxBatchNorm2d(features, 0.999, dtype=dtype)

    def forward(self, x):
        x = self.bn(self.sep(x))
        return x if self.act is None else self.act(x)


class _SepStage(nn.Module):
    """A separable stage branch: blocks `l<i>` of (features, ksize), then a
    1x1 `out` block with no activation; style "thin" builds `_SepBNBlock`s,
    "small" `_SepSmallBlock`s (mbv2_th_openpose.py:106-162,
    mbv2_sm_openpose.py:103-157)."""

    def __init__(self, cin: int, n_out: int, plan: Sequence[tuple[int, int]],
                 style: str = "thin", dtype: torch.dtype = torch.float32):
        super().__init__()
        if style not in ("thin", "small"):
            raise ValueError(f"unknown separable stage style {style!r}")
        block = _SepBNBlock if style == "thin" else _SepSmallBlock
        self._layers = []
        for i, (f, k) in enumerate(plan):
            self.add_module(f"l{i}", block(cin, f, k, dtype=dtype))
            self._layers.append(f"l{i}")
            cin = f
        self.out = block(cin, n_out, 1, act=None, dtype=dtype)

    def forward(self, x):
        for name in self._layers:
            x = getattr(self, name)(x)
        return self.out(x)


class _ThinSmallOpenPose(nn.Module):
    """The thin and small variants' shared structure: the backbone, the
    separable init stage `init_conf` / `init_paf`, and `n_refinements`
    stages `ref<i>_conf` / `ref<i>_paf` on the concat of the backbone's
    features and the last stage's maps. `ret_backbone` adds the backbone's
    features."""

    def __init__(self, n_confmaps: int, n_pafmaps: int, backbone: Callable[..., nn.Module],
                 n_refinements: int, init_plan, ref_plan, style: str = "thin",
                 dtype: torch.dtype = torch.float32, ret_backbone: bool = False):
        super().__init__()
        self.dtype, self.ret_backbone = dtype, ret_backbone
        self.n_refinements = n_refinements
        self.backbone = backbone(dtype=dtype)
        c = self.backbone.out_channels
        self.init_conf = _SepStage(c, n_confmaps, init_plan, style, dtype)
        self.init_paf = _SepStage(c, n_pafmaps, init_plan, style, dtype)
        cin = c + n_confmaps + n_pafmaps
        for i in range(n_refinements):
            self.add_module(f"ref{i}_conf", _SepStage(cin, n_confmaps, ref_plan, style, dtype))
            self.add_module(f"ref{i}_paf", _SepStage(cin, n_pafmaps, ref_plan, style, dtype))

    def forward(self, x: torch.Tensor) -> dict:
        feats = self.backbone(x.permute(0, 3, 1, 2).to(self.dtype))
        confs, pafs = [self.init_conf(feats)], [self.init_paf(feats)]
        for i in range(self.n_refinements):
            z = torch.cat([feats, confs[-1], pafs[-1]], dim=1)
            confs.append(getattr(self, f"ref{i}_conf")(z))
            pafs.append(getattr(self, f"ref{i}_paf")(z))
        return _outputs(confs, pafs, feats if self.ret_backbone else None)


def MobilenetThinOpenpose(n_confmaps: int = N_CONFMAPS, n_pafmaps: int = N_PAFMAPS,
                          dtype: torch.dtype = torch.float32,
                          backbone: Callable[..., nn.Module] | None = None,
                          ret_backbone: bool = False) -> _ThinSmallOpenPose:
    """MobileNet-Thin OpenPose (reference: mbv2_th_openpose.py:14-162): the
    `MobilenetThin` backbone (stride 8, 1152 channels), 5 refinement stages,
    `_SepBNBlock` stages of 3x3 layers (the init stage's last is 512 wide
    and 1x1)."""
    return _ThinSmallOpenPose(
        n_confmaps, n_pafmaps, backbone or MobilenetThin, 5,
        [(128, 3), (128, 3), (128, 3), (512, 1)],
        [(128, 3), (128, 3), (128, 3), (128, 1)], "thin", dtype, ret_backbone)


def MobilenetSmallOpenpose(n_confmaps: int = N_CONFMAPS, n_pafmaps: int = N_PAFMAPS,
                           dtype: torch.dtype = torch.float32,
                           backbone: Callable[..., nn.Module] | None = None,
                           ret_backbone: bool = False) -> _ThinSmallOpenPose:
    """MobileNet-Small OpenPose (reference: mbv2_sm_openpose.py:14-158): the
    `MobilenetSmall` backbone (stride 4, 704 channels), 4 refinement
    stages, `_SepSmallBlock` stages with 7x7 refinement layers. Its
    SeparableConvs stay float in int8, as in JAX."""
    return _ThinSmallOpenPose(
        n_confmaps, n_pafmaps, backbone or MobilenetSmall, 4,
        [(128, 3), (128, 3), (128, 3), (512, 1)],
        [(128, 7), (128, 7), (128, 7), (128, 1)], "small", dtype, ret_backbone)


def openpose_loss(predict: dict, gt_conf: torch.Tensor, gt_paf: torch.Tensor,
                  mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Staged L2 loss: 0.5 * sum((gt - stage map) * mask)^2 for the conf and
    PAF maps of every stage (tf.nn.l2_loss), their mean over stages, / batch
    (reference: openpose/model/openpose.py:89-117 cal_loss). NHWC maps,
    compared in float32; `mask` [B, H, W, 1] is 1 where the loss applies.
    Returns (loss, {"conf_loss", "paf_loss"}: the last stage's, / batch)."""
    batch = gt_conf.shape[0]
    m = 1.0 if mask is None else mask
    conf_losses, paf_losses, stage_losses = [], [], []
    for conf, paf in zip(predict["stage_confs"], predict["stage_pafs"]):
        lc = 0.5 * torch.sum(torch.square((gt_conf - conf.to(torch.float32)) * m))
        lp = 0.5 * torch.sum(torch.square((gt_paf - paf.to(torch.float32)) * m))
        stage_losses += [lc, lp]
        conf_losses.append(lc)
        paf_losses.append(lp)
    pd_loss = torch.stack(stage_losses).mean() / batch
    return pd_loss, {"conf_loss": conf_losses[-1] / batch, "paf_loss": paf_losses[-1] / batch}
