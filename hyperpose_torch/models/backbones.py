"""Backbones in PyTorch: the flagship's TinyVGG and its two exact serving
forms, VGG16 and VGG19, the MobileNets (V1, V2, the dilated one of
Lightweight-OpenPose, Thin and Small), the ResNet50 trunk of PifPaf and the
ResNet18 trunk of PoseProposal.

Counterpart of `hyperpose_tpu/models/backbones.py` `ConvBN`, `VggTiny`,
`VggTinyS2D`, `VggTinyS2DStem`, `VggTinyFusedStem`, `Vgg16`, `Vgg19`, `Bottleneck`,
`Resnet50`, `ResBlock18`, `Resnet18`, `DepthwiseConv`, `SeparableBlock`,
`MobilenetV1`, `InvertedResidual`, `MobilenetV2`, `MobilenetDilated`,
`MobilenetThin`, `MobilenetSmall`, `jax_resize_nearest` and the
`BACKBONES` name table, each with the flax module's `pretraining` variant
that ImageNet pretraining builds (`train/pretrain.py`), with the numpy remaps
that turn a VggTiny checkpoint into either serving form (reference:
hyperpose/Model/backbones.py:201-232, 343-391, 512-586, 587-697). Modules
run NCHW; the submodule names follow the flax module names, so the flat
weight layout maps one to one (`utils/weights.py`).

Every BatchNorm is a `FlaxBatchNorm2d`: in eval mode `nn.BatchNorm2d`'s
own computation, in train mode flax's (`use_fast_variance=False`), with
the decay of the flax module it ports.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv1_pool import conv1_pool
from ..parallel import spatial
from ..utils.weights import read_flax_weights

# VggTiny after its first pool: block_2 onwards, on 64 input channels.
_TAIL = (128, 128, "pool", 200, 200, 200, "pool", 384, 384)


def same_pads(hw, kernel: int, stride: int) -> tuple[int, int, int, int]:
    """XLA's `padding="SAME"` for one (H, W) input as `F.pad` widths (left,
    right, top, bottom): per side total = max((ceil(n/s) - 1)*s + k - n, 0),
    total // 2 before and the rest after. At stride 2 the two sides may
    differ (a 7x7 conv on 368 pads 2 and 3; a 3x3 conv on an even size pads
    0 and 1), which no symmetric `Conv2d(padding=...)` reproduces."""
    out = []
    for n in reversed(tuple(hw)):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        out += [total // 2, total - total // 2]
    return tuple(out)


def _same(op, x: torch.Tensor, span: int, stride: int, value: float = 0.0,
          what: str = "a strided SAME layer") -> torch.Tensor:
    """`op` (a conv or pool with no padding of its own) on `x` padded to
    XLA's SAME for a `span`-wide window at `stride` (`same_pads`) with
    `value`. With image rows split over ranks (`parallel/spatial.py`), the
    row pads are the whole image's, filled from the neighbouring ranks'
    rows inside it."""
    if spatial.active() is not None:
        return spatial.same(op, x, span, stride, value, what)
    return op(F.pad(x, same_pads(x.shape[-2:], span, stride), value=value))


# The process group whose ranks' batches a train-mode FlaxBatchNorm2d
# normalises together (`cross_rank_batchnorm`); None: this rank's batch.
_BN_GROUP: contextvars.ContextVar = contextvars.ContextVar("hyperpose_bn_group", default=None)


@contextlib.contextmanager
def cross_rank_batchnorm(group):
    """Inside the block, every train-mode `FlaxBatchNorm2d` takes its batch
    statistics over the ranks of `group` (None: this rank's batch alone),
    as flax's `jnp.mean` over a batch sharded across devices does: the
    trainer's Sync_sgd step sets it, and Sync_avg / Pair_avg leave it
    unset."""
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


# Whether a train-mode FlaxBatchNorm2d writes its running statistics into the
# buffers it has (`batchnorm_stats_in_place`) rather than binding new ones.
_BN_IN_PLACE: contextvars.ContextVar = contextvars.ContextVar("hyperpose_bn_in_place",
                                                             default=False)


@contextlib.contextmanager
def batchnorm_stats_in_place():
    """Inside the block, every train-mode `FlaxBatchNorm2d` updates its
    running statistics in place, with the same arithmetic: the trainer's
    step captured as a CUDA graph sets it, so that each replay writes the
    buffers the module holds (new tensors would leave the replays reading
    the buffers of the capture)."""
    token = _BN_IN_PLACE.set(True)
    try:
        yield
    finally:
        _BN_IN_PLACE.reset(token)


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, differentiable: its
    backward sums the ranks' gradients, since every rank's loss depends on
    every rank's activations through the statistics."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` that trains as flax's `nn.BatchNorm(use_fast_variance=
    False)` does.

    `momentum` is flax's decay `m` of the running statistics (0.9, 0.99 or
    0.999: the flax module's own), not torch's update factor, which is set
    to 1 - m. In eval mode the forward is `nn.BatchNorm2d`'s, so serving,
    BN folding and the int8 paths see a plain BatchNorm. In train mode it
    computes in float32 (or the input's dtype where that is wider): the batch mean over N,
    H and W, the *biased* variance as the mean of (x - mean)^2 (two
    passes), y = (x - mean) * (rsqrt(var + eps) * weight) + bias cast back
    to the input's dtype, and, without gradient, running = m * running +
    (1 - m) * batch with that biased variance (`nn.BatchNorm2d` stores the
    unbiased one).

    Under `cross_rank_batchnorm(group)` with more than one rank, the mean
    is the all-reduced sum over every rank's N, H and W over the all-reduced
    count, and the variance the all-reduced sum of (x - mean)^2 over it: the
    statistics of the global batch, with gradients that cross the ranks.
    Outside it, or in a group of one, the computation above, bit for bit.
    Under `batchnorm_stats_in_place` the running statistics are written into
    the buffers rather than bound anew."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum, dtype=dtype)
        self.decay = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # Elementwise ops and means only: autocast leaves them in the dtype
        # they are given.
        dt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(dt)
        group = _BN_GROUP.get()
        if group is not None and torch.distributed.get_world_size(group) > 1:
            count = torch.full((1,), xf.numel() // xf.shape[1], dtype=dt, device=xf.device)
            sums = _group_sum(torch.cat([xf.sum(dim=(0, 2, 3)), count]), group)
            n = sums[-1]
            mean = sums[:-1] / n
            var = _group_sum((xf - mean.view(1, -1, 1, 1)).square().sum(dim=(0, 2, 3)),
                             group) / n
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
        with torch.no_grad():
            m = self.decay
            if _BN_IN_PLACE.get():
                torch.add(m * self.running_mean, (1 - m) * mean, out=self.running_mean)
                torch.add(m * self.running_var, (1 - m) * var, out=self.running_var)
            else:
                # New tensors, not in-place updates: a forward in eval mode
                # earlier in the same step (domain adaptation's features)
                # saved the old ones for its backward.
                self.running_mean = m * self.running_mean + (1 - m) * mean
                self.running_var = m * self.running_var + (1 - m) * var
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1)
        y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv2d + BatchNorm + activation, with flax's SAME padding. BN eps is
    the flax module's 1e-5 and `momentum` its decay (0.9, the flax
    `ConvBN`'s default). `act` is the activation (ReLU by default, None
    for none, any callable: PoseProposal's leaky ReLU); `bias` gives the conv
    a bias, as flax's `use_bias` does.

    At stride 1 an odd kernel's SAME padding is `padding=kernel // 2` on
    both sides; at a larger stride it depends on the input size
    (`same_pads`), so the forward pads first (`_same`)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, kernel: int = 3,
                 stride: int = 1, act: Callable | None = torch.relu,
                 bias: bool = False, momentum: float = 0.9):
        super().__init__()
        self.kernel, self.stride, self.act = kernel, stride, act
        self.conv = nn.Conv2d(in_features, features, kernel, stride=stride,
                              padding=kernel // 2 if stride == 1 else 0,
                              bias=bias, dtype=dtype)
        self.bn = FlaxBatchNorm2d(features, momentum, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = self.bn(_same(self.conv, x, self.kernel, self.stride))
        else:
            x = self.bn(self.conv(x))
        return x if self.act is None else self.act(x)


def _add_blocks(module: nn.Module, cfg, cin: int, first: int,
                dtype: torch.dtype) -> list:
    """Register `block_<first>...` ConvBNs on `module` for `cfg` (channel
    counts and "pool"); returns the plan `_run_blocks` walks (a block name,
    or None for a pool)."""
    plan, i = [], first
    for item in cfg:
        if item == "pool":
            plan.append(None)
            continue
        name = f"block_{i}"
        module.add_module(name, ConvBN(cin, item, dtype=dtype))
        plan.append(name)
        cin, i = item, i + 1
    return plan


def _run_blocks(module: nn.Module, plan: list, x: torch.Tensor) -> torch.Tensor:
    """flax `nn.max_pool((2,2), (2,2), padding="SAME")` pads at the end on
    odd sizes, which is `ceil_mode=True`."""
    for name in plan:
        if name is None:
            x = nn.functional.max_pool2d(x, 2, 2, ceil_mode=True)
        else:
            x = getattr(module, name)(x)
    return x


def _halved(image_size, times: int, first_floor: bool = False) -> tuple[int, int]:
    """(H, W) of a square `image_size` (or an (H, W) pair) after `times`
    halvings as SAME stride-2 convs and SAME 2x2 pools round (up); with
    `first_floor` the first halving is a 2x2 packing (down)."""
    hw = (image_size, image_size) if isinstance(image_size, int) else tuple(image_size)
    out = []
    for n in hw:
        for i in range(times):
            n = n // 2 if first_floor and i == 0 else -(-n // 2)
        out.append(n)
    return tuple(out)


def _add_classifier_head(module: nn.Module, in_features: int, hidden,
                         dtype: torch.dtype) -> None:
    """flax `_classifier_head`'s dense layers on `module`: `fc1`, `fc2`, ...
    of `hidden` widths (ReLU after each) and `fc_out` (1000 classes).
    `in_features` is what flax's `Dense` infers at `init`: the H x W x C of
    the features it flattens."""
    module._fcs = []
    for i, h in enumerate(hidden):
        module.add_module(f"fc{i + 1}", nn.Linear(in_features, h, dtype=dtype))
        module._fcs.append(f"fc{i + 1}")
        in_features = h
    module.fc_out = nn.Linear(in_features, 1000, dtype=dtype)


def _run_classifier_head(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """NCHW features -> logits [N, 1000]: flattened in NHWC order, as flax
    reshapes them (so a flax `fc1` kernel carries across), then the dense
    layers of `_add_classifier_head`."""
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    for name in module._fcs:
        x = torch.relu(getattr(module, name)(x))
    return module.fc_out(x)


def _mean_head(x: torch.Tensor, fc_out: nn.Linear) -> torch.Tensor:
    """The MobileNets' and ResNets' pretraining head: the mean over H and W,
    then `fc_out`."""
    return fc_out(x.mean(dim=(2, 3)))


class _S32Tail(nn.Module):
    """The stride-32 tail of the TinyVGG backbones: `block_s32_{0,1,2}`,
    ConvBN(384) at strides 2, 1, 2 (none at scale 8 without pretraining),
    and with `pretraining` the classifier head `fc1` (4096), `fc2` (4096),
    `fc_out` on the flattened features of an `image_size` input."""

    def _add_s32(self, scale_size: int, pretraining: bool, image_size, dtype: torch.dtype,
                 halvings: int, first_floor: bool = False) -> None:
        self.pretraining = pretraining
        self._s32 = []
        if scale_size == 32 or pretraining:
            for j, s in enumerate((2, 1, 2)):
                self.add_module(f"block_s32_{j}", ConvBN(384, 384, dtype=dtype, stride=s))
                self._s32.append(f"block_s32_{j}")
        if pretraining:
            h, w = _halved(image_size, halvings, first_floor)
            _add_classifier_head(self, h * w * 384, (4096, 4096), dtype)

    def _run_s32(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._s32:
            x = getattr(self, name)(x)
        return _run_classifier_head(self, x) if self.pretraining else x


class VggTiny(_S32Tail):
    """TinyVGG at scale 8: conv-BN stacks 32-64 / 128-128 / 200x3 / 384x2
    with 3 pools, on RGB input; `scale_size=32` adds `block_s32_*`, and
    `pretraining` adds them and the classifier head (logits [N, 1000]) for
    `image_size` inputs."""

    out_channels = 384

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False, image_size=224):
        super().__init__()
        self._plan = _add_blocks(self, (32, 64, "pool") + _TAIL, 3, 0, dtype)
        self._add_s32(scale_size, pretraining, image_size, dtype, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run_s32(_run_blocks(self, self._plan, x))


class VggTinyS2D(_S32Tail):
    """The trainable space-to-depth TinyVGG of the JAX package (no reference
    counterpart): each 2x2 patch packed into 12 channels (channel
    (py*2+px)*3 + c), then conv-BN stacks 64-64 / 128-128-200x3 / 384x2
    with 2 pools, stride 8 in all; `scale_size=32` adds `block_s32_*` and
    `pretraining` the classifier head too, as `VggTiny`'s. Its own weights:
    a VggTiny checkpoint does not map onto it (the exact remap is
    `VggTinyS2DStem`)."""

    out_channels = 384

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False, image_size=224):
        super().__init__()
        cfg = (64, 64, "pool", 128, 128, 200, 200, 200, "pool", 384, 384)
        self._plan = _add_blocks(self, cfg, 12, 0, dtype)
        self._add_s32(scale_size, pretraining, image_size, dtype, 5, first_floor=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        x = x.reshape(b, 4 * c, h // 2, w // 2)
        return self._run_s32(_run_blocks(self, self._plan, x))


def _check_even(name: str, x: torch.Tensor) -> None:
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(
            f"{name} needs even input height and width (its 2-pixel packing "
            f"and 2x2 pool assume it); got {h}x{w}. Pad the input or use "
            "VggTiny, which takes any size"
        )


class VggTinyS2DStem(_S32Tail):
    """The exact space-to-depth serving form of VggTiny.

    The image is packed 2x2 into channels (H, W, 3) -> (H/2, W/2, 12), with
    channel (py*2+px)*3 + c; `s2d_0` (12->128) and `s2d_1` (128->256) are
    block_0 and block_1 computing all four output phases as channel groups
    (phase*C + c), and pool1 becomes the max over the four phase groups.
    Blocks 2.. are VggTiny's, and so are `scale_size=32` and `pretraining`.
    Build its weights from a VggTiny checkpoint with `remap_vggtiny_to_s2d`."""

    out_channels = 384

    def __init__(self, dtype: torch.dtype = torch.float32, scale_size: int = 8,
                 pretraining: bool = False, image_size=224):
        super().__init__()
        self.s2d_0 = ConvBN(4 * 3, 4 * 32, dtype=dtype)
        self.s2d_1 = ConvBN(4 * 32, 4 * 64, dtype=dtype)
        self._plan = _add_blocks(self, _TAIL, 64, 2, dtype)
        self._add_s32(scale_size, pretraining, image_size, dtype, 5, first_floor=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_even("VggTinyS2DStem", x)
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
        x = self.s2d_1(self.s2d_0(x.reshape(b, 4 * c, h // 2, w // 2)))
        x = x.reshape(b, 4, 64, h // 2, w // 2).amax(dim=1)
        return self._run_s32(_run_blocks(self, self._plan, x))


class VggTinyFusedStem(nn.Module):
    """The exact serving form of VggTiny whose block_1 + pool1 run in one
    kernel (`ops/kernels/conv1_pool.py`), so the full-resolution activation
    of block_1 never reaches device memory. Inference only (BatchNorm is
    folded); build its weights with `remap_vggtiny_to_fused`.

    `conv0p` is block_0 on the pair-packed image (B, 6, H, W/2), channel
    3*px + c, and emits block_0's 32 channels at x = 2q+off for off in
    {-1, 0, 1, 2}: the x-direction im2col the kernel reads. `w1p`
    [3, 128, 128] (the compute dtype) and `b1p` [128] (float32) are block_1
    with BN folded, packed for that layout. It refuses `pretraining`, as the
    flax module does."""

    out_channels = 384

    def __init__(self, dtype: torch.dtype = torch.float32, pretraining: bool = False):
        super().__init__()
        if pretraining:
            raise NotImplementedError(
                "VggTinyFusedStem is a serving-only transform; pretrain VggTiny "
                "and remap_vggtiny_to_fused the checkpoint")
        self.conv0p = nn.Conv2d(6, 128, 3, padding=1, bias=True, dtype=dtype)
        self.w1p = nn.Parameter(torch.zeros(3, 128, 128, dtype=dtype))
        self.b1p = nn.Parameter(torch.zeros(128, dtype=torch.float32))
        self._plan = _add_blocks(self, _TAIL, 64, 2, dtype)

    def conv0_packed(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW images (B, 3, H, W) -> conv1_pool's input `btp`
        (B, H, W/2, 128): relu(conv0p) on the pair-packed image. NHWC
        (B, H, W, 3) -> (B, H, W/2, 6) is the pair packing; for the
        channels-last input the engine feeds, every step here is a view, and
        so is `btp` of the channels-last conv output."""
        b, c, h, w = x.shape
        xp = x.permute(0, 2, 3, 1).reshape(b, h, w // 2, 2 * c)
        return torch.relu(self.conv0p(xp.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "VggTinyFusedStem is a serving-only transform; train VggTiny "
                "and remap_vggtiny_to_fused the checkpoint (call .eval())"
            )
        _check_even("VggTinyFusedStem", x)
        btp = self.conv0_packed(x)
        if spatial.active() is None:
            y = conv1_pool(btp, self.w1p, self.b1p)
        else:
            y = self._conv1_pool_rows(btp)
        return _run_blocks(self, self._plan, y.permute(0, 3, 1, 2))

    def _conv1_pool_rows(self, btp: torch.Tensor) -> torch.Tensor:
        """`conv1_pool` on this rank's rows of the image: the kernel pads
        rows -1 and H of what it is given with zeros, so it takes `btp` with
        2 rows of each neighbour (the 2x2 pool keeps its pairs) and the
        pooled row beside each such halo, which read that zero row, is
        dropped; at the image's real top and bottom nothing is added."""
        shard = spatial.active()
        top, bottom = shard.index > 0, shard.index + 1 < shard.size
        ext = spatial.halo(btp.permute(0, 3, 1, 2), 2, 2, None)
        with spatial.routed():
            y = conv1_pool(ext.permute(0, 2, 3, 1), self.w1p, self.b1p)
        return y[:, int(top):y.shape[1] - int(bottom)]


class Bottleneck(nn.Module):
    """ResNet50 bottleneck: 1x1 -> 3x3 (carrying the stride) -> 1x1 (x4, no
    ReLU), plus the identity or, where the stride or width changes, the 1x1
    projection `ds`; ReLU after the sum."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = 4 * features
        self.cb1 = ConvBN(in_features, features, dtype, kernel=1)
        self.cb2 = ConvBN(features, features, dtype, kernel=3, stride=stride)
        self.cb3 = ConvBN(features, out, dtype, kernel=1, act=None)
        self.ds = (ConvBN(in_features, out, dtype, kernel=1, stride=stride,
                          act=None)
                   if stride != 1 or in_features != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cb3(self.cb2(self.cb1(x)))
        return torch.relu(y + (x if self.ds is None else self.ds(x)))


class Resnet50(nn.Module):
    """ResNet50 trunk: the 7x7 stride-2 stem, the optional 3x3 stride-2 max
    pool, and bottleneck groups of 3, 4, 6 and 3 blocks (`b<g>_<i>`). With
    `scale_size=32` groups 3 and 4 also stride 2; `use_pool=False` with it is
    PifPaf's stride-16 trunk (368x432 -> 23x27). `pretraining` strides as
    scale 32 does and adds the mean over H and W and `fc_out` (logits)."""

    out_channels = 2048

    def __init__(self, scale_size: int = 8, use_pool: bool = True,
                 dtype: torch.dtype = torch.float32, pretraining: bool = False):
        super().__init__()
        self.use_pool = use_pool
        s = 2 if scale_size == 32 or pretraining else 1
        self.stem = ConvBN(3, 64, dtype, kernel=7, stride=2)
        self._blocks, cin = [], 64
        for gi, (f, st, n) in enumerate(
                [(64, 1, 3), (128, 2, 4), (256, s, 6), (512, s, 3)]):
            for bi in range(n):
                name = f"b{gi + 1}_{bi + 1}"
                self.add_module(name, Bottleneck(cin, f, st if bi == 0 else 1,
                                                 dtype))
                self._blocks.append(name)
                cin = 4 * f
        self.fc_out = nn.Linear(2048, 1000, dtype=dtype) if pretraining else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        if self.use_pool:
            x = _stem_pool(x)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x if self.fc_out is None else _mean_head(x, self.fc_out)


def _stem_pool(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.max_pool(x, (3, 3), (2, 2), padding="SAME")`: padded with
    -inf as XLA pads, asymmetrically on even sizes (`same_pads`)."""
    return _same(lambda t: F.max_pool2d(t, 3, 2), x, 3, 2, float("-inf"), "3x3 max pool")


class ResBlock18(nn.Module):
    """ResNet18 basic block: two 3x3 ConvBNs (the first carrying the
    stride, the second without ReLU) plus the identity or, with
    `down_sample`, the 1x1 projection `ds`; ReLU after the sum."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 down_sample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cb1 = ConvBN(in_features, features, dtype, stride=stride)
        self.cb2 = ConvBN(features, features, dtype, act=None)
        self.ds = (ConvBN(in_features, features, dtype, kernel=1, stride=stride, act=None)
                   if down_sample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cb2(self.cb1(x))
        return torch.relu(y + (x if self.ds is None else self.ds(x)))


class Resnet18(nn.Module):
    """ResNet18 trunk ending at `b5_1`: the 7x7 stride-2 stem, the 3x3
    stride-2 max pool, then `b2_1`, `b2_2` (64), `b3_1` (128, stride 2),
    `b3_2`, `b4_1` (256), `b4_2`, `b5_1` (512), the first block of each
    width with the projection `ds`. With `scale_size=32`, `b4_1` and `b5_1`
    also stride 2 (PoseProposal: 384x384 -> 12x12); at 8 the trunk has
    stride 8. `pretraining` strides as scale 32 does and adds `b5_2` (512),
    the mean over H and W and `fc_out` (logits)."""

    out_channels = 512

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        s = 2 if scale_size == 32 or pretraining else 1
        self.stem = ConvBN(3, 64, dtype, kernel=7, stride=2)
        self._blocks, cin = [], 64
        for name, f, st, ds in (("b2_1", 64, 1, False), ("b2_2", 64, 1, False),
                                ("b3_1", 128, 2, True), ("b3_2", 128, 1, False),
                                ("b4_1", 256, s, True), ("b4_2", 256, 1, False),
                                ("b5_1", 512, s, True)):
            self.add_module(name, ResBlock18(cin, f, st, ds, dtype))
            self._blocks.append(name)
            cin = f
        self.fc_out = None
        if pretraining:
            self.b5_2 = ResBlock18(512, 512, dtype=dtype)
            self._blocks.append("b5_2")
            self.fc_out = nn.Linear(512, 1000, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _stem_pool(self.stem(x))
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x if self.fc_out is None else _mean_head(x, self.fc_out)


class DepthwiseConv(nn.Module):
    """A depthwise conv (groups = channels, no bias) with flax's SAME
    padding: at stride 1, dilation * (kernel - 1) / 2 on each side; at a
    larger stride the forward pads first (`same_pads` of the dilated span).
    The conv is `dwconv`, the flax module's name."""

    def __init__(self, channels: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.span, self.stride = dilation * (kernel - 1) + 1, stride
        self.dwconv = nn.Conv2d(channels, channels, kernel, stride=stride, dilation=dilation,
                                padding=self.span // 2 if stride == 1 else 0,
                                groups=channels, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            return _same(self.dwconv, x, self.span, self.stride)
        return self.dwconv(x)


class SeparableBlock(nn.Module):
    """Depthwise conv `dw` + BN `bn1` + ReLU, then the 1x1 conv `pw` + BN
    `bn2` + ReLU (BN eps 1e-5, flax's default; decay 0.99, the flax
    module's)."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw = DepthwiseConv(in_features, stride=stride, dilation=dilation, dtype=dtype)
        self.bn1 = FlaxBatchNorm2d(in_features, 0.99, dtype=dtype)
        self.pw = nn.Conv2d(in_features, features, 1, bias=False, dtype=dtype)
        self.bn2 = FlaxBatchNorm2d(features, 0.99, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.dw(x)))
        return torch.relu(self.bn2(self.pw(x)))


class MobilenetDilated(nn.Module):
    """Dilated MobileNetV1 at stride 8, the Lightweight-OpenPose backbone:
    a 3x3 stride-2 `stem` ConvBN (32, BN decay 0.999), then separable
    blocks `sep_0` .. `sep_10` (64, 128/2, 128, 256/2, 256, 512, 512
    dilated 2, 512 x 4). With `scale_size=32`, `sep_6` and `sep_8` also
    stride 2, and so with `pretraining`, which adds no head (as in flax)."""

    out_channels = 512

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        s = 2 if scale_size == 32 or pretraining else 1
        self.stem = ConvBN(3, 32, dtype, stride=2, momentum=0.999)
        plan = [(64, 1, 1), (128, 2, 1), (128, 1, 1), (256, 2, 1), (256, 1, 1),
                (512, 1, 1), (512, s, 2), (512, 1, 1), (512, s, 1), (512, 1, 1),
                (512, 1, 1)]
        self._blocks, cin = [], 32
        for i, (f, st, dil) in enumerate(plan):
            self.add_module(f"sep_{i}", SeparableBlock(cin, f, st, dil, dtype))
            self._blocks.append(f"sep_{i}")
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.max_pool((2, 2), (2, 2), padding="SAME")`."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class _VggTrunk(nn.Module):
    """Plain VGG: 3x3 convs `conv_<b>` with bias and ReLU (no BN) and 2x2
    SAME max pools, on RGB input. `cfg` holds (features, count) and
    "pool"."""

    out_channels = 512

    def __init__(self, cfg, dtype: torch.dtype, pretraining: bool = False, image_size=224):
        super().__init__()
        self.pretraining = pretraining
        self._plan, cin, b = [], 3, 0
        for item in cfg:
            if item == "pool":
                self._plan.append(None)
                continue
            f, n = item
            for _ in range(n):
                self.add_module(f"conv_{b}", nn.Conv2d(cin, f, 3, padding=1, dtype=dtype))
                self._plan.append(f"conv_{b}")
                cin, b = f, b + 1
        if pretraining:
            h, w = _halved(image_size, self._plan.count(None))
            _add_classifier_head(self, h * w * cin, (4096, 4096), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self._plan:
            x = _max_pool(x) if name is None else torch.relu(getattr(self, name)(x))
        return _run_classifier_head(self, x) if self.pretraining else x


class Vgg16(_VggTrunk):
    """VGG16's conv trunk at stride 8 (64x2 / 128x2 / 256x3 / 512x3, three
    pools); with `scale_size=32` or `pretraining`, a pool, 512x3 and a pool
    more, and with `pretraining` the classifier head (`fc1`, `fc2` 4096,
    `fc_out`) on the flattened features of an `image_size` input."""

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False, image_size=224):
        cfg = [(64, 2), "pool", (128, 2), "pool", (256, 3), "pool", (512, 3)]
        if scale_size == 32 or pretraining:
            cfg += ["pool", (512, 3), "pool"]
        super().__init__(cfg, dtype, pretraining, image_size)


class Vgg19(_VggTrunk):
    """VGG19's trunk up to conv4_2 at stride 8 (64x2 / 128x2 / 256x4 /
    512x2, three pools), the CMU OpenPose backbone; with `scale_size=32` or
    `pretraining`, 512x2, a pool, 512x4 and a pool more, and with
    `pretraining` the classifier head, as `Vgg16`'s. It first subtracts the
    BGR means / 255 from the image in the compute dtype, as the flax module
    does (its input is RGB in [0, 1]: the reference's order, kept)."""

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False, image_size=224):
        cfg = [(64, 2), "pool", (128, 2), "pool", (256, 4), "pool", (512, 2)]
        if scale_size == 32 or pretraining:
            cfg += [(512, 2), "pool", (512, 4), "pool"]
        super().__init__(cfg, dtype, pretraining, image_size)
        mean = np.array([103.939, 116.779, 123.68], np.float32) / 255.0
        self.register_buffer("mean", torch.from_numpy(mean).to(dtype).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x - self.mean)


class MobilenetV1(nn.Module):
    """MobileNetV1 at stride 8: the 3x3 stride-2 `stem` ConvBN (32), then
    separable blocks `sep_0` .. `sep_8` (64, 128/2, 128, 256/2, 256, 512
    x 4); with `scale_size=32` or `pretraining`, 512/2, 512, 1024/2, 1024
    more, and with `pretraining` the mean over H and W and `fc_out`."""

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
                (512, 1), (512, 1), (512, 1), (512, 1)]
        if scale_size == 32 or pretraining:
            plan += [(512, 2), (512, 1), (1024, 2), (1024, 1)]
        self.out_channels = plan[-1][0]
        self.stem = ConvBN(3, 32, dtype, stride=2)
        self._blocks, cin = [], 32
        for i, (f, st) in enumerate(plan):
            self.add_module(f"sep_{i}", SeparableBlock(cin, f, st, dtype=dtype))
            self._blocks.append(f"sep_{i}")
            cin = f
        self.fc_out = nn.Linear(cin, 1000, dtype=dtype) if pretraining else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x if self.fc_out is None else _mean_head(x, self.fc_out)


class InvertedResidual(nn.Module):
    """MobileNetV2's inverted residual: the 1x1 `expand` conv + BN `bn0` +
    ReLU6 (none at expansion 1), the 3x3 depthwise `dw` (carrying the
    stride) + `bn1` + ReLU6, the 1x1 `project` conv + `bn2` with no
    activation; plus the identity only where the stride is 1 and the widths
    are equal. BN decay 0.99, flax's default."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 exp_ratio: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = in_features * exp_ratio
        self.identity = stride == 1 and in_features == features
        self.expand = self.bn0 = None
        if exp_ratio != 1:
            self.expand = nn.Conv2d(in_features, hidden, 1, bias=False, dtype=dtype)
            self.bn0 = FlaxBatchNorm2d(hidden, 0.99, dtype=dtype)
        self.dw = DepthwiseConv(hidden, stride=stride, dtype=dtype)
        self.bn1 = FlaxBatchNorm2d(hidden, 0.99, dtype=dtype)
        self.project = nn.Conv2d(hidden, features, 1, bias=False, dtype=dtype)
        self.bn2 = FlaxBatchNorm2d(features, 0.99, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else F.relu6(self.bn0(self.expand(x)))
        y = F.relu6(self.bn1(self.dw(y)))
        y = self.bn2(self.project(y))
        return x + y if self.identity else y


class MobilenetV2(nn.Module):
    """MobileNetV2 at stride 8: the 3x3 stride-2 `stem` ConvBN (32, ReLU6),
    then inverted residuals `ir_0` .. `ir_9` (16/e1, 24/2, 24, 32/2, 32 x 2,
    64 x 4, expansion 6); with `scale_size=32`, 96/2, 96 x 2, 160/2, 160 x
    2, 320 more (also with `pretraining`, which adds the 1x1 `head_conv` to
    1280 channels with bias and no activation, the mean over H and W and
    `fc_out`)."""

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        plan = [(16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6),
                (32, 1, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6)]
        if scale_size == 32 or pretraining:
            plan += [(96, 2, 6), (96, 1, 6), (96, 1, 6),
                     (160, 2, 6), (160, 1, 6), (160, 1, 6), (320, 1, 6)]
        self.out_channels = plan[-1][0]
        self.stem = ConvBN(3, 32, dtype, stride=2, act=F.relu6)
        self._blocks, cin = [], 32
        for i, (f, st, e) in enumerate(plan):
            self.add_module(f"ir_{i}", InvertedResidual(cin, f, st, e, dtype))
            self._blocks.append(f"ir_{i}")
            cin = f
        self.head_conv = self.fc_out = None
        if pretraining:
            self.head_conv = nn.Conv2d(cin, 1280, 1, dtype=dtype)
            self.fc_out = nn.Linear(1280, 1000, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self._blocks:
            x = getattr(self, name)(x)
        return x if self.fc_out is None else _mean_head(self.head_conv(x), self.fc_out)


class MobilenetThin(nn.Module):
    """MobileNet-Thin, the backbone of MobilenetThinOpenpose: the stride-2
    `stem` ConvBN (32) and separable blocks `sep_0` .. `sep_10` (64, 128/2,
    128, 256/2, 256, 512 x 6); its features are the concat of `sep_2`
    max-pooled to stride 8, `sep_6` and the last block: 128 + 512 + 512 =
    1152 channels. `scale_size=32` (or `pretraining`, which adds no head)
    strides `sep_5` and `sep_8` as the flax module does (whose concat then
    fails in both packages)."""

    out_channels = 1152

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        s = 2 if scale_size == 32 or pretraining else 1
        self.stem = ConvBN(3, 32, dtype, stride=2)
        plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, s),
                (512, 1), (512, 1), (512, s), (512, 1), (512, 1)]
        self._blocks, cin = [], 32
        for i, (f, st) in enumerate(plan):
            self.add_module(f"sep_{i}", SeparableBlock(cin, f, st, dtype=dtype))
            self._blocks.append(f"sep_{i}")
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, feats = self.stem(x), []
        for i, name in enumerate(self._blocks):
            x = getattr(self, name)(x)
            if i == 2:
                feats.append(_max_pool(x))
            elif i == 6:
                feats.append(x)
        return torch.cat(feats + [x], dim=1)


class MobilenetSmall(nn.Module):
    """MobileNet-Small, the backbone of MobilenetSmallOpenpose, at stride 4:
    the stride-2 `stem` ConvBN (32) and separable blocks `sep_0` (64),
    `sep_1` (128/2), `sep_2` (128), `sep_3` (256/2), `sep_4` (256), `sep_5`
    and `sep_6` (512, strided at `scale_size=32` and with `pretraining`,
    where the concat fails in both packages); its features are the
    concat of `sep_0` max-pooled, `sep_2`, and `sep_6` resized x2 by
    nearest neighbour: 64 + 128 + 512 = 704 channels (368x432 -> 92x108)."""

    out_channels = 704

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32,
                 pretraining: bool = False):
        super().__init__()
        s = 2 if scale_size == 32 or pretraining else 1
        self.stem = ConvBN(3, 32, dtype, stride=2)
        plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, s), (512, s)]
        cin = 32
        for i, (f, st) in enumerate(plan):
            self.add_module(f"sep_{i}", SeparableBlock(cin, f, st, dtype=dtype))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.sep_0(self.stem(x))
        feats = [_max_pool(x)]
        x = self.sep_2(self.sep_1(x))
        feats.append(x)
        x = self.sep_6(self.sep_5(self.sep_4(self.sep_3(x))))
        feats.append(jax_resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3])))
        return torch.cat(feats, dim=1)


def jax_resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NCHW x resized to `out_hw` by nearest neighbour as
    `jax.image.resize(..., "nearest")` resizes: output pixel i reads input
    floor((i + 0.5) * in / out), which is `F.interpolate`'s "nearest-exact"
    (its "nearest", floor(i * in / out), differs at ratios that are not
    whole numbers)."""
    return F.interpolate(x, size=tuple(out_hw), mode="nearest-exact")


# -- checkpoint remaps (numpy, on the flat flax layout) ------------------------

def _phase_pack_kernel(k: np.ndarray) -> np.ndarray:
    """Phase-decompose a full-resolution 3x3 stride-1 SAME conv kernel
    [3, 3, Cin, Cout] into the equivalent 3x3 conv on the 2x2-packed grid,
    [3, 3, 4*Cin, 4*Cout], channel = (phase_y*2 + phase_x)*C + c.

    Full-res output p = 2q + d reads in(2q + d + u) through tap u; with
    d + u = 2s + e that is tap s+1 of the packed kernel on input phase e.
    SAME padding on the packed grid zeroes exactly the taps full-res SAME
    padding zeroes (even H and W)."""
    kh, kw, cin, cout = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expected a 3x3 kernel, got {kh}x{kw}")
    out = np.zeros((3, 3, 4 * cin, 4 * cout), k.dtype)
    for dy in (0, 1):
        for dx in (0, 1):
            for uy in (-1, 0, 1):
                for ux in (-1, 0, 1):
                    sy, ey = divmod(dy + uy, 2)
                    sx, ex = divmod(dx + ux, 2)
                    out[sy + 1, sx + 1,
                        (ey * 2 + ex) * cin:(ey * 2 + ex + 1) * cin,
                        (dy * 2 + dx) * cout:(dy * 2 + dx + 1) * cout] \
                        += k[uy + 1, ux + 1]
    return out


def _tile_phases(v: np.ndarray) -> np.ndarray:
    """Per-channel BN array [C] -> per-phase-packed [4*C]."""
    return np.tile(np.asarray(v), 4)


def _fold_bn(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps=1e-5):
    """Fold inference BatchNorm into conv kernel + bias."""
    s = np.asarray(bn_scale) / np.sqrt(np.asarray(bn_var) + eps)
    return (np.asarray(kernel, np.float32) * s,
            np.asarray(bn_bias) - np.asarray(bn_mean) * s)


def remap_vggtiny_to_s2d(src) -> dict[str, np.ndarray]:
    """VggTiny weights -> `VggTinyS2DStem` weights computing the same
    function: backbone/block_{0,1} become backbone/s2d_{0,1} (phase-packed
    kernels, BN arrays tiled 4x); every other key passes through.

    `src` is anything `read_flax_weights` takes (an npz path, a flat or
    nested dict of a whole model); returns a new flat dict."""
    flat = read_flax_weights(src)
    for i in (0, 1):
        pre, s2d = f"backbone/block_{i}", f"backbone/s2d_{i}"
        flat[f"params/{s2d}/conv/kernel"] = _phase_pack_kernel(
            np.asarray(flat.pop(f"params/{pre}/conv/kernel")))
        for leaf in ("scale", "bias"):
            flat[f"params/{s2d}/bn/{leaf}"] = _tile_phases(
                flat.pop(f"params/{pre}/bn/{leaf}"))
        for leaf in ("mean", "var"):
            key = f"batch_stats/{pre}/bn/{leaf}"
            if key in flat:
                flat[f"batch_stats/{s2d}/bn/{leaf}"] = _tile_phases(flat.pop(key))
    return flat


def remap_vggtiny_to_fused(src) -> dict[str, np.ndarray]:
    """VggTiny weights -> `VggTinyFusedStem` weights computing the same
    function at inference.

    block_0 (conv+BN) -> conv0p: W0p[dy, kq, 3*px+ci, 32*(off+1)+co] =
    W0fold[dy, dx+1, ci, co] at dx = 2*(kq-1)+px-off when |dx| <= 1, else 0.
    block_1 (conv+BN) -> (w1p, b1p): per dy the 128x128 matrix from the lane
    layout [x=2q-1 | 2q | 2q+1 | 2q+2] x 32 to [x=2q | 2q+1] x 64, with
    W1p[dy][32*(off+1)+ci, 64*p+co] = W1fold[dy, off-p+1, ci, co].
    backbone/block_{0,1} leave both collections; every other key passes
    through. `src` as in `remap_vggtiny_to_s2d`."""
    flat = read_flax_weights(src)

    def folded(i):
        p, s = f"params/backbone/block_{i}", f"batch_stats/backbone/block_{i}"
        return _fold_bn(flat.pop(f"{p}/conv/kernel"), flat.pop(f"{p}/bn/scale"),
                        flat.pop(f"{p}/bn/bias"), flat.pop(f"{s}/bn/mean"),
                        flat.pop(f"{s}/bn/var"))

    w0f, b0f = folded(0)     # (3,3,3,32), (32,)
    w1f, b1f = folded(1)     # (3,3,32,64), (64,)

    w0p = np.zeros((3, 3, 6, 128), np.float32)
    for kq in range(3):
        for px in range(2):
            for off in (-1, 0, 1, 2):
                dx = 2 * (kq - 1) + px - off
                if abs(dx) <= 1:
                    lo = 32 * (off + 1)
                    w0p[:, kq, 3 * px: 3 * px + 3, lo: lo + 32] = w0f[:, dx + 1]

    w1p = np.zeros((3, 128, 128), np.float32)
    for off in (-1, 0, 1, 2):
        for p in range(2):
            dx = off - p
            if abs(dx) <= 1:
                w1p[:, 32 * (off + 1): 32 * (off + 1) + 32,
                    64 * p: 64 * p + 64] = w1f[:, dx + 1]

    flat["params/backbone/conv0p/kernel"] = w0p
    flat["params/backbone/conv0p/bias"] = np.tile(b0f, 4)
    flat["params/backbone/w1p"] = w1p
    flat["params/backbone/b1p"] = np.tile(b1f, 2)
    return flat


# Name -> class, keyed by the reference's BACKBONE enum names as the JAX
# package's `BACKBONES` (reference: Config/define.py:3-15).
BACKBONES: dict[str, type[nn.Module]] = {
    "Mobilenetv1": MobilenetV1,
    "Mobilenetv2": MobilenetV2,
    "MobilenetDilated": MobilenetDilated,
    "MobilenetThin": MobilenetThin,
    "MobilenetSmall": MobilenetSmall,
    "Vggtiny": VggTiny,
    "VggtinyS2D": VggTinyS2D,
    "Vgg19": Vgg19,
    "Vgg16": Vgg16,
    "Resnet18": Resnet18,
    "Resnet50": Resnet50,
}
