"""`hyperpose_torch/utils/tf_lower.py` on the forms the served networks do not
all reach: grouped and depthwise convs with a multiplier, pads that are not
TF's SAME, ceil-mode and padded max pools on odd sizes, a BatchNorm after no
conv, the nearest resize at a ratio that is not whole, and the layout
bookkeeping of views, selects, reductions and concats. Each tiny network's
emitted TF function is held to its torch forward within 1e-5 x max(1, max
|ref|) (float32 sums in another order), and its plan to the TF ops expected.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import torch_parity  # noqa: F401  (single-threaded torch)
from hyperpose_torch.models.backbones import FlaxBatchNorm2d
from hyperpose_torch.utils import tf_lower

tf = pytest.importorskip("tensorflow")


class _Net(nn.Module):
    """NHWC input -> NCHW, `body`, -> a dict of its outputs."""

    def __init__(self, body, **mods):
        super().__init__()
        self.body = body
        for k, m in mods.items():
            setattr(self, k, m)

    def forward(self, x):
        return self.body(self, x.permute(0, 3, 1, 2))


def _grouped(m, x):
    y = m.g(x)                                          # groups 2: split, convs, concat
    y = m.s(F.pad(y, (0, 1, 2, 0)))                     # not SAME: Pad, VALID
    return {"y": y, "z": m.d(x)}                        # depthwise x2, dilation 2


def _pools(m, x):
    a = F.max_pool2d(x, 3, 2, padding=1, ceil_mode=True)
    b = F.max_pool2d(x, 2, 2, ceil_mode=True)           # odd size: TF's SAME
    return {"a": a, "b": b, "c": F.max_pool2d(F.pad(x, (1, 0, 0, 1), value=-np.inf), 2, 1)}


def _activations(m, x):
    y = m.bn(torch.relu(m.c(x)))                        # BN after no conv
    return {"y": F.hardtanh(y, -0.5, 0.5), "l": F.leaky_relu(y, 0.2),
            "s": torch.sigmoid(y) / 3.0 - 0.25, "p": torch.where(y >= 0, y, m.alpha * y)}


def _layout(m, x):
    y = m.c(x)                                          # [B, 4, H, W]
    flat = y.permute(0, 2, 1, 3).reshape(y.shape[0], y.shape[2], -1)   # merge apart: Transpose
    pick = y[:, 1].unsqueeze(1)                          # select, then unsqueeze
    top = y.amax(dim=(2, 3))                             # reduce over TF's H, W
    keep = y.amax(dim=1, keepdim=True)
    both = torch.cat([y, m.k.expand(y.shape[0], -1, y.shape[2], y.shape[3])], 1)
    return {"flat": flat, "pick": pick, "top": top, "keep": keep, "both": both,
            "tail": y[:, :, 1:, ::2].permute(0, 2, 3, 1)}


def _resize(m, x):
    return {"up": F.interpolate(x, scale_factor=2, mode="nearest-exact"),
            "odd": F.interpolate(x, size=(7, 11), mode="nearest-exact")}


CASES = {
    "grouped": (_grouped, dict(g=nn.Conv2d(4, 6, 3, padding=1, groups=2),
                               s=nn.Conv2d(6, 5, 3, stride=2),
                               d=nn.Conv2d(4, 8, 3, padding=2, dilation=2, groups=4)),
                (9, 11, 4), {"Conv2D", "DepthwiseConv2dNative", "ConcatV2", "PadV2"}),
    "pools": (_pools, {}, (7, 9, 3), {"MaxPool", "PadV2"}),
    "activations": (_activations, dict(c=nn.Conv2d(3, 4, 1), bn=FlaxBatchNorm2d(4),
                                       alpha=nn.Parameter(torch.rand(1, 4, 1, 1))),
                    (6, 5, 3), {"Mul", "AddV2", "ClipByValue", "LeakyRelu", "SelectV2"}),
    "layout": (_layout, dict(c=nn.Conv2d(3, 4, 1), k=nn.Parameter(torch.rand(1, 2, 1, 1))),
               (6, 5, 3), {"Transpose", "StridedSlice", "ExpandDims", "Max", "ConcatV2"}),
    "resize": (_resize, {}, (4, 6, 3), {"GatherV2"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lowering_case_equals_torch(case):
    body, mods, hwc, ops = CASES[case]
    torch.manual_seed(0)
    net = _Net(body, **mods).eval()
    bn = getattr(net, "bn", None)
    if bn is not None:
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
        bn.weight.data.uniform_(0.5, 1.5)
    x = np.random.default_rng(1).standard_normal((2, *hwc)).astype(np.float32)
    plan = tf_lower.plan_forward(net, x.shape)
    assert ops <= set(plan.histogram()), plan.histogram()
    got = {k: v.numpy() for k, v in tf_lower.tf_function(plan)(tf.constant(x)).items()}
    with torch.no_grad():
        want = {k: v.numpy() for k, v in net(torch.from_numpy(x)).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        tol = 1e-5 * max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)


def test_same_pads_are_xla_and_tf_same():
    """`same_pads` is `models/backbones.py` `same_pads` (XLA's SAME) and
    TF's: the widths an odd or even size takes at stride 1 and 2."""
    from hyperpose_torch.models.backbones import same_pads

    for n in (7, 8, 368, 432):
        for k, s in ((3, 1), (3, 2), (7, 2), (2, 2)):
            assert tf_lower.same_pads(n, k, s) == same_pads((n, n), k, s)[2:]
    assert tf_lower.same_pads(46, 3, 1, dilation=2) == (2, 2)
