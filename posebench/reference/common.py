"""What the plain reference networks share: flax-layout weights as torch
tensors, one place that computes every conv (so the same forward can count
operations, or run with its conv operands rounded to a lower precision), and
the layers the OpenPose family is built from. Plain PyTorch, float32 with
TF32 off; it imports nothing of the port."""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5


@contextlib.contextmanager
def exact_float32():
    """Float32 matmuls and convs in full float32: TF32 off while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_torch(flat: dict, device, dtype=torch.float32) -> dict:
    """Flat flax weights {"params/.../kernel": HWIO, ...} (numpy or torch) ->
    the same keys as torch tensors on `device`, conv kernels as OIHW."""
    out = {}
    for k, v in flat.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
        t = t.to(device=device, dtype=dtype)
        if k.endswith("kernel") and t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        out[k] = t
    return out


def round_through(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` rounded to `dtype` and back to float32, the gradient passed
    straight through. A float8 type is scaled per tensor so that its largest
    magnitude maps to the type's largest finite value, as an fp8 path
    would."""
    with torch.no_grad():
        if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            s = t.abs().amax().clamp(min=1e-12) / torch.finfo(dtype).max
            r = (t / s).to(dtype).to(torch.float32) * s
        else:
            r = t.to(dtype).to(torch.float32)
    return t + (r - t).detach() if t.requires_grad else r


class Arith:
    """How the reference computes a conv: in float32, or with both operands
    rounded to `round_to` first (a lower precision, for the control)."""

    def __init__(self, round_to: torch.dtype | None = None):
        self.round_to = round_to

    def conv(self, x, w, b=None, stride: int = 1):
        if self.round_to is not None:
            x, w = round_through(x, self.round_to), round_through(w, self.round_to)
        return F.conv2d(x, w, b, stride, w.shape[-1] // 2)


class OpCounter(Arith):
    """Counts 2 x the multiply-adds of every conv."""

    def __init__(self):
        super().__init__()
        self.operations = 0

    def conv(self, x, w, b=None, stride: int = 1):
        out = F.conv2d(x, w, b, stride, w.shape[-1] // 2)
        self.operations += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out


def conv_operations(forward, shapes: dict, images_shape, device) -> int:
    """2 x the conv multiply-adds of one `forward(weights, x, arith)` on NHWC
    images of `images_shape`, counted from a run on zeros on `device`."""
    weights = {k: torch.zeros(s, device=device) for k, s in shapes.items()}
    weights = {k: (v.permute(3, 2, 0, 1) if k.endswith("kernel") and v.ndim == 4 else v)
               for k, v in weights.items()}
    counter = OpCounter()
    with torch.no_grad():
        forward(weights, torch.zeros(images_shape, device=device), counter)
    return counter.operations


def batchnorm(x, w: dict, key: str, train: bool = False):
    """Flax BatchNorm at `key` (params .../scale, .../bias; batch_stats
    .../mean, .../var). Eval: the running statistics. Train: the batch's
    mean and biased variance over N, H, W, in float32."""
    scale, bias = w[f"params/{key}/scale"], w[f"params/{key}/bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    else:
        mean, var = w[f"batch_stats/{key}/mean"], w[f"batch_stats/{key}/var"]
    mul = torch.rsqrt(var + BN_EPS) * scale
    return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)


def conv(x, w: dict, key: str, arith: Arith, stride: int = 1):
    """A flax conv at `key` with its bias where it has one."""
    return arith.conv(x, w[f"params/{key}/kernel"], w.get(f"params/{key}/bias"), stride)


def max_pool(x):
    """flax max_pool((2, 2), (2, 2), "SAME"): pads at the end on odd sizes."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def nhwc(x):
    return x.permute(0, 2, 3, 1)
