"""Post-training int8 quantization for serving on the GPU.

Counterpart of `hyperpose_tpu/quant.py` (reference: export_tflite.py:29-41,
int8 TFLite calibrated on a representative dataset): symmetric int8 with a
per-tensor activation scale and a per-output-channel weight scale, every
calibrated convolution run as s8 x s8 -> s32. PyTorch has no int8
convolution on CUDA, so `Int8Conv2d` runs each one on hand-written kernels
(`ops/kernels/int8_gemm.py`): a one-pass quantize into int8 NHWC, then an
implicit-GEMM conv whose epilogue dequantizes, adds the bias and casts to
the activation dtype; a depthwise conv is one kernel, `int8_dwconv`, which
quantizes its input as it reads it.

Scale tables are keyed by the flax module path of each conv, which is the
port's module name with "." -> "/" (the weight bridge relies on the names
matching), so a table calibrated by either package serves both, and the
int8 artifact (`export_quantized`) has the JAX package's npz format.

Usage::

    qeng = quantize_engine(engine, [frames_u8])   # a new, int8 engine
    # or: PoseEngine(model, weights, quant_scales=scales)
"""
from __future__ import annotations

import copy
import json
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from .ops.kernels.int8_gemm import (
    conv_out_hw, dw_channels, int8_conv, int8_conv_plain, int8_dwconv, int8_dwconv_plain,
    int8_quantize, padded_channels,
)
from .parallel import spatial
from .utils.weights import read_flax_weights, state_dict_to_flax

Skip = Callable[[str], bool]
_FOLD_CIN = 16   # Int8Conv2d folds the taps of convs on at most this many channels


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def weight_scales(kernel) -> tuple[np.ndarray, np.ndarray]:
    """A float32 HWIO kernel [kh, kw, cin, cout] (depthwise: [kh, kw, 1, C])
    -> (w_q int8 HWIO, s_w float32 [cout]): s_w = max(max |k| over H, W, I,
    1e-8) / 127 and
    w_q = clip(round(k / s_w), -127, 127), in float32 with ties to even, as
    the JAX package quantizes (`quant.py:133-137`, `:227-230`)."""
    k = np.asarray(kernel, np.float32)
    s_w = np.maximum(np.abs(k).max(axis=(0, 1, 2)), np.float32(1e-8)) / np.float32(127.0)
    w_q = np.clip(np.round(k / s_w), -127, 127).astype(np.int8)
    return w_q, s_w.astype(np.float32)


class Int8Conv2d(nn.Module):
    """A calibrated `nn.Conv2d` in int8: the counterpart of JAX
    `_quantized_conv` (`quant.py:127-157`).

    Holds the int8 weights [Np, kh, kw, Cp] (`w_taps`; the buffer `w_q` is
    their 2-D view [Np, kh*kw*Cp], which a channels-last conversion of the
    model leaves contiguous): Np = cout rounded up to 8 and Cp =
    `padded_channels(cin)`, zero where padded; the float32 per-channel scale
    s_w; dq = s_w * float32(s_in); the float32 bias; the conv's stride,
    padding and dilation. A conv on at most 16 input channels with a filter
    larger than 1x1 is `folded`: its weights are [Np, 1, 1, Cp] with the
    taps along K. The forward of a dense conv runs two stages, each a
    method, so a caller can time them:

    1. `quantize`: x * float32(1 / s_in), rounded half to even, clipped to
       +-127, written as int8 [B, H, W, Cp] (`int8_quantize`; folded, the
       filter's kh * kw * cin values of each output pixel, [B, Ho, Wo, Cp]);
    2. `conv`: the conv of that buffer, dequantized (s32 * dq + bias in
       float32) and cast to the input's dtype in the same kernel, as
       [B*Ho*Wo, cout] (`int8_conv`), returned as its NCHW view
       (channels-last memory, no transposing copy).

    A depthwise conv (`depthwise`: one filter a channel, w_q [kh, kw, 1, C])
    holds its taps as [kh * kw, Cp] (`w_q`; `w_taps` [kh, kw, Cp]), Cp = C
    rounded up to 32, and its forward is one launch of `int8_dwconv`, which
    quantizes x as it reads it (no int8 buffer), with the same epilogue and
    output. Its two stages stay for the tests and the exact sums: `quantize`
    and `conv_plain` are its plain version, step by step.

    A grouped conv (1 < `groups` < channels, JAX's `feature_group_count`)
    holds one dense `Int8Conv2d` a group in `parts`, each on its slice of the
    input channels (padded to 32 on its own) with the layer's s_in and its
    output channels' weight scales; its `rows` runs theirs and sets their
    outputs side by side, and it has no stages of its own.

    On a CUDA tensor each stage runs its kernel or raises: there is no float
    fallback. `int8_conv_sums_plain(xq, q.w_taps, *q.taps_geometry)` gives
    the exact s32 sums of stage 2 (`int8_dwconv_sums_plain` where
    depthwise)."""

    def __init__(self, w_q: np.ndarray, s_w: np.ndarray, bias, s_in: float,
                 stride=1, padding=0, dilation=1, depthwise: bool = False, groups: int = 1):
        super().__init__()
        kh, kw, cin, cout = w_q.shape
        self.depthwise = depthwise
        if depthwise:
            if cin != 1:
                raise ValueError(f"a depthwise kernel is [kh, kw, 1, C], got {w_q.shape}")
            cin = cout
        self.groups = 1 if depthwise else int(groups)
        if cout % self.groups:
            raise ValueError(f"{cout} output channels in {self.groups} groups")
        self.kernel_size, self.in_channels = (kh, kw), cin * self.groups
        self.out_channels = cout
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation = _pair(dilation)
        self.s_in = float(s_in)
        self.inv_s = float(np.float32(1.0 / self.s_in))
        self.parts = None
        if self.groups > 1:
            # One dense int8 conv a group on its channel slice, each with the
            # layer's s_in and its own output channels' weight scales.
            n = cout // self.groups
            bias = None if bias is None else np.asarray(bias, np.float32)
            self.parts = nn.ModuleList(
                Int8Conv2d(w_q[..., g * n:(g + 1) * n], np.asarray(s_w)[g * n:(g + 1) * n],
                           None if bias is None else bias[g * n:(g + 1) * n], s_in,
                           stride, padding, dilation)
                for g in range(self.groups))
            self.folded = False
            for name in ("w_q", "s_w", "dq", "bias"):
                self.register_buffer(name, None)
            return
        # A conv on a few input channels (the networks' first convs) folds its
        # taps into the quantized buffer's channels and runs as 1x1: the
        # conv kernel then loads one wide box per tile instead of kh * kw
        # boxes of 32 bytes that hold cin values each.
        self.folded = (kh, kw) != (1, 1) and cin <= _FOLD_CIN and not depthwise
        np_ = -(-cout // 8) * 8
        w_t = np.asarray(w_q, np.int8).transpose(3, 0, 1, 2)  # [cout, kh, kw, cin]
        if depthwise:
            w = np.zeros((kh * kw, dw_channels(cout)), np.int8)
            w[:, :cout] = np.asarray(w_q, np.int8).reshape(kh * kw, cout)
        elif self.folded:
            w = np.zeros((np_, 1, 1, padded_channels(kh * kw * cin)), np.int8)
            w[:cout, 0, 0, :kh * kw * cin] = w_t.reshape(cout, -1)
        else:
            w = np.zeros((np_, kh, kw, padded_channels(cin)), np.int8)
            w[:cout, :, :, :cin] = w_t
        s_w = np.asarray(s_w, np.float32)
        self.register_buffer("w_q", torch.from_numpy(w.reshape(w.shape[0], -1)))
        self.register_buffer("s_w", torch.from_numpy(s_w.copy()))
        self.register_buffer("dq", torch.from_numpy(s_w * np.float32(self.s_in)))
        self.register_buffer("bias", None if bias is None else
                             torch.from_numpy(np.array(bias, np.float32)))

    @classmethod
    def from_conv(cls, conv: nn.Conv2d, kernel, bias, s_abs: float) -> "Int8Conv2d":
        """Replace `conv`, whose float32 weights are `kernel` (flax HWIO)
        and `bias` (or None), calibrated to input abs-max `s_abs`."""
        depthwise = conv.groups == conv.in_channels == conv.out_channels > 1
        if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
            raise NotImplementedError(
                f"Int8Conv2d takes explicit zero padding, not {conv.padding!r} "
                f"({conv.padding_mode})")
        kernel = np.asarray(kernel, np.float32)
        if kernel.shape != tuple(conv.weight.shape[i] for i in (2, 3, 1, 0)):
            raise ValueError(f"kernel {kernel.shape} does not fit the conv's "
                             f"weight {tuple(conv.weight.shape)}")
        w_q, s_w = weight_scales(kernel)
        q = cls(w_q, s_w, bias, s_abs / 127.0, conv.stride, conv.padding,
                conv.dilation, depthwise, conv.groups)
        return q.to(conv.weight.device)

    def with_padding(self, padding) -> "Int8Conv2d":
        """This conv with another zero padding, sharing its buffers (and, where
        grouped, its groups' buffers): a row-sharded forward runs it on rows
        that carry their halo, with no row padding."""
        q = copy.copy(self)
        q.padding = _pair(padding)
        if self.parts is not None:
            q._modules = dict(self._modules)
            q.parts = nn.ModuleList(p.with_padding(padding) for p in self.parts)
        return q

    @property
    def w_taps(self) -> torch.Tensor:
        """The int8 weights as [Np, kh, kw, Cp], a view of `w_q` (folded:
        [Np, 1, 1, Cp], Cp >= kh * kw * cin in (dy, dx, c) order; depthwise:
        [kh, kw, Cp])."""
        if self.depthwise:
            return self.w_q.view(*self.kernel_size, -1)
        taps = (1, 1) if self.folded else self.kernel_size
        return self.w_q.view(self.w_q.shape[0], *taps, -1)

    @property
    def fold(self):
        """The `fold` argument of `int8_quantize`: the conv's (kernel_size,
        stride, padding, dilation) where folded, else None."""
        if self.folded:
            return self.kernel_size, self.stride, self.padding, self.dilation
        return None

    @property
    def taps_geometry(self) -> tuple:
        """(stride, padding, dilation) of the conv `int8_conv` runs on the
        quantized buffer: 1x1, stride 1, no padding where folded."""
        if self.folded:
            return (1, 1), (0, 0), (1, 1)
        return self.stride, self.padding, self.dilation

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        return conv_out_hw(h, w, self.kernel_size, self.stride, self.padding, self.dilation)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW x -> int8 [B, H, W, Cp], channels >= C zero (folded:
        [B, Ho, Wo, Cp], see `int8_quantize_plain`)."""
        self._ungrouped("quantize")
        if x.shape[1] != self.in_channels:
            raise ValueError(f"Int8Conv2d: {x.shape[1]} input channels, "
                             f"expected {self.in_channels}")
        return int8_quantize(x, self.inv_s, self.w_taps.shape[-1], self.fold)

    def _ungrouped(self, what: str) -> None:
        if self.parts is not None:
            raise TypeError(f"Int8Conv2d.{what}: a grouped conv runs its groups' stages "
                            "(`parts`)")

    def conv(self, xq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """A dense conv's stage 2: the quantized buffer -> [B*Ho*Wo, cout] in
        `dtype` (`int8_conv`). A depthwise conv has no such stage."""
        self._ungrouped("conv")
        if self.depthwise:
            raise TypeError("Int8Conv2d.conv: a depthwise conv runs fused from x "
                            "(`rows`); its stage 2 is `conv_plain`")
        return int8_conv(xq, self.w_taps, self.dq, self.bias, *self.taps_geometry, dtype)

    def conv_plain(self, xq: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Stage 2's plain version, on any device."""
        self._ungrouped("conv_plain")
        fn = int8_dwconv_plain if self.depthwise else int8_conv_plain
        return fn(xq, self.w_taps, self.dq, self.bias, *self.taps_geometry, dtype)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW x -> [B*Ho*Wo, cout] in x's dtype on the kernels: one
        `int8_dwconv` where depthwise, else `quantize` then `conv` (where
        grouped, those of each group on its channel slice, the groups'
        outputs side by side)."""
        if self.parts is not None:
            if x.shape[1] != self.in_channels:
                raise ValueError(f"Int8Conv2d: {x.shape[1]} input channels, "
                                 f"expected {self.in_channels}")
            n = self.in_channels // self.groups
            return torch.cat([p.rows(x[:, g * n:(g + 1) * n])
                              for g, p in enumerate(self.parts)], dim=1)
        if not self.depthwise:
            return self.conv(self.quantize(x), x.dtype)
        if x.shape[1] != self.in_channels:
            raise ValueError(f"Int8Conv2d: {x.shape[1]} input channels, "
                             f"expected {self.in_channels}")
        return int8_dwconv(x, self.inv_s, self.w_taps, self.dq, self.bias,
                           *self.taps_geometry)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if spatial.active() is not None:
            # this rank's rows of the image with the rows the kernels read of
            # the neighbours, and no row padding (`parallel/spatial.py`)
            span = self.dilation[0] * (self.kernel_size[0] - 1) + 1
            x = spatial.window(x, span, self.stride[0], self.padding[0], 0.0, "int8 conv")
            with spatial.routed():
                return self.with_padding((0, self.padding[1]))._run(x)
        return self._run(x)

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        ho, wo = self.out_hw(h, w)
        return self.rows(x).view(b, ho, wo, -1).permute(0, 3, 1, 2)


# -- calibration ------------------------------------------------------------------

def _conv_path(name: str) -> str:
    return name.replace(".", "/")


def calibrate(model: nn.Module, batches: Iterable, forward: Callable | None = None
              ) -> dict[str, float]:
    """Run `forward(batch)` (default `model(batch)`) on each batch,
    recording the abs-max (in float32) of every `nn.Conv2d` input by forward
    pre-hooks. Returns {flax module path: absmax}, the activation scale table
    (JAX `calibrate`, `quant.py:67-83`)."""
    stats: dict[str, torch.Tensor] = {}

    def observer(path):
        def hook(_module, args):
            amax = args[0].detach().to(torch.float32).abs().amax()
            stats[path] = amax if path not in stats else torch.maximum(stats[path], amax)
        return hook

    hooks = [m.register_forward_pre_hook(observer(_conv_path(name)))
             for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]
    try:
        with torch.inference_mode():
            for batch in batches:
                (forward or model)(batch)
    finally:
        for h in hooks:
            h.remove()
    return {k: float(v) for k, v in stats.items()}


def calibrate_engine(engine, batches_u8: Iterable) -> dict[str, float]:
    """Calibrate through a `PoseEngine`'s own forward: uint8 [B, H, W, 3]
    batches, /255 in the model dtype for the PAF family, the engine's
    `fused_decode` for PifPaf (JAX `calibrate_engine`, `quant.py:86-102`)."""

    def forward(b):
        x = torch.as_tensor(b).to(engine.device)
        if engine.fused_decode is not None:
            engine.fused_decode(x)
        else:
            engine.model(x.to(engine.dtype) / 255.0)

    return calibrate(engine.model, batches_u8, forward)


# -- quantized model and engine -----------------------------------------------------

def quantize_model(model: nn.Module, scales: dict[str, float],
                   skip: Skip | None = None, weights=None) -> nn.Module:
    """Swap, in place, every `nn.Conv2d` of `model` whose path has a nonzero
    scale and is not skipped for an `Int8Conv2d` (JAX `make_interceptor` /
    `quantized_apply`, `quant.py:160-199`); returns `model`.

    The weights are quantized from float32 values, as JAX quantizes its
    float32 parameters: `weights` (flax layout, anything `read_flax_weights`
    takes), or the model's own when every conv weight is float32. A bf16
    model without `weights` raises instead of quantizing rounded weights."""
    convs = [(name, m) for name, m in model.named_modules() if isinstance(m, nn.Conv2d)
             and scales.get(_conv_path(name)) and not (skip and skip(_conv_path(name)))]
    if not convs:
        return model
    if weights is not None:
        flat = read_flax_weights(weights)
    elif all(m.weight.dtype == torch.float32 for _, m in convs):
        flat = state_dict_to_flax(model.state_dict())
    else:
        raise ValueError(
            "quantizing a model whose weights are not float32 needs its float32 "
            "flax-layout weights (give the engine `variables`): the JAX package "
            "quantizes the float32 checkpoint, not rounded weights")
    for name, conv in convs:
        path = _conv_path(name)
        kernel = flat[f"params/{path}/kernel"]
        bias = None if conv.bias is None else flat[f"params/{path}/bias"]
        parent_name, _, attr = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, attr, Int8Conv2d.from_conv(conv, kernel, bias, scales[path]))
    return model


def quantize_engine(engine, batches_u8: Iterable, skip: Skip | None = None):
    """Calibrate on representative uint8 batches and return an int8 clone of
    the engine (JAX `quantize_engine`, `quant.py:105-120`): the same
    weights, decoder and options on a deep copy of the model, every
    calibrated conv in int8. The original engine is untouched.

    A `fused_decode` closes over its model, so it must carry a
    `rebuild(model)` attribute that makes the same step on the clone
    (`pifpaf_fused_decode` does)."""
    from .runtime.engine import PoseEngine

    scales = calibrate_engine(engine, batches_u8)
    if skip is not None:
        scales = {k: v for k, v in scales.items() if not skip(k)}
    model = copy.deepcopy(engine.model)
    fused = engine.fused_decode
    if fused is not None:
        if not hasattr(fused, "rebuild"):
            raise ValueError("quantize_engine: the engine's fused_decode has no "
                             "rebuild(model) to make its step on the int8 clone")
        fused = fused.rebuild(model)
    return PoseEngine(
        model, engine.variables, input_hw=engine.input_hw,
        max_batch_size=engine.max_batch_size, decoder=engine.decoder,
        topology=engine.topology, keep_ratio=engine.keep_ratio,
        fused_decode=fused, quant_scales=scales,
        input_format=engine.input_format, device=engine.device,
    )


# -- export (int8 weights + scale table, the JAX package's npz format) -------------

def _keystr(flat_key: str) -> str:
    """"params/a/conv/kernel" -> "['params']['a']['conv']['kernel']", the
    text `jax.tree_util.keystr` gives the same leaf of a nested dict."""
    return "".join(f"[{k!r}]" for k in flat_key.split("/"))


def export_quantized(variables, scales: dict[str, float], path: str) -> str:
    """Save an int8 serving artifact (JAX `export_quantized`,
    `quant.py:206-239`): each calibrated conv kernel as `q::<path>::w_q`
    (int8 HWIO) and `q::<path>::s_w`, every float leaf as `f::` + its
    `keystr`, the scale table as JSON bytes in `__scales__`; compressed npz.
    Each package loads the other's artifact. The weights come from
    `variables` (flax layout, anything `read_flax_weights` takes), so no
    model is needed."""
    flat = read_flax_weights(variables)
    out: dict[str, np.ndarray] = {}
    for p, amax in scales.items():
        if not amax:
            continue
        out[f"q::{p}::w_q"], out[f"q::{p}::s_w"] = weight_scales(flat[f"params/{p}/kernel"])
    for k, v in flat.items():
        out["f::" + _keystr(k)] = np.asarray(v)
    out["__scales__"] = np.frombuffer(json.dumps(scales).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)
    return path


def load_quantized(path: str) -> tuple[dict[str, float], dict[str, np.ndarray]]:
    """The int8 artifact: (activation scale table, flat tensor dict keyed as
    `export_quantized` writes)."""
    with np.load(path) as z:
        scales = json.loads(bytes(z["__scales__"]).decode())
        tensors = {k: z[k] for k in z.files if k != "__scales__"}
    return scales, tensors


def dequantized_params(variables, tensors: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """A new flat flax-layout weight dict: `variables` with each quantized
    conv kernel replaced by s_w * w_q, which re-quantizes to the same w_q."""
    flat = {k: np.array(v) for k, v in read_flax_weights(variables).items()}
    for p in {k.split("::")[1] for k in tensors if k.startswith("q::")}:
        flat[f"params/{p}/kernel"] = (tensors[f"q::{p}::w_q"].astype(np.float32)
                                      * tensors[f"q::{p}::s_w"])
    return flat
