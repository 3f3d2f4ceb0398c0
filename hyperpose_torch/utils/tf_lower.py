"""A port network's float32 forward lowered to TensorFlow ops, for the `.pb`
and `.tflite` exports (`utils/export.py`; the JAX package reaches TensorFlow
through jax2tf, `hyperpose_tpu/utils/export.py:62-130`). Two halves:

* `plan_forward(fn, input_shape)` captures the forward with `torch.export`,
  decomposes it to core ATen (`run_decompositions`) and walks the graph into
  a `Plan`: TensorFlow ops (`Step`) with their attributes, and the weights
  as numpy constants, every 4-D activation in NHWC. It imports no
  TensorFlow, so it runs wherever the module sits, the GPU included. An op
  with no lowering raises NotImplementedError naming it and the module that
  emitted it; nothing calls back into torch.
* `tf_function(plan)` emits the plan as a `tf.function` over one
  `tf.TensorSpec(input_shape, tf.float32, name=input_name)` that returns the
  forward's outputs as a dict, as jax2tf returns JAX's (a frozen graph's
  outputs `Identity`, `Identity_1`, ... are its keys in sorted order). It
  imports TensorFlow.

Layouts. The networks take NHWC images, permute them to NCHW and run NCHW;
TensorFlow's CPU `Conv2D` and `MaxPool` take NHWC only. Each value of the
plan carries `perm`, the order of its torch (logical) dims in the TF tensor:
a 4-D activation is NHWC, perm (0, 2, 3, 1). A torch `permute` only changes
perm, so the entry permute and the exit permute to NHWC maps cost no op;
`cat`, `view`, `slice`, `select`, `unsqueeze` and `index` act on the
matching TF axes, and a `Transpose` is emitted only where an op needs
another order (a `view` that merges dims apart in the TF tensor, an output).

Folds. An explicit pad (XLA's SAME, `models/backbones.py` `_same`) before a
conv (zeros) or a max pool (-inf) that equals TensorFlow's SAME pads for
that shape becomes `padding="SAME"`, so no -inf constant enters the graph
(the uint8 TFLite quantizer cannot take one); other pads are a `Pad` before
a VALID op. An eval-mode BatchNorm after a conv is folded into its weights
and bias, else a scale and a shift. A constant computed from weights or
shapes alone (PReLU's slope view, the nearest resize's indices) is evaluated
in torch when planned. The fused stem's `hyperpose::conv1_pool` becomes its
plain version's ops (`ops/kernels/conv1_pool.py` `conv1_pool_plain`): the
border mask, block_1 as a 3x1 conv, bias, ReLU, the max of the lane halves
and a 2x1 max pool.
"""
from __future__ import annotations

import copy
import math
import operator
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

NHWC = (0, 2, 3, 1)   # a 4-D NCHW activation's perm in the TF tensor


@dataclass
class Step:
    """One TensorFlow op: `op` (its TF name, a key of `_EMIT`) on the values
    `inputs` (ids of earlier steps' outputs, the input 0, or constants),
    with `attrs`, giving the value `out`."""
    op: str
    inputs: tuple
    attrs: dict
    out: int


@dataclass
class Plan:
    """A forward as TF ops: the input is value 0, NHWC float32
    `input_shape`; `outputs` maps the forward's keys to values (in torch's
    layout, float32); `consts` holds the weights and other constants by
    value id. `nodes` counts the captured graph's nodes and `unlowered`
    lists the ops that have no lowering ("op (module)"), which only a
    non-strict plan keeps instead of raising."""
    input_shape: tuple
    steps: list = field(default_factory=list)
    consts: dict = field(default_factory=dict)
    outputs: dict = field(default_factory=dict)
    nodes: int = 0
    unlowered: list = field(default_factory=list)

    def histogram(self) -> dict:
        """How many of each TF op the plan holds."""
        return dict(Counter(s.op for s in self.steps))


@dataclass
class _T:
    """A planned tensor: value `id`, torch shape `shape` and dtype, and
    `perm`: TF tensor = torch tensor.permute(perm)."""
    id: int
    shape: tuple
    perm: tuple
    dtype: torch.dtype

    def tf_shape(self) -> tuple:
        return tuple(self.shape[p] for p in self.perm)


@dataclass
class _Pad:
    """A `constant_pad_nd` held back for the conv or pool that reads it."""
    src: _T
    pads: tuple     # F.pad order: (left, right, top, bottom)
    value: float


class _Refused:
    """The value of an op with no lowering (non-strict plans; `what` None,
    already listed), or an output of a lowered op that has none (`what`
    names it; refused where something reads it)."""

    def __init__(self, what: str | None = None):
        self.what = what


def _identity(n: int) -> tuple:
    return tuple(range(n))


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class ExportForward(nn.Module):
    """`fn`'s outputs that are tensors, cast to float32: the JAX script's
    `fwd_f32` (`export_model.py:101-104`) over a port network or a callable
    on NHWC float32 images returning a dict."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        out = self.fn(x)
        return {k: v.to(torch.float32) for k, v in out.items()
                if not isinstance(v, (list, tuple))}


def float32_copy(fn):
    """`fn` itself, or a float32 copy of it when it is a module holding other
    floating parameters or buffers (a bf16 engine's model, whose weights the
    copy holds as they are, rounded to bf16), as exports are float32."""
    if not isinstance(fn, nn.Module):
        return fn
    floats = [t.dtype for t in (*fn.parameters(), *fn.buffers()) if t.is_floating_point()]
    if all(d == torch.float32 for d in floats):
        return fn
    from ..train.trainer import as_master

    return as_master(copy.deepcopy(fn))


def _device_of(fn) -> torch.device:
    if isinstance(fn, nn.Module):
        for t in (*fn.parameters(), *fn.buffers()):
            return t.device
    return torch.device("cpu")


def capture(fn, input_shape):
    """The float32 forward of `fn` (a module or callable, see
    `ExportForward`) on NHWC float32 `input_shape`, exported and decomposed
    to core ATen, on the device `fn` sits on."""
    fn = float32_copy(fn)
    module = ExportForward(fn).eval()
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=_device_of(fn))
    with torch.no_grad():
        program = torch.export.export(module, (x,), strict=False)
        return program.run_decompositions()


def plan_forward(fn, input_shape, strict: bool = True) -> Plan:
    """`capture` `fn` and lower the graph to a `Plan`. With `strict=False`
    an op that has no lowering is listed in `Plan.unlowered` (the plan then
    cannot be emitted) instead of raising NotImplementedError."""
    return _Lowering(capture(fn, input_shape), tuple(input_shape), strict).plan


def _module_of(node) -> str:
    stack = node.meta.get("nn_module_stack") or {}
    if not stack:
        return "the top-level forward"
    path, kind = list(stack.values())[-1]
    kind = getattr(kind, "__name__", str(kind).rsplit(".", 1)[-1].strip("'>"))
    return f"{path.replace('L__self__', 'self')} ({kind})"


def same_pads(n: int, kernel: int, stride: int, dilation: int = 1) -> tuple:
    """TensorFlow's (and XLA's) SAME pads (before, after) of one axis."""
    span = dilation * (kernel - 1) + 1
    total = max((-(-n // stride) - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


class _Lowering:
    """The graph walk behind `plan_forward`: one handler per ATen op."""

    def __init__(self, program, input_shape: tuple, strict: bool):
        self.strict = strict
        self.plan = Plan(input_shape=input_shape)
        self.ids = 1            # value 0 is the image
        self.transposed = {}    # (value id, perm) -> value id
        self.bn_folded = {}     # BatchNorm node -> its conv's folded output
        graph = program.graph
        self.plan.nodes = len(graph.nodes)
        sig = program.graph_signature
        named = {**sig.inputs_to_parameters, **sig.inputs_to_buffers,
                 **sig.inputs_to_lifted_tensor_constants}
        tables = {**program.state_dict, **program.constants}
        self.env = env = {}
        for node in graph.nodes:
            if node.op == "placeholder":
                if node.name in named:
                    env[node] = tables[named[node.name]].detach()
                elif node.name in sig.user_inputs:
                    env[node] = _T(0, input_shape, _identity(4), torch.float32)
                else:
                    raise NotImplementedError(f"graph input {node.name} is neither the "
                                              "image nor a weight")
            elif node.op == "call_function":
                env[node] = self._call(node, env)
            elif node.op == "output":
                self._outputs(program, node, env)

    # -- values ---------------------------------------------------------------
    def _new(self) -> int:
        self.ids += 1
        return self.ids - 1

    def const(self, arr) -> int:
        i = self._new()
        self.plan.consts[i] = np.asarray(arr, order="C")
        return i

    def step(self, op, inputs, out_shape, perm, dtype, /, **attrs) -> _T:
        """Append `op` on `inputs`; its output has torch shape `out_shape`
        and TF layout `perm`."""
        out = self._new()
        self.plan.steps.append(Step(op, tuple(inputs), attrs, out))
        return _T(out, tuple(out_shape), tuple(perm), dtype)

    def phys(self, t: _T, perm) -> int:
        """The id of `t` with TF layout `perm` (a Transpose where it differs)."""
        perm = tuple(perm)
        if t.perm == perm:
            return t.id
        key = (t.id, perm)
        if key not in self.transposed:
            order = [t.perm.index(p) for p in perm]
            self.transposed[key] = self.step("Transpose", [t.id], t.shape, perm, t.dtype,
                                             perm=order).id
        return self.transposed[key]

    def const_as(self, c, rank: int, perm, dtype) -> int:
        """Constant tensor (or number) `c` as `dtype`, broadcast to `rank`
        dims, in TF layout `perm`."""
        a = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
        a = a.astype(_np_dtype(dtype))
        if a.ndim:
            a = a.reshape((1,) * (rank - a.ndim) + a.shape).transpose(perm)
        return self.const(a)

    def _call(self, node, env):
        target = node.target
        name = "getitem" if target is operator.getitem else str(target)
        args = [_lookup(a, env) for a in node.args]
        kwargs = {k: _lookup(v, env) for k, v in node.kwargs.items()}
        if name == "getitem":
            return args[0] if isinstance(args[0], _Refused) else args[0][args[1]]
        flat = _flatten(args) + _flatten(list(kwargs.values()))
        refused = [a for a in flat if isinstance(a, _Refused)]
        if refused:
            named = [a.what for a in refused if a.what]
            return self._refuse(node, f"{name} on {named[0]}") if named else _Refused()
        if name == "aten._assert_tensor_metadata.default":
            return None
        if not any(isinstance(a, (_T, _Pad)) for a in flat):
            # Weights, shapes and indices alone: evaluated here in torch.
            with torch.no_grad():
                return target(*args, **kwargs)
        handler = _HANDLERS.get(name)
        if handler is None:
            return self._refuse(node, name)
        out = handler(self, node, *args, **kwargs)
        if out is NotImplemented:
            return self._refuse(node, name)
        return out

    def _refuse(self, node, name):
        where = f"{name} (emitted by {_module_of(node)})"
        if self.strict:
            raise NotImplementedError(f"no TensorFlow lowering for {where}")
        self.plan.unlowered.append(where)
        return _Refused()

    def _outputs(self, program, node, env):
        from torch.utils import _pytree

        outs = _pytree.tree_unflatten([_lookup(a, env) for a in node.args[0]],
                                      program.call_spec.out_spec)
        for key, v in outs.items():
            if isinstance(v, _Refused):
                if v.what:
                    self._refuse(node, f"output {key!r}: {v.what}")
                continue
            if isinstance(v, torch.Tensor):
                self.plan.outputs[key] = self.const(v.cpu().numpy())
                continue
            v = self.materialize(v)
            i = self.phys(v, _identity(len(v.shape)))
            if v.dtype != torch.float32:
                i = self.step("Cast", [i], v.shape, v.perm, torch.float32,
                              dtype="float32").id
            self.plan.outputs[key] = i

    def materialize(self, v):
        """A held-back pad as its own op."""
        if not isinstance(v, _Pad):
            return v
        t = v.src
        pads = [[0, 0] for _ in t.shape]
        for k in range(len(v.pads) // 2):
            pads[len(t.shape) - 1 - k] = [v.pads[2 * k], v.pads[2 * k + 1]]
        shape = [n + a + b for n, (a, b) in zip(t.shape, pads)]
        tf_pads = [pads[p] for p in t.perm]
        value = self.const(np.asarray(v.value, _np_dtype(t.dtype)))
        return self.step("PadV2", [t.id, value], shape, t.perm, t.dtype, paddings=tf_pads)

    # -- windows (conv, pool) -------------------------------------------------
    def window_input(self, x, kernel, stride, dilation, padding, pad_value,
                     extra=(0, 0)) -> tuple:
        """(id of the NHWC input, TF padding) of a conv or pool over `x`
        with its own symmetric `padding` and `extra` pads after (a pool's
        ceil_mode), folding a held-back pad of `pad_value` into SAME where
        it equals TF's SAME pads."""
        if isinstance(x, _Pad) and x.value == pad_value and len(x.pads) == 4:
            src, (l, r, t, b) = x.src, x.pads
        elif isinstance(x, _Pad):
            src, (l, r, t, b) = self.materialize(x), (0, 0, 0, 0)
        else:
            src, (l, r, t, b) = x, (0, 0, 0, 0)
        if len(src.shape) != 4:
            return None
        ph, pw = padding
        got = ((t + ph, b + ph + extra[0]), (l + pw, r + pw + extra[1]))
        h, w = src.shape[2:]
        same = (same_pads(h, kernel[0], stride[0], dilation[0]),
                same_pads(w, kernel[1], stride[1], dilation[1]))
        if got == same:
            return self.phys(src, NHWC), "SAME"
        if got == ((0, 0), (0, 0)):
            return self.phys(src, NHWC), "VALID"
        if pad_value == -math.inf:
            # a max pool's pad: the same maximum on finite inputs (every
            # window holds one), and no -inf constant in the graph
            pad_value = float(np.finfo(np.float32).min)
        full = _Pad(src, (got[1][0], got[1][1], got[0][0], got[0][1]), pad_value)
        return self.phys(self.materialize(full), NHWC), "VALID"


def _lookup(a, env):
    from torch.fx import Node

    if isinstance(a, Node):
        return env[a]
    if isinstance(a, (list, tuple)):
        return type(a)(_lookup(b, env) for b in a)
    return a


def _flatten(args) -> list:
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _flatten(a)
        else:
            out.append(a)
    return out


def _pair(v) -> tuple:
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    return tuple(v * 2 if len(v) == 1 else v)


# -- handlers ----------------------------------------------------------------------

def _convolution(L, node, x, w, b, stride, padding, dilation, transposed, out_pad, groups):
    if transposed or not isinstance(w, torch.Tensor) or w.ndim != 4 or not (
            b is None or isinstance(b, torch.Tensor)):
        return NotImplemented
    stride, dilation, padding = _pair(stride), _pair(dilation), _pair(padding)
    w64 = w.detach().to(torch.float64).cpu()
    b64 = None if b is None else b.detach().to(torch.float64).cpu()
    users = list(node.users)
    bn = users[0] if len(users) == 1 and str(users[0].target) == (
        "aten._native_batch_norm_legit_no_training.default") else None
    if bn is not None:
        gamma, beta, mean, var = (L.env.get(bn.args[i]) for i in (1, 2, 3, 4))
        if all(isinstance(t, torch.Tensor) for t in (gamma, beta, mean, var)):
            scale = gamma.to(torch.float64).cpu() / torch.sqrt(
                var.to(torch.float64).cpu() + bn.args[6])
            w64 = w64 * scale.view(-1, 1, 1, 1)
            b64 = (0.0 if b64 is None else b64) - mean.to(torch.float64).cpu()
            b64 = b64 * scale + beta.to(torch.float64).cpu()
        else:
            bn = None
    src = L.window_input(x, w.shape[2:], stride, dilation, padding, 0.0)
    if src is None:
        return NotImplemented
    xid, pad = src
    cout, cin_g = w.shape[:2]
    cin = cin_g * groups
    out_shape = tuple(node.meta["val"].shape)
    dtype = node.meta["val"].dtype
    npd = _np_dtype(dtype)
    strides, dils = [1, *stride, 1], [1, *dilation, 1]
    if groups == 1:
        y = L.step("Conv2D", [xid, L.const(w64.permute(2, 3, 1, 0).numpy().astype(npd))],
                   out_shape, NHWC, dtype, strides=strides, padding=pad, dilations=dils)
    elif cin_g == 1:                        # depthwise: groups == channels
        m = cout // cin
        filt = w64.reshape(cin, m, *w.shape[2:]).permute(2, 3, 0, 1).numpy().astype(npd)
        y = L.step("DepthwiseConv2dNative", [xid, L.const(filt)], out_shape, NHWC, dtype,
                   strides=strides, padding=pad, dilations=dils)
    else:
        cout_g = cout // groups
        in_shape = list(node.args[0].meta["val"].shape)
        in_shape[1] = cin_g
        parts = []
        for g in range(groups):
            piece = L.step("StridedSlice", [xid], in_shape, NHWC, dtype,
                           **_slice_attrs(4, 3, g * cin_g, (g + 1) * cin_g))
            wg = w64[g * cout_g:(g + 1) * cout_g].permute(2, 3, 1, 0).numpy().astype(npd)
            parts.append(L.step("Conv2D", [piece.id, L.const(wg)], out_shape, NHWC, dtype,
                                strides=strides, padding=pad, dilations=dils).id)
        y = L.step("ConcatV2", parts, out_shape, NHWC, dtype, axis=3)
    if b64 is not None:
        y = L.step("BiasAdd", [y.id, L.const(b64.numpy().astype(npd))], out_shape, NHWC,
                   dtype)
    if bn is not None:
        L.bn_folded[bn] = y
    return y


def _batch_norm(L, node, x, gamma, beta, mean, var, momentum, eps):
    if node in L.bn_folded:
        return (L.bn_folded[node], *_BN_STATS)
    if not all(isinstance(t, torch.Tensor) for t in (gamma, beta, mean, var)):
        return NotImplemented
    x = L.materialize(x)
    scale = gamma.to(torch.float64) / torch.sqrt(var.to(torch.float64) + eps)
    shift = beta.to(torch.float64) - mean.to(torch.float64) * scale
    shape, rank = x.shape, len(x.shape)
    view = (1, -1) + (1,) * (rank - 2)
    y = L.step("Mul", [x.id, L.const_as(scale.view(view), rank, x.perm, x.dtype)], shape,
               x.perm, x.dtype)
    y = L.step("AddV2", [y.id, L.const_as(shift.view(view), rank, x.perm, x.dtype)], shape,
               x.perm, x.dtype)
    return (y, *_BN_STATS)


_BN_STATS = (_Refused("a BatchNorm's saved mean"), _Refused("a BatchNorm's saved invstd"))


def _max_pool(L, node, x, kernel, stride=(), padding=0, dilation=1, ceil_mode=False):
    kernel, padding = _pair(kernel), _pair(padding)
    stride = _pair(stride) if stride else kernel
    if _pair(dilation) != (1, 1):
        return NotImplemented
    val = node.meta["val"][0]
    # ceil_mode: the windows that start inside the input and run past it,
    # as pads after it
    sizes = tuple(node.args[0].meta["val"].shape[2:])
    extra = tuple((o - 1) * s + k - n - 2 * p for o, s, k, n, p in zip(
        val.shape[2:], stride, kernel, sizes, padding)) if ceil_mode else (0, 0)
    src = L.window_input(x, kernel, stride, (1, 1), padding, -math.inf, extra)
    if src is None:
        return NotImplemented
    xid, pad = src
    y = L.step("MaxPool", [xid], tuple(val.shape), NHWC, val.dtype, ksize=[1, *kernel, 1],
               strides=[1, *stride, 1], padding=pad)
    return (y, _Refused("max_pool2d's indices"))


def _pad(L, node, x, pad, value=0.0):
    x = L.materialize(x)
    users = list(node.users)
    window = ("aten.convolution.default", "aten.max_pool2d_with_indices.default")
    if len(pad) == 4 and len(x.shape) == 4 and users and all(
            str(u.target) in window and u.args[0] is node for u in users):
        return _Pad(x, tuple(pad), float(value))
    return L.materialize(_Pad(x, tuple(pad), float(value)))


def _unary(op, **attrs):
    def lower(L, node, x, *rest):
        x = L.materialize(x)
        return L.step(op, [x.id], x.shape, x.perm, node.meta["val"].dtype, **attrs)
    return lower


def _leaky_relu(L, node, x, slope=0.01):
    x = L.materialize(x)
    return L.step("LeakyRelu", [x.id], x.shape, x.perm, x.dtype, alpha=float(slope))


def _hardtanh(L, node, x, lo=-1.0, hi=1.0):
    x = L.materialize(x)
    if (lo, hi) == (0.0, 6.0):
        return L.step("Relu6", [x.id], x.shape, x.perm, x.dtype)
    ids = [x.id] + [L.const(np.asarray(v, _np_dtype(x.dtype))) for v in (lo, hi)]
    return L.step("ClipByValue", ids, x.shape, x.perm, x.dtype)


def _elementwise(op):
    def lower(L, node, *args, alpha=None):
        if alpha is not None and alpha != 1:
            return NotImplemented
        val = node.meta["val"]
        rank = len(val.shape)
        args = [_rank_up(L, L.materialize(a), rank) for a in args]
        tensors = [a for a in args if isinstance(a, _T)]
        perm = tensors[0].perm
        floats = [t.dtype for t in tensors if t.dtype.is_floating_point]
        num_dtype = floats[0] if floats else val.dtype
        ids = []
        for a in args:
            if isinstance(a, _T):
                ids.append(L.phys(a, perm))
            else:
                dt = a.dtype if isinstance(a, torch.Tensor) and not (
                    a.dtype.is_floating_point) else num_dtype
                ids.append(L.const_as(a, rank, perm, dt))
        return L.step(op, ids, tuple(val.shape), perm, val.dtype)
    return lower


def _rank_up(L, a, rank: int):
    """A planned tensor of fewer than `rank` dims with leading 1s added (as
    broadcasting adds them); anything else as it is."""
    if not isinstance(a, _T) or len(a.shape) == rank:
        return a
    shape = (1,) * (rank - len(a.shape)) + a.shape
    return L.step("Reshape", [L.phys(a, _identity(len(a.shape)))], shape, _identity(rank),
                  a.dtype, shape=list(shape))


def _cat(L, node, tensors, dim=0):
    tensors = [L.materialize(t) for t in tensors]
    val = node.meta["val"]
    rank = len(val.shape)
    ref = next(t for t in tensors if isinstance(t, _T))
    ids = [L.phys(t, ref.perm) if isinstance(t, _T) else L.const_as(t, rank, ref.perm,
                                                                     ref.dtype)
           for t in tensors]
    return L.step("ConcatV2", ids, tuple(val.shape), ref.perm, val.dtype,
                  axis=ref.perm.index(dim % rank))


def _permute(L, node, x, dims):
    x = L.materialize(x)
    rank = len(x.shape)
    inv = [0] * rank
    for i, d in enumerate(dims):
        inv[d % rank] = i
    return _T(x.id, tuple(node.meta["val"].shape), tuple(inv[p] for p in x.perm), x.dtype)


def _view_groups(ins, outs):
    """Pairs (in dims, out dims) whose sizes multiply to the same number,
    in order: a reshape is a reshape of each pair."""
    i = j = 0
    groups = []
    while i < len(ins) or j < len(outs):
        gi, go, pi, po = [], [], 1, 1
        if i < len(ins):
            gi.append(i)
            pi *= ins[i]
            i += 1
        if j < len(outs):
            go.append(j)
            po *= outs[j]
            j += 1
        while pi != po:
            if pi < po and i < len(ins):
                gi.append(i)
                pi *= ins[i]
                i += 1
            elif j < len(outs):
                go.append(j)
                po *= outs[j]
                j += 1
            else:
                return None
        groups.append((gi, go))
    return groups


def _view(L, node, x, shape=None):
    x = L.materialize(x)
    out = tuple(node.meta["val"].shape)
    groups = _view_groups(x.shape, out)
    keys = []
    for n, (gi, go) in enumerate(groups or ()):
        # each pair's dims must lie together and in order in the TF tensor
        pos = [x.perm.index(d) for d in gi]
        if pos and pos != list(range(pos[0], pos[0] + len(pos))):
            groups = None
            break
        keys.append((pos[0] if pos else (keys[-1][0] if keys else -1), n))
    if groups is None:
        xid = L.phys(x, _identity(len(x.shape)))
        return L.step("Reshape", [xid], out, _identity(len(out)), x.dtype, shape=list(out))
    order = [groups[n][1] for _, n in sorted(keys)]
    perm = tuple(d for go in order for d in go)
    tf_shape = [out[d] for d in perm]
    if tf_shape == list(x.tf_shape()):
        return _T(x.id, out, perm, x.dtype)
    return L.step("Reshape", [x.id], out, perm, x.dtype, shape=tf_shape)


def _alias(L, node, x, *rest, **kwargs):
    return L.materialize(x)


def _to_copy(L, node, x, **kwargs):
    x = L.materialize(x)
    dtype = node.meta["val"].dtype
    if dtype == x.dtype:
        return x
    return L.step("Cast", [x.id], x.shape, x.perm, dtype, dtype=str(dtype).split(".")[-1])


def _slice_attrs(rank, axis, start, end, step=1, shrink=False) -> dict:
    begin, stop, strides = [0] * rank, [0] * rank, [1] * rank
    begin[axis], stop[axis], strides[axis] = start, end, step
    full = sum(1 << a for a in range(rank) if a != axis)
    return dict(begin=begin, end=stop, strides=strides, begin_mask=full, end_mask=full,
                shrink_axis_mask=(1 << axis) if shrink else 0)


def _slice(L, node, x, dim=0, start=None, end=None, step=1):
    x = L.materialize(x)
    rank = len(x.shape)
    dim %= rank
    start, end, step = slice(start, end, step).indices(x.shape[dim])
    out = tuple(node.meta["val"].shape)
    if out == x.shape:
        return x
    return L.step("StridedSlice", [x.id], out, x.perm, x.dtype,
                  **_slice_attrs(rank, x.perm.index(dim), start, end, step))


def _select(L, node, x, dim, index):
    x = L.materialize(x)
    rank = len(x.shape)
    dim %= rank
    index %= x.shape[dim]
    axis = x.perm.index(dim)
    perm = tuple(p - (p > dim) for p in x.perm if p != dim)
    return L.step("StridedSlice", [x.id], tuple(node.meta["val"].shape), perm, x.dtype,
                  **_slice_attrs(rank, axis, index, index + 1, 1, shrink=True))


def _unsqueeze(L, node, x, dim):
    x = L.materialize(x)
    dim %= len(x.shape) + 1
    pos = 0 if dim == 0 else x.perm.index(dim - 1) + 1
    perm = [p + (p >= dim) for p in x.perm]
    perm.insert(pos, dim)
    return L.step("ExpandDims", [x.id], tuple(node.meta["val"].shape), perm, x.dtype,
                  axis=pos)


def _amax(L, node, x, dim=(), keepdim=False):
    x = L.materialize(x)
    rank = len(x.shape)
    dims = sorted(d % rank for d in (dim if isinstance(dim, (list, tuple)) else [dim]))
    dims = dims or list(range(rank))
    perm = x.perm if keepdim else tuple(p - sum(d < p for d in dims) for p in x.perm
                                        if p not in dims)
    return L.step("Max", [x.id], tuple(node.meta["val"].shape), perm, x.dtype,
                  axis=[x.perm.index(d) for d in dims], keepdims=bool(keepdim))


def _index(L, node, x, indices):
    """Advanced indexing by constant index tensors on consecutive dims, each
    varying along its own broadcast axis only (an outer product, as the
    nearest resize's rows and columns): one GatherV2 per dim."""
    x = L.materialize(x)
    dims = [d for d, ix in enumerate(indices) if ix is not None]
    ixs = [indices[d] for d in dims]
    if not dims or dims != list(range(dims[0], dims[0] + len(dims))) or not all(
            isinstance(ix, torch.Tensor) and not ix.is_floating_point() for ix in ixs):
        return NotImplemented
    bshape = torch.broadcast_shapes(*(ix.shape for ix in ixs))
    if len(bshape) != len(dims):
        return NotImplemented
    lines = []
    for k, ix in enumerate(ixs):
        full = ix.expand(bshape)
        line = full[tuple(slice(None) if a == k else 0 for a in range(len(dims)))]
        shape = [1] * len(dims)
        shape[k] = -1
        if not torch.equal(full, line.reshape(shape).expand(bshape)):
            return NotImplemented
        lines.append(line.remainder(x.shape[dims[k]]).to(torch.int32).cpu().numpy())
    y, shape = x, list(x.shape)
    for d, line in zip(dims, lines):
        shape[d] = len(line)
        y = L.step("GatherV2", [y.id, L.const(line)], tuple(shape), x.perm, x.dtype,
                   axis=x.perm.index(d))
    return y


def _conv1_pool(L, node, btp, w1p, b1p):
    """`conv1_pool_plain` as TF ops on btp [B, H, Q, 128] (channels last)."""
    if not (isinstance(w1p, torch.Tensor) and isinstance(b1p, torch.Tensor)):
        return NotImplemented
    btp = L.materialize(btp)
    b, h, q, lanes = btp.shape
    dt = torch.float32
    keep = np.ones((1, 1, q, lanes), np.float32)
    keep[0, 0, 0, :32] = 0.0
    keep[0, 0, q - 1, 96:] = 0.0
    ident = _identity(4)
    x = L.step("Mul", [L.phys(btp, ident), L.const(keep)], btp.shape, ident, dt)
    filt = w1p.detach().to(torch.float32).cpu().numpy()[:, None]        # [3, 1, 128, 128]
    y = L.step("Conv2D", [x.id, L.const(filt)], (b, h, q, lanes), ident, dt,
               strides=[1, 1, 1, 1], padding="SAME", dilations=[1, 1, 1, 1])
    y = L.step("BiasAdd", [y.id, L.const(b1p.detach().to(dt).cpu().numpy())], y.shape,
               ident, dt)
    y = L.step("Relu", [y.id], y.shape, ident, dt)
    half = lanes // 2
    lo = L.step("StridedSlice", [y.id], (b, h, q, half), ident, dt,
                **_slice_attrs(4, 3, 0, half))
    hi = L.step("StridedSlice", [y.id], (b, h, q, half), ident, dt,
                **_slice_attrs(4, 3, half, lanes))
    y = L.step("Maximum", [lo.id, hi.id], (b, h, q, half), ident, dt)
    return L.step("MaxPool", [y.id], (b, h // 2, q, half), ident, dt,
                  ksize=[1, 2, 1, 1], strides=[1, 2, 1, 1], padding="VALID")


_HANDLERS = {
    "aten.convolution.default": _convolution,
    "aten._native_batch_norm_legit_no_training.default": _batch_norm,
    "aten.max_pool2d_with_indices.default": _max_pool,
    "aten.constant_pad_nd.default": _pad,
    "aten.relu.default": _unary("Relu"),
    "aten.sigmoid.default": _unary("Sigmoid"),
    "aten.hardtanh.default": _hardtanh,
    "aten.leaky_relu.default": _leaky_relu,
    "aten.add.Tensor": _elementwise("AddV2"),
    "aten.add.Scalar": _elementwise("AddV2"),
    "aten.sub.Tensor": _elementwise("Sub"),
    "aten.sub.Scalar": _elementwise("Sub"),
    "aten.mul.Tensor": _elementwise("Mul"),
    "aten.mul.Scalar": _elementwise("Mul"),
    "aten.div.Tensor": _elementwise("RealDiv"),
    "aten.div.Scalar": _elementwise("RealDiv"),
    "aten.ge.Scalar": _elementwise("GreaterEqual"),
    "aten.ge.Tensor": _elementwise("GreaterEqual"),
    "aten.where.self": _elementwise("SelectV2"),
    "aten.cat.default": _cat,
    "aten.permute.default": _permute,
    "aten.view.default": _view,
    "aten._unsafe_view.default": _view,
    "aten.clone.default": _alias,
    "aten.alias.default": _alias,
    "aten._to_copy.default": _to_copy,
    "aten.slice.Tensor": _slice,
    "aten.select.int": _select,
    "aten.unsqueeze.default": _unsqueeze,
    "aten.index.Tensor": _index,
    "aten.amax.default": _amax,
    "hyperpose.conv1_pool.default": _conv1_pool,
}


# -- emission (TensorFlow) ----------------------------------------------------------

def _emitters(tf) -> dict:
    """TF op name -> function(inputs..., **attrs) building it."""
    nn_ = tf.nn
    return {
        "Conv2D": lambda x, w, strides, padding, dilations: nn_.conv2d(
            x, w, strides, padding, dilations=dilations),
        "DepthwiseConv2dNative": lambda x, w, strides, padding, dilations: (
            nn_.depthwise_conv2d(x, w, strides, padding, dilations=dilations[1:3])),
        "BiasAdd": nn_.bias_add,
        "MaxPool": lambda x, ksize, strides, padding: nn_.max_pool2d(x, ksize, strides,
                                                                     padding),
        "PadV2": lambda x, v, paddings: tf.pad(x, paddings, constant_values=v),
        "Relu": nn_.relu,
        "Relu6": nn_.relu6,
        "LeakyRelu": lambda x, alpha: nn_.leaky_relu(x, alpha),
        "Sigmoid": tf.sigmoid,
        "ClipByValue": tf.clip_by_value,
        "AddV2": tf.add,
        "Sub": tf.subtract,
        "Mul": tf.multiply,
        "RealDiv": tf.divide,
        "Maximum": tf.maximum,
        "Max": lambda x, axis, keepdims: tf.reduce_max(x, axis, keepdims=keepdims),
        "GreaterEqual": tf.greater_equal,
        "SelectV2": tf.where,
        "ConcatV2": lambda *xs, axis: tf.concat(list(xs), axis),
        "Transpose": lambda x, perm: tf.transpose(x, perm),
        "Reshape": lambda x, shape: tf.reshape(x, shape),
        "ExpandDims": lambda x, axis: tf.expand_dims(x, axis),
        "StridedSlice": tf.strided_slice,
        "GatherV2": lambda x, i, axis: tf.gather(x, i, axis=axis),
        "Cast": lambda x, dtype: tf.cast(x, dtype),
    }


def tf_function(plan: Plan, input_name: str = "input"):
    """The plan as a `tf.function` over `tf.TensorSpec(plan.input_shape,
    tf.float32, name=input_name)`, returning {key: float32 tensor}."""
    import tensorflow as tf

    if plan.unlowered:
        raise NotImplementedError(f"no TensorFlow lowering for {plan.unlowered}")
    emit = _emitters(tf)

    def forward(x):
        env = {0: x}

        def get(i):
            if i not in env:
                env[i] = tf.constant(plan.consts[i])
            return env[i]

        for s in plan.steps:
            env[s.out] = emit[s.op](*[get(i) for i in s.inputs], **s.attrs)
        return {k: get(i) for k, i in plan.outputs.items()}

    spec = tf.TensorSpec(plan.input_shape, tf.float32, name=input_name)
    return tf.function(forward, input_signature=[spec], autograph=False)
