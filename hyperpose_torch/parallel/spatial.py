"""Spatial parallelism: the rows of each image split over the ranks of an
"sp" group, with a halo exchange around every conv and pool whose window
spans more than one row.

No file of the JAX package corresponds to this one. There,
`batch_sharding` is `P("dp", "sp", None, None)` on NHWC batches
(`hyperpose_tpu/parallel/mesh.py`), so "sp" splits image rows, and GSPMD
partitions every op of the jitted step, inserting each conv's halo itself:
the sharded step equals the unsharded one. The port runs one process a
rank with no compiler to partition for it, so this module does that work
explicitly, and is the one place that decides which rows a layer reads
from its neighbours:

- The split (`split_rows`): the coarsest grid of the model's feature maps
  has stride `grid` (`row_grid` finds it from a small forward); its rows
  are spread as evenly as possible over the sp ranks (the first ranks take
  one more), and rank s takes input rows `grid * [lo_s, hi_s)`. Every
  layer's row boundaries then fall on its own stride's grid, so 2x2 pools,
  stride-2 convs, space-to-depth packings, x2 upsamples and pixel shuffles
  need nothing from a neighbour. The input height must be a multiple of
  `grid`.
- The models (`make_shard`): the port's own networks, whose forwards are
  built from the ops below. A module of another package (a user's
  `model_arch`) may do what no op shows, such as a mean over the rows, so
  it is refused (GSPMD takes it; ROADMAP Queue 3 records the difference).
- The ops (`row_sharded`): inside the block a torch function mode sees
  every conv, pool and resize. A conv or max pool whose window spans rows
  receives the rows it reads from the neighbouring ranks (`halo`: a
  differentiable exchange whose backward sends each halo's gradient back
  to the rank that owns those rows, which adds it to theirs), is padded
  only at the image's real top and bottom (zeros for a conv, -inf for a
  max pool) and runs with no row padding of its own (`window`). An op
  whose rows cannot split that way (a transposed conv, an adaptive or
  overlapping average pool, a resize other than nearest by a whole ratio)
  raises a `ValueError` that names the layer; so does a halo wider than a
  neighbour's rows, with the fewest rows that work (GSPMD takes any split;
  ROADMAP Queue 3 records the difference).
- Two kinds of layer give themselves their rows and run `routed`, which
  the mode leaves alone: SAME pads at stride 2, asymmetric and taken from
  the layer's global height (`same`, used by `models/backbones.py`), and
  the hand-written kernels, which the mode does not see (`window` in
  `quant.Int8Conv2d`, `halo` around `conv1_pool` in
  `backbones.VggTinyFusedStem`). Outside `row_sharded` no mode is entered
  and these layers run their own code, so an unsharded forward is what it
  was.
- The outputs (`gather_outputs`): the model's maps gathered over sp along
  their rows; the backward returns this rank's rows of the gradient. Every
  sp rank then holds its dp shard's whole maps and computes the same loss,
  and a parameter's gradient on a rank is its rows' share of that loss's.

A layer finds its stride from its input: the local height h of a tensor of
stride t is (hi - lo) / t, the same t on every rank.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.modules.module import (
    register_module_forward_hook, register_module_forward_pre_hook,
)
from torch.overrides import TorchFunctionMode

_SHARD: contextvars.ContextVar = contextvars.ContextVar("hyperpose_row_shard", default=None)
# True while a layer that gave itself its rows runs its ops (`routed`)
_ROUTED: contextvars.ContextVar = contextvars.ContextVar("hyperpose_rows_routed", default=False)
# The names of the modules whose forwards are running, innermost last
_LAYERS: contextvars.ContextVar = contextvars.ContextVar("hyperpose_rows_layers", default=None)

# The input height of `row_grid`'s forward: 2 rows at stride 64.
PROBE_HEIGHT = 128


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rank `index` of an sp group of `len(bounds) - 1` ranks holds input
    rows [bounds[index], bounds[index + 1]) of images `bounds[-1]` rows
    tall. `group` is the sp process group (None only where no halo is
    exchanged); `names` maps id(module) to its name, for messages."""

    group: object
    index: int
    bounds: tuple
    names: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        return len(self.bounds) - 1

    @property
    def rows(self) -> tuple[int, int]:
        return self.bounds[self.index], self.bounds[self.index + 1]

    def layer(self, h: int, what: str) -> tuple[int, list, int]:
        """(stride t, every rank's (lo, hi) rows, global height) of a
        layer whose local input is `h` rows tall."""
        lo, hi = self.rows
        if h <= 0 or (hi - lo) % h or any(b % ((hi - lo) // h) for b in self.bounds):
            raise ValueError(f"{what}: {h} local rows do not lie on a grid of the row split "
                             f"{list(self.bounds)}")
        t = (hi - lo) // h
        return t, [(self.bounds[j] // t, self.bounds[j + 1] // t)
                   for j in range(self.size)], self.bounds[-1] // t

    def peer(self, j: int) -> int:
        """The global rank of sp member j."""
        return dist.get_global_rank(self.group, j)


def split_rows(height: int, size: int, grid: int) -> tuple:
    """Input row bounds of `size` ranks: the `height / grid` rows of the
    coarsest grid spread as evenly as possible, the first ranks taking one
    more, times `grid`."""
    if height % grid:
        raise ValueError(f"an input {height} rows tall does not split on the model's coarsest "
                         f"grid of stride {grid}: the height must be a multiple of {grid}")
    n = height // grid
    if n < size:
        raise ValueError(f"{n} rows at stride {grid} cannot split over {size} ranks")
    counts = [n // size + (j < n % size) for j in range(size)]
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + c * grid)
    return tuple(bounds)


@torch.no_grad()
def row_grid(model, dtype: torch.dtype, device, width: int = 64) -> int:
    """The stride of `model`'s coarsest feature grid: its forward in eval
    mode on one NHWC image `PROBE_HEIGHT` rows tall, the smallest height of
    any 4-d input a submodule receives (every layer of the port's networks
    is a submodule or feeds one)."""
    heights = []

    def seen(_module, args):
        if args and isinstance(args[0], torch.Tensor) and args[0].dim() == 4:
            heights.append(int(args[0].shape[2]))

    hooks = [m.register_forward_pre_hook(seen) for m in model.modules() if m is not model]
    was = model.training
    model.eval()
    try:
        model(torch.zeros((1, PROBE_HEIGHT, width, 3), dtype=dtype, device=device))
    finally:
        model.train(was)
        for h in hooks:
            h.remove()
    low = min(heights)
    if PROBE_HEIGHT % low:
        raise ValueError(f"the model's feature grids ({sorted(set(heights))} rows from "
                         f"{PROBE_HEIGHT}) have no common stride")
    return PROBE_HEIGHT // low


def _own(cls: type, packages: tuple) -> bool:
    return cls.__module__.startswith(packages)


def check_model(model) -> None:
    """Raise a ValueError unless `model` is one of the port's networks:
    its class and every submodule's from `hyperpose_torch` (or `torch.nn`
    inside it)."""
    foreign = [(n or "the model", type(m)) for n, m in model.named_modules()
               if not _own(type(m), ("hyperpose_torch.",) if m is model
                           else ("hyperpose_torch.", "torch.nn."))]
    if foreign:
        name, cls = foreign[0]
        raise ValueError(
            f"{name} ({cls.__module__}.{cls.__qualname__}): image rows split over ranks only "
            "in the port's own networks, whose layers take their halos; a module of another "
            "package (a model_arch) trains with spatial_parallel 1")


def make_shard(model, height: int, group, dtype: torch.dtype, device) -> RowShard:
    """This rank's `RowShard` of `height`-row images over the sp `group`,
    split on `model`'s coarsest grid; `model` must be one of the port's
    networks (`check_model`)."""
    check_model(model)
    size, index = dist.get_world_size(group), dist.get_rank(group)
    bounds = split_rows(height, size, row_grid(model, dtype, device))
    names = {id(m): n for n, m in model.named_modules()}
    return RowShard(group, index, bounds, names)


def active() -> RowShard | None:
    """The shard of the enclosing `row_sharded`, else None."""
    return _SHARD.get()


@contextlib.contextmanager
def row_sharded(shard: RowShard | None):
    """Inside the block the model's ops act on `shard`'s rows (`_RowOps`)
    and `same`, `window`, `halo` and `gather_rows` on its neighbours' (None:
    the block runs unsharded)."""
    token = _SHARD.set(shard)
    try:
        if shard is None or shard.size == 1:
            yield
        else:
            with _RowOps(shard):
                yield
    finally:
        _SHARD.reset(token)


@contextlib.contextmanager
def routed():
    """Inside the block the ops run as called: the layer has given its
    input the rows it reads (`same`, `window`, `halo`)."""
    token = _ROUTED.set(True)
    try:
        yield
    finally:
        _ROUTED.reset(token)


def _where(op: str) -> str:
    layers = _LAYERS.get()
    return f"{layers[-1]} ({op})" if layers else op


# -- the exchange --------------------------------------------------------------------

def _wire(t: torch.Tensor, staged: bool) -> torch.Tensor:
    """`t` as it crosses the wire: contiguous, on the host where the backend
    is gloo and `t` on the card (gloo sends and gathers host tensors)."""
    t = t.contiguous()
    return t.cpu() if staged else t


def _sendrecv(shard: RowShard, sends: list, recvs: list) -> list:
    """Send each (tensor, sp member) of `sends` and receive one tensor shaped
    like each (tensor, sp member) of `recvs`, in one batch of point-to-point
    operations; returns the received tensors."""
    if not sends and not recvs:
        return []
    like = (sends or recvs)[0][0]
    staged = like.is_cuda and dist.get_backend(shard.group) == "gloo"
    ops, bufs = [], []
    for t, j in sends:
        ops.append(dist.P2POp(dist.isend, _wire(t, staged), shard.peer(j), shard.group))
    for t, j in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, shard.peer(j), shard.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(t.device) for b, (t, _) in zip(bufs, recvs)]


def _cat_rows(parts: list, like: torch.Tensor) -> torch.Tensor:
    out = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
    if like.is_contiguous(memory_format=torch.channels_last) and not like.is_contiguous():
        out = out.contiguous(memory_format=torch.channels_last)
    return out


class _Halo(torch.autograd.Function):
    """x [N, C, h, W] -> its rows with `top` rows of the rank above and
    `bottom` of the rank below; at the image's real top and bottom, rows of
    `value` (none where `value` is None)."""

    @staticmethod
    def forward(ctx, x, shard, top, bottom, value):
        j, h = shard.index, x.shape[2]
        above, below = j > 0, j + 1 < shard.size
        sends, recvs = [], []
        if top and below:
            sends.append((x[:, :, h - top:], j + 1))
        if bottom and above:
            sends.append((x[:, :, :bottom], j - 1))
        if top and above:
            recvs.append((x[:, :, :top], j - 1))
        if bottom and below:
            recvs.append((x[:, :, :bottom], j + 1))
        got = iter(_sendrecv(shard, sends, recvs))
        parts = []
        edge = lambda n: x.new_full((x.shape[0], x.shape[1], n, x.shape[3]), value)  # noqa: E731
        if top and above:
            parts.append(next(got))
        elif top and value is not None:
            parts.append(edge(top))
        parts.append(x)
        if bottom and below:
            parts.append(next(got))
        elif bottom and value is not None:
            parts.append(edge(bottom))
        ctx.shard, ctx.top, ctx.bottom, ctx.h = shard, top, bottom, h
        ctx.added_top = top if (above or value is not None) else 0
        return _cat_rows(parts, x)

    @staticmethod
    def backward(ctx, g):
        shard, top, bottom, h = ctx.shard, ctx.top, ctx.bottom, ctx.h
        j = shard.index
        above, below = j > 0, j + 1 < shard.size
        t0 = ctx.added_top
        mid = g[:, :, t0:t0 + h].clone()
        sends, recvs = [], []
        if top and above:
            sends.append((g[:, :, :top], j - 1))
        if bottom and below:
            sends.append((g[:, :, t0 + h:t0 + h + bottom], j + 1))
        if top and below:
            recvs.append((mid[:, :, h - top:], j + 1))
        if bottom and above:
            recvs.append((mid[:, :, :bottom], j - 1))
        got = iter(_sendrecv(shard, sends, recvs))
        if top and below:
            mid[:, :, h - top:] += next(got)
        if bottom and above:
            mid[:, :, :bottom] += next(got)
        return mid, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, value: float | None = 0.0,
         what: str | None = None) -> torch.Tensor:
    """NCHW `x` (this rank's rows of a layer's input) with `top` rows above
    it and `bottom` below from the neighbouring ranks, and at the image's
    real edges rows of `value` (none for None); a negative `bottom` drops
    that many of the last rows instead. Raises a ValueError naming `what`
    (default: the layer running) when a neighbour holds fewer rows than its
    halo takes."""
    shard = active()
    what = what or _where("its halo")
    t, rows, _ = shard.layer(x.shape[2], what)
    need = max(top, bottom, 0)
    thin = [hi - lo for lo, hi in rows if hi - lo < need]
    if thin and shard.size > 1:
        raise ValueError(
            f"{what}: a halo of {need} rows at stride {t} is wider than a neighbour's "
            f"{min(thin)} rows; it needs at least {need} rows of that layer a rank "
            f"({need * t} input rows): use fewer sp ranks or taller images")
    y = _Halo.apply(x, shard, max(top, 0), max(bottom, 0), value)
    return y[:, :, :y.shape[2] + bottom] if bottom < 0 else y


def _same_1d(n: int, span: int, stride: int) -> tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + span - n, 0)
    return total // 2, total - total // 2


def same(op, x: torch.Tensor, span: int, stride: int, value: float = 0.0,
         what: str = "a strided SAME layer"):
    """`op` (a conv or pool with no padding of its own) on this rank's rows
    of `x` padded for a `span`-row window at `stride` as XLA's SAME pads
    the whole image: the row pads of the global height, taken from the
    neighbours inside the image and filled with `value` at its real edges;
    the columns padded as they are unsharded."""
    what = _where(what)
    _, _, height = active().layer(x.shape[2], what)
    if height % stride:
        raise ValueError(f"{what}: stride {stride} on {height} rows")
    top, _ = _same_1d(height, span, stride)
    left, right = _same_1d(x.shape[3], span, stride)
    x = halo(x, top, span - stride - top, value, what)
    if left or right:
        x = F.pad(x, (left, right, 0, 0), value=value)
    with routed():
        return op(x)


def window(x: torch.Tensor, span: int, stride: int, pad: int, value: float,
           what: str) -> torch.Tensor:
    """This rank's rows of `x` for a window `span` rows tall at `stride`
    that pads the whole image by `pad` rows at either end: with the rows it
    reads of the neighbours, and `value` at the image's real edges, for the
    op run with no row padding. A window within its own stride's rows is
    given `x` as it is. Raises a ValueError where the op's rows do not
    split: its output not the input's height / stride, or a rank's first row
    off its stride."""
    what = _where(what)
    t, rows, height = active().layer(x.shape[2], what)
    if height % stride or any(lo % stride for lo, _ in rows):
        raise ValueError(f"{what}: stride {stride} on the rows {rows} of the split at "
                         f"stride {t}")
    if span <= stride and not pad:
        return x
    if (height + 2 * pad - span) // stride + 1 != height // stride:
        raise ValueError(f"{what}: a window of {span} rows at stride {stride}, padded by "
                         f"{pad}, does not take {height} rows to {height // stride}: rows "
                         "split only around SAME windows")
    return halo(x, pad, span - stride - pad, value, what)


# -- the ops of a row-sharded forward -----------------------------------------------------

def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _bind(names: tuple, args: tuple, kwargs: dict) -> dict:
    a = dict(zip(names, args))
    a.update(kwargs)
    return a


_CONV = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
_MAX_POOL = ("input", "kernel_size", "stride", "padding", "dilation", "ceil_mode",
             "return_indices")
_AVG_POOL = ("input", "kernel_size", "stride", "padding")


def _conv(func, args, kwargs):
    a = _bind(_CONV, args, kwargs)
    pad = a.get("padding", 0)
    if isinstance(pad, str):
        if pad != "valid":
            raise ValueError(_where(f"conv2d: padding {pad!r}: rows split around explicit "
                                    "padding"))
        pad = 0
    (ph, pw), (kh, dh) = _pair(pad), (a["weight"].shape[2], _pair(a.get("dilation", 1))[0])
    x = window(a["input"], dh * (kh - 1) + 1, _pair(a.get("stride", 1))[0], ph, 0.0, "conv2d")
    return func(**dict(a, input=x, padding=(0, pw)))


def _max_pool(func, args, kwargs):
    a = _bind(_MAX_POOL, args, kwargs)
    if a.get("return_indices"):
        raise ValueError(_where("max_pool2d: the indices of a row-sharded pool"))
    k, p, d = _pair(a["kernel_size"]), _pair(a.get("padding", 0)), _pair(a.get("dilation", 1))
    s = _pair(a.get("stride") or k)
    x = window(a["input"], d[0] * (k[0] - 1) + 1, s[0], p[0], float("-inf"), "max_pool2d")
    return func(**dict(a, input=x, stride=s, padding=(0, p[1])))


def _avg_pool(func, args, kwargs):
    a = _bind(_AVG_POOL, args, kwargs)
    k = _pair(a["kernel_size"])
    s, p = _pair(a.get("stride") or k), _pair(a.get("padding", 0))
    if k[0] > s[0] or p[0]:
        raise ValueError(_where(f"avg_pool2d: a {k[0]}-row window at stride {s[0]}, padded by "
                                f"{p[0]}: an average pool splits over rows only in its own "
                                "stride's rows"))
    window(a["input"], k[0], s[0], 0, 0.0, "avg_pool2d")
    return func(*args, **kwargs)


def _interpolate(func, args, kwargs):
    """A nearest resize by a whole ratio reads within each output row's
    stride cell; every other resize mixes the rows of its neighbours."""
    out = func(*args, **kwargs)
    a = _bind(("input", "size", "scale_factor", "mode"), args, kwargs)
    h, ho = a["input"].shape[2], out.shape[2]
    if a.get("mode", "nearest") not in ("nearest", "nearest-exact") or (ho % h and h % ho):
        raise ValueError(_where(f"interpolate: {a.get('mode', 'nearest')} from {h} to {ho} "
                                "rows: rows split only under a nearest resize by a whole "
                                "ratio"))
    if h % ho == 0:
        window(a["input"], h // ho, h // ho, 0, 0.0, "interpolate")
    return out


def _refuse(func, args, kwargs):
    raise ValueError(_where(f"{getattr(func, '__name__', func)}: its rows do not split over "
                            "ranks"))


_RULES = {F.conv2d: _conv, F.max_pool2d: _max_pool, F.avg_pool2d: _avg_pool,
          F.interpolate: _interpolate, F.max_pool2d_with_indices: _refuse,
          F.conv_transpose2d: _refuse, F.adaptive_avg_pool2d: _refuse,
          F.adaptive_max_pool2d: _refuse, F.lp_pool2d: _refuse, F.unfold: _refuse,
          F.fold: _refuse, F.grid_sample: _refuse}


class _RowOps(TorchFunctionMode):
    """The mode of a row-sharded forward: each conv, pool and resize of
    `_RULES` acts on the shard's rows (`window`) or raises, unless a layer
    runs it `routed`; the forward hooks of every module keep the names of
    those running (`_where`)."""

    def __init__(self, shard: RowShard):
        super().__init__()
        self.shard = shard

    def __enter__(self):
        layers, names = [], self.shard.names

        def enter(m, _args):
            layers.append(names.get(id(m), type(m).__name__))

        def leave(_m, _args, _out):
            if layers:
                layers.pop()

        self._token = _LAYERS.set(layers)
        self._hooks = (register_module_forward_pre_hook(enter),
                       register_module_forward_hook(leave))
        return super().__enter__()

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        _LAYERS.reset(self._token)
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func)
        if rule is None or _ROUTED.get():
            return func(*args, **kwargs)
        return rule(func, args, kwargs)


# -- the outputs ---------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """Every sp rank's rows of `t` along `dim`, in rank order; the backward
    returns this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, t, shard, dim):
        _, rows, _ = shard.layer(t.shape[dim], "an output")
        sizes = [hi - lo for lo, hi in rows]
        most = max(sizes)
        src = t
        if src.shape[dim] < most:
            pad = list(src.shape)
            pad[dim] = most - src.shape[dim]
            src = torch.cat([src, src.new_zeros(pad)], dim=dim)
        staged = t.is_cuda and dist.get_backend(shard.group) == "gloo"
        wire = _wire(src, staged)
        parts = [torch.empty_like(wire) for _ in sizes]
        dist.all_gather(parts, wire, group=shard.group)
        out = torch.cat([p.to(t.device).narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                        dim=dim)
        ctx.dim, ctx.off, ctx.n = dim, sum(sizes[:shard.index]), sizes[shard.index]
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.off, ctx.n).contiguous(), None, None


def gather_rows(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """`t`, this rank's rows along `dim`, gathered over the sp ranks of the
    enclosing `row_sharded` (`_GatherRows`)."""
    shard = active()
    if shard is None or shard.size == 1:
        return t
    return _GatherRows.apply(t, shard, dim)


def gather_outputs(out: dict, row_dims: dict | None = None) -> dict:
    """A model's output dict with every tensor (and every tensor of a list)
    gathered along its rows: dim 1 of the NHWC maps, or the dim
    `row_dims` names for a key."""
    row_dims = row_dims or {}

    def one(k, v):
        return gather_rows(v, row_dims.get(k, 1)) if isinstance(v, torch.Tensor) else v

    return {k: [one(k, t) for t in v] if isinstance(v, (list, tuple)) else one(k, v)
            for k, v in out.items()}

