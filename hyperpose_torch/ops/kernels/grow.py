"""PifPaf skeleton growth: the CUDA kernel, its wrapper and its plain PyTorch
version.

Replaces the Pallas TPU kernel `hyperpose_tpu/ops/pallas/grow_kernel.py`
`fused_grow`, whose semantics are those of the decoder's XLA growth
(`hyperpose_tpu/ops/pifpaf_decode.py` `_grow_xla`; reference:
hyperpose/Model/pifpaf/processor.py:262-393). Every seed slot of every image
grows one annotation for `growth_steps` Jacobi rounds: each round evaluates
`find_connection` (masked Gaussian weights over the K candidates of a
directed edge, best and second best with ties to the lowest index, the
2-best blend) over every directed edge from the state at the round's start,
checks the reverse match on edge rev(e)'s tables, and commits to each part
its best incoming edge (the lowest edge index on ties).

On the TPU the whole growth was one kernel so its ~60 small ops per round
stay in VMEM. On the card (`csrc/grow.cu`) all rounds run inside one kernel
that is bound by latency (each round is a chain of dependent loads,
reductions and barriers). One block of 16 warps serves a few seed slots of
one image, about one block per SM; the image's match-side tables are copied
into shared memory once; each round evaluates only the edges that can
commit (source grown, destination not), one edge per warp with 32 lanes
over the K candidates and `redux.sync` for best and second best. The one-hot
[P, E] contractions of the TPU kernel are gathers by `e_src[e]` /
`e_dst[e]`. The kernel repeats the plain version's float32 operations in the
same order, without contraction into FMAs, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import build
from .library import define, device_table, tracing

MAX_P = 32    # csrc/grow.cu kMaxP
MAX_E = 64    # csrc/grow.cu kMaxE
MAX_K = 256   # csrc/grow.cu kMaxK

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5


def _first_argmax(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(max, index of its first occurrence) over the last dim."""
    k = w.shape[-1]
    iota = torch.arange(k, device=w.device)
    s = w.amax(dim=-1)
    return s, torch.where(w >= s[..., None], iota, k).amin(dim=-1)


def find_connection(mx, my, ms, ox, oy, os_, qx, qy, qs):
    """Vectorised find_connection with 2-best blending.

    mx/my/ms (match side: position, score) and ox/oy/os_ (output side:
    position, scale) are [..., K] candidate tables broadcastable against the
    [...] query points qx/qy/qs. A candidate of score 0 never matches.
    Returns (score, x, y, scale) of shape [...], all 0 where nothing
    matches (reference: processor.py:262-310)."""
    sf = 2.0 * qs
    sg = torch.clamp(0.25 * qs * qs, min=1e-6)
    dx = mx - qx[..., None]
    dy = my - qy[..., None]
    near = (dx.abs() <= sf[..., None]) & (dy.abs() <= sf[..., None])
    d2 = dx * dx + dy * dy
    w = torch.where(near, torch.exp(-0.5 * d2 / sg[..., None]) * ms, 0.0)

    s1, i1 = _first_argmax(w)
    w2 = w.scatter(-1, i1[..., None], 0.0)
    s2, i2 = _first_argmax(w2)

    def at(t, i):
        return torch.gather(t.expand(w.shape), -1, i[..., None])[..., 0]

    o1x, o1y, o1s = at(ox, i1), at(oy, i1), at(os_, i1)
    o2x, o2y, o2s = at(ox, i2), at(oy, i2), at(os_, i2)

    no_match = s1 <= 0.0
    second_bad = (s2 < 0.01) | (s2 < 0.5 * s1)
    d12 = (o1x - o2x) * (o1x - o2x) + (o1y - o2y) * (o1y - o2y)
    too_far = d12 > (o1s * o1s / 4.0)
    use_single = second_bad | too_far

    denom = torch.clamp(s1 + s2, min=1e-12)
    fc = torch.where(use_single, 0.5 * s1, 0.5 * (s1 + s2))
    fx = torch.where(use_single, o1x, (o1x * s1 + o2x * s2) / denom)
    fy = torch.where(use_single, o1y, (o1y * s1 + o2y * s2) / denom)
    fs = torch.where(use_single, o1s, (o1s * s1 + o2s * s2) / denom)
    return tuple(torch.where(no_match, 0.0, v) for v in (fc, fx, fy, fs))


@device_table
def _index(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A static index table on `device`, copied once (a copy from host
    memory inside the decode would make the host wait for the device)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def fused_grow_plain(
    seed_part: torch.Tensor,        # [B, MH] int
    seed_vals: torch.Tensor,        # [B, MH, 4] f32 (x, y, scale, score)
    tables: Sequence[torch.Tensor],      # 6 x [B, E, K] forward tables
    rev_tables: Sequence[torch.Tensor],  # 6 x [B, E, K] reverse tables
    e_src: Sequence[int],
    e_dst: Sequence[int],
    n_parts: int,
    growth_steps: int = 8,
    reverse_match: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (ann_score, ann_x, ann_y, ann_sc), each [B, MH, P] float32:
    the batched [B, MH, E, K] form of the Pallas kernel, in its order of
    operations. Tables: (em_x, em_y, em_s, eo_x, eo_y, eo_s) as
    `find_connection`'s match and output sides; rev_tables[i][:, e] is
    tables[i][:, rev(e)]."""
    dev = seed_part.device
    src = _index(tuple(int(v) for v in e_src), dev)
    dst = _index(tuple(int(v) for v in e_dst), dev)
    n_e = src.shape[0]
    piota = torch.arange(n_parts, device=dev)
    seed_oh = (piota == seed_part[..., None]).to(torch.float32)   # [B, MH, P]
    sv = seed_vals.to(torch.float32)
    ann_x, ann_y = seed_oh * sv[..., 0:1], seed_oh * sv[..., 1:2]
    ann_sc, ann_score = seed_oh * sv[..., 2:3], seed_oh * sv[..., 3:4]
    fwd = [t[:, None] for t in tables]        # [B, 1, E, K]
    rev = [t[:, None] for t in rev_tables]
    dst_oh = (dst[:, None] == piota[None, :])                     # [E, P]
    eiota = torch.arange(n_e, device=dev)[:, None]

    for _ in range(growth_steps):
        src_score, dst_score = ann_score[..., src], ann_score[..., dst]
        qx, qy, qs = ann_x[..., src], ann_y[..., src], ann_sc[..., src]
        fc, fx, fy, fs = find_connection(*fwd, qx, qy, qs)
        merge = torch.sqrt(torch.clamp(fc * src_score, min=0.0))
        if reverse_match:
            rc, rx, ry, _ = find_connection(*rev, fx, fy, fs)
            rev_ok = (rc > 0.0) & ((qx - rx).abs() + (qy - ry).abs() <= qs)
            merge = torch.where(rev_ok, merge, 0.0)
        ok = (src_score > 0.0) & (dst_score <= 0.0) & (fc > 0.0)
        merge = torch.where(ok, merge, 0.0)

        # Per-part best incoming edge, the lowest edge index on ties.
        contrib = torch.where(dst_oh, merge[..., None], 0.0)     # [B, MH, E, P]
        best = contrib.amax(dim=2)
        ibest = torch.where(contrib >= best[:, :, None, :], eiota, n_e).amin(dim=2)
        do = best > 0.0
        ann_score = torch.where(do, best, ann_score)
        ann_x = torch.where(do, torch.gather(fx, -1, ibest), ann_x)
        ann_y = torch.where(do, torch.gather(fy, -1, ibest), ann_y)
        ann_sc = torch.where(do, torch.gather(fs, -1, ibest), ann_sc)
    return ann_score, ann_x, ann_y, ann_sc


def fused_grow(
    seed_part: torch.Tensor,
    seed_vals: torch.Tensor,
    tables: Sequence[torch.Tensor],
    rev_tables: Sequence[torch.Tensor],
    e_src: Sequence[int],
    e_dst: Sequence[int],
    n_parts: int,
    growth_steps: int = 8,
    reverse_match: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`fused_grow_plain`'s contract. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises if it cannot run. Traced,
    the operator `hyperpose::fused_grow` (`library.py`)."""
    if tracing():
        return _fused_grow_op(seed_part, seed_vals, list(tables), list(rev_tables),
                              [int(v) for v in e_src], [int(v) for v in e_dst],
                              int(n_parts), int(growth_steps), bool(reverse_match))
    return _fused_grow(seed_part, seed_vals, tables, rev_tables, e_src, e_dst, n_parts,
                       growth_steps, reverse_match)


def _fused_grow(seed_part, seed_vals, tables, rev_tables, e_src, e_dst, n_parts,
                growth_steps, reverse_match):
    """The wrapper's body: the plain version or the launch."""
    args = (seed_part, seed_vals, tables, rev_tables, e_src, e_dst, n_parts,
            growth_steps, reverse_match)
    if seed_part.device.type == "cpu":
        return fused_grow_plain(*args)
    if seed_part.device.type != "cuda":
        raise ValueError(f"fused_grow: unsupported device {seed_part.device}")
    if seed_part.ndim != 2 or seed_part.dtype != torch.int32:
        raise TypeError(f"fused_grow: seed_part must be int32 [B, MH], got "
                        f"{seed_part.dtype} {tuple(seed_part.shape)}")
    b, mh = seed_part.shape
    if seed_vals.dtype != torch.float32 or tuple(seed_vals.shape) != (b, mh, 4):
        raise TypeError(f"fused_grow: seed_vals must be float32 [{b}, {mh}, 4], "
                        f"got {seed_vals.dtype} {tuple(seed_vals.shape)}")
    all_tables = [*tables, *rev_tables]
    if len(all_tables) != 12:
        raise ValueError(f"fused_grow: 6 + 6 tables, got {len(tables)} + {len(rev_tables)}")
    e, k = all_tables[0].shape[1:] if all_tables[0].ndim == 3 else (-1, -1)
    for t in all_tables:
        if t.dtype != torch.float32 or tuple(t.shape) != (b, e, k):
            raise TypeError(f"fused_grow: tables must be float32 [{b}, E, K], "
                            f"got {t.dtype} {tuple(t.shape)}")
    if any(t.device != seed_part.device for t in [seed_vals, *all_tables]):
        raise ValueError("fused_grow: inputs on different devices")
    if len(e_src) != e or len(e_dst) != e:
        raise ValueError(f"fused_grow: {len(e_src)} / {len(e_dst)} edge ends "
                         f"for {e} table rows")
    if not (1 <= n_parts <= MAX_P and 1 <= e <= MAX_E and 1 <= k <= MAX_K):
        raise ValueError(f"fused_grow: P={n_parts}, E={e}, K={k} beyond the "
                         f"kernel's P <= {MAX_P}, E <= {MAX_E}, K <= {MAX_K}")
    if not all(0 <= int(v) < n_parts for v in (*e_src, *e_dst)):
        raise ValueError(f"fused_grow: an edge end outside [0, {n_parts})")
    if growth_steps < 0:
        raise ValueError(f"fused_grow: growth_steps={growth_steps}")

    seed_part, seed_vals = seed_part.contiguous(), seed_vals.contiguous()
    all_tables = [t.contiguous() for t in all_tables]
    out = [torch.empty((b, mh, n_parts), dtype=torch.float32,
                       device=seed_part.device) for _ in range(4)]
    ptrs = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in all_tables))
    src_c = (ctypes.c_int * e)(*(int(v) for v in e_src))
    dst_c = (ctypes.c_int * e)(*(int(v) for v in e_dst))
    lib = build.load("grow")
    fn = lib.hp_fused_grow
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    with torch.cuda.device(seed_part.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            seed_part.data_ptr(), seed_vals.data_ptr(), ctypes.addressof(ptrs),
            ctypes.addressof(src_c), ctypes.addressof(dst_c),
            b, mh, e, k, n_parts, int(growth_steps), int(reverse_match),
            *(t.data_ptr() for t in out), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_grow kernel failed: CUDA error {rc}")
    fused_grow.launches += 1
    return tuple(out)


fused_grow.launches = 0  # kernel launches since the count was last set to 0


def _fused_grow_fake(seed_part, seed_vals, tables, rev_tables, e_src, e_dst, n_parts, *args):
    shape = (*seed_part.shape, n_parts)
    return tuple(seed_vals.new_empty(shape, dtype=torch.float32) for _ in range(4))


_fused_grow_op = define(
    "fused_grow", "(Tensor seed_part, Tensor seed_vals, Tensor[] tables, Tensor[] rev_tables, "
    "int[] e_src, int[] e_dst, int n_parts, int growth_steps, bool reverse_match) "
    "-> (Tensor, Tensor, Tensor, Tensor)",
    lambda *args: tuple(t.contiguous() for t in _fused_grow(*args)), _fused_grow_fake)
