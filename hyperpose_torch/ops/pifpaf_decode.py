"""Fixed-shape PifPaf composite-field decoder in PyTorch.

Counterpart of `hyperpose_tpu/ops/pifpaf_decode.py` (reference:
hyperpose/Model/pifpaf/processor.py:89-393,
src/pifpaf_decoder/openpifpaf_postprocessor.cpp:657-926), with the same
stages and bounded shapes, so a batch decodes on the device with no host
round trip:

  1. `restore_maps`: sigmoid confidences, offsets plus the cell grid, and
     softplus scales, times the stride;
  2. `_prepare`: per part the top-C high-resolution CIF contributors
     (evaluated lazily at query points), seed candidates (per-part local
     maxima plus a raster-order set), seed NMS, directed-edge candidate
     tables from the CAF fields, person-component grouping of the seeds by
     min-label propagation, and the top-MH seed pick;
  3. growth (`kernels/grow.py`, a CUDA kernel on the card): `growth_steps`
     Jacobi rounds of find_connection over every directed edge;
  4. `_finalize`: rank-ordered keypoint NMS, scoring, filtering.

The JAX code vmaps stages 2 and 4 over images; here the batch dimension is
written out. Its label propagation and growth already run a fixed count of
rounds (10 and `growth_steps`). Its one-hot matmuls (`_bounded_select`, the
top-MH pick) are exact gathers on the CPU; here they are scatters into
`capacity + 1` slots whose last slot takes the overflow and is dropped, which
is exact on every device (a float32 matmul on the card could round through
TF32). Ties go to the lowest index everywhere, as in `jnp.argmax` and the
JAX decoder's `min(where(w >= max, iota, n))` rounds.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.topology import PIFPAF_TOPOLOGY, Topology
from .kernels.grow import find_connection, fused_grow, fused_grow_plain
from .kernels.library import device_table
from .paf_decode import DecodedSkeletons

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class PifPafDecoderConfig:
    """Static decode parameters: the same fields and defaults as the JAX
    package's `PifPafDecoderConfig`.

    grow_backend: "auto" runs the CUDA growth kernel on a CUDA tensor and
    its plain PyTorch version on a CPU tensor; "xla" forces the plain
    version; "pallas" is "auto" (the kernel path, which on a CPU tensor is
    the plain version). grow_unroll has no effect here: PyTorch runs the
    rounds eagerly either way."""

    n_pos: int = 17
    n_limbs: int = 19
    max_hr_contrib: int = 96   # C: cells per part feeding hr queries
    seeds_per_part: int = 12
    max_flat_seeds: int = 64   # extra raster-order seed candidates
    max_paf_cands: int = 128   # Kc per limb
    component_picks: bool = True
    max_humans: int = 32
    growth_steps: int = 8
    thresh_pif: float = 0.3        # reference: processor.py:47-48
    thresh_paf: float = 0.1
    thresh_ref_pif: float = 0.3
    thresh_ref_paf: float = 0.1
    thresh_gen_ref_pif: float = 0.1
    hr_divisor: float = 16.0       # add_gaussian neighbor_num
    min_scale: float = 4.0
    part_num_thresh: int = 4
    score_thresh: float = 0.1
    reverse_match: bool = True
    grow_backend: str = "auto"
    grow_unroll: bool = False


def _pairwise_rank(v: torch.Tensor) -> torch.Tensor:
    """Position of each element in a stable DESCENDING sort of v over the
    last dim: rank_i = #{j: v_j > v_i} + #{j < i: v_j == v_i} (int32)."""
    idx = torch.arange(v.shape[-1], device=v.device)
    gt = v[..., None, :] > v[..., :, None]
    eq_before = (v[..., None, :] == v[..., :, None]) & (idx[None, :] < idx[:, None])
    return (gt | eq_before).sum(dim=-1).to(torch.int32)


def _bounded_select(mask: torch.Tensor, fields: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """Compact the elements where `mask` [..., N] is True into the first
    slots of a `capacity`-wide table, in raster order, dropping the
    overflow. fields [..., N, F] -> [..., capacity, F], zeros in empty
    slots (slot c is filled iff c < the row's count)."""
    slot = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    slot = torch.where(mask & (slot < capacity), slot, capacity).to(torch.int64)
    f = fields.shape[-1]
    out = fields.new_zeros((*fields.shape[:-2], capacity + 1, f))
    out.scatter_(-2, slot[..., None].expand(*slot.shape, f), fields)
    return out[..., :capacity, :]


def _hr_query_rows(qx, qy, cx, cy, cconf, cscale, cvalid, divisor):
    """High-resolution CIF confidence at query points: qx/qy [..., Q],
    contributors [..., Q, C]. Truncated Gaussian with sigma = scale, the
    centre pixel pinned to conf, sum / divisor, clipped to [0, 1]
    (reference: pifpaf/utils.py:242-273)."""
    d2 = (qx[..., None] - cx) ** 2 + (qy[..., None] - cy) ** 2
    sig2 = torch.clamp(cscale, min=1e-3) ** 2
    g = cconf * torch.exp(-0.5 * d2 / sig2)
    g = torch.where(d2 <= sig2, g, 0.0)
    g = torch.where(d2 < 0.25, cconf, g)
    g = torch.where(cvalid, g, 0.0)
    return torch.clamp(_exact_sum(g) / divisor, 0.0, 1.0)


def _exact_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in float64, rounded once to float32: the same
    value in any order of the terms, so the card and the CPU, which reduce
    in other orders, agree, and equal totals stay equal. XLA's float32
    order is its own; where painted fields give the JAX decoder exactly
    equal duplicate skeletons, which of them keeps its slot may differ
    (ROADMAP Queue 3)."""
    return x.sum(dim=-1, dtype=torch.float64).to(torch.float32)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, P, ...] gathered at per-image part indices idx [B, Q] (or a
    shared [Q]) -> [B, Q, ...]."""
    if idx.ndim == 1:
        return t[:, idx]
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


@device_table
def _edge_tables(topology: Topology, device: torch.device):
    """(src_parts [L], dst_parts [L], e_src [2L], e_dst [2L], rev [2L]) on
    `device`, copied once. Directed edge e < L is limb e forward (match on
    its source, output its destination), e >= L the limb backward; the
    reverse of e is (e + L) % 2L."""
    limbs = np.asarray(topology.limbs)
    n = len(limbs)
    arrays = (limbs[:, 0], limbs[:, 1],
              np.concatenate([limbs[:, 0], limbs[:, 1]]),
              np.concatenate([limbs[:, 1], limbs[:, 0]]),
              (np.arange(2 * n) + n) % (2 * n))
    return tuple(torch.tensor(np.array(a, np.int64), device=device) for a in arrays)


def _prepare(maps: dict, cfg: PifPafDecoderConfig, topology: Topology) -> dict:
    """Seed selection and directed-edge candidate tables for a batch (the
    JAX `_prepare_one`, batched): everything the growth consumes."""
    p, l = cfg.n_pos, cfg.n_limbs
    pif_conf = maps["pif_conf"]                          # [B, H, W, P]
    b, h, w, _ = pif_conf.shape
    n = h * w
    dev = pif_conf.device
    src_parts, dst_parts, e_src, e_dst, _ = _edge_tables(topology, dev)

    def pn(t):                                           # [B, H, W, X] -> [B, X, N]
        return t.reshape(b, n, -1).transpose(1, 2)

    # ---- per-part hr contributors ------------------------------------------
    conf_pn = pn(pif_conf)
    pif_fields = torch.stack([
        conf_pn, pn(maps["pif_vec"][..., 0]), pn(maps["pif_vec"][..., 1]),
        pn(maps["pif_scale"]),
    ], dim=-1)                                           # [B, P, N, 4]
    csel = _bounded_select(conf_pn > cfg.thresh_gen_ref_pif, pif_fields,
                           min(cfg.max_hr_contrib, n))   # [B, P, C, 4]
    cvals, cvx, cvy, csc = csel.unbind(-1)
    cvalid = cvals > cfg.thresh_gen_ref_pif

    def hr_at(part_idx, qx, qy):
        """hr conf of part part_idx ([B, Q] or [Q]) at [B, Q] points."""
        return _hr_query_rows(
            qx, qy, _rows(cvx, part_idx), _rows(cvy, part_idx),
            _rows(cvals, part_idx), _rows(csc, part_idx),
            _rows(cvalid, part_idx), cfg.hr_divisor,
        )

    # ---- seeds: per-part local maxima plus the raster-order set -----------
    planes = pif_conf.permute(0, 3, 1, 2)
    peak = F.max_pool2d(planes, 3, 1, padding=1).permute(0, 2, 3, 1)   # pads -inf
    is_peak = (pif_conf >= peak) & (pif_conf > cfg.thresh_pif)
    sp_cap = min(cfg.seeds_per_part, n)
    psel_seeds = _bounded_select(pn(is_peak), pif_fields, sp_cap).reshape(
        b, p * sp_cap, 4)
    peak_parts = torch.arange(p, device=dev).repeat_interleave(sp_cap)
    n_flat = min(cfg.max_flat_seeds, p * n)
    part_f = torch.arange(p, dtype=torch.float32, device=dev).repeat_interleave(n)
    flat_fields = torch.cat([pif_fields.reshape(b, p * n, 4),
                             part_f[None, :, None].expand(b, p * n, 1)], dim=-1)
    fsel = _bounded_select(conf_pn.reshape(b, -1) > cfg.thresh_pif,
                           flat_fields, n_flat)          # [B, F, 5]
    ssel = torch.cat([psel_seeds, fsel[..., :4]], dim=1)
    seed_part = torch.cat([peak_parts.expand(b, -1),
                           fsel[..., 4].to(torch.int64)], dim=1)   # [B, S]
    svals, seed_x, seed_y, seed_scale = ssel.unbind(-1)
    hr_s = hr_at(seed_part, seed_x, seed_y)
    seed_score = 0.9 * hr_s + 0.1 * torch.clamp(svals, min=0.0)
    seed_valid = (svals > cfg.thresh_pif) & (seed_score > cfg.thresh_ref_pif)
    seed_rank = _pairwise_rank(torch.where(seed_valid, seed_score, _NEG))

    # ---- paf candidates -> directed edge tables ---------------------------
    kc = min(cfg.max_paf_cands, n)
    conf_ln = pn(maps["paf_conf"])                       # [B, L, N]
    paf_fields = torch.stack([
        conf_ln,
        pn(maps["paf_src_vec"][..., 0]), pn(maps["paf_src_vec"][..., 1]),
        pn(maps["paf_src_scale"]),
        pn(maps["paf_dst_vec"][..., 0]), pn(maps["paf_dst_vec"][..., 1]),
        pn(maps["paf_dst_scale"]),
    ], dim=-1)                                           # [B, L, N, 7]
    psel = _bounded_select(conf_ln > cfg.thresh_paf, paf_fields, kc)
    pvals, sx, sy, ss, dx, dy, ds = psel.unbind(-1)      # [B, L, Kc]
    pvalid = pvals > cfg.thresh_paf
    # CIF_FLOOR rescoring (reference: processor.py:132-155).
    hr_f = hr_at(dst_parts.repeat_interleave(kc), dx.reshape(b, -1),
                 dy.reshape(b, -1)).reshape(b, l, kc)
    score_f = pvals * (0.1 + 0.9 * hr_f)
    fvalid = pvalid & (score_f > cfg.thresh_ref_paf)
    hr_b = hr_at(src_parts.repeat_interleave(kc), sx.reshape(b, -1),
                 sy.reshape(b, -1)).reshape(b, l, kc)
    score_b = pvals * (0.1 + 0.9 * hr_b)
    bvalid = pvalid & (score_b > cfg.thresh_ref_paf)

    em_x = torch.cat([sx, dx], dim=1)                    # [B, 2L, Kc] match side
    em_y = torch.cat([sy, dy], dim=1)
    eo_x = torch.cat([dx, sx], dim=1)                    # output side
    eo_y = torch.cat([dy, sy], dim=1)
    eo_s = torch.cat([ds, ss], dim=1)
    e_score = torch.cat([score_f, score_b], dim=1)
    e_valid = torch.cat([fvalid, bvalid], dim=1)

    # ---- seed NMS: suppressed within the occupancy radius of a better seed
    # of the same part ------------------------------------------------------
    occ_seed = torch.clamp(seed_scale, min=cfg.min_scale)
    near_seed = (
        (seed_part[:, :, None] == seed_part[:, None, :])
        & ((seed_x[:, :, None] - seed_x[:, None, :]).abs() <= occ_seed[:, None, :])
        & ((seed_y[:, :, None] - seed_y[:, None, :]).abs() <= occ_seed[:, None, :])
        & (seed_rank[:, :, None] > seed_rank[:, None, :])
        & seed_valid[:, None, :]
    )
    seed_keep = seed_valid & ~near_seed.any(dim=2)

    if not cfg.component_picks:
        pick_scores = torch.where(seed_keep, seed_score, _NEG)
    else:
        pick_scores = _component_pick_scores(
            cfg, sp_cap, seed_x, seed_y, seed_scale, seed_score, seed_keep,
            e_src, e_dst, em_x, em_y, e_score, e_valid, eo_x, eo_y, eo_s)
    return _finish_prepare(cfg, pick_scores, seed_part, seed_x, seed_y,
                           seed_scale, seed_score, seed_keep, e_valid, e_score,
                           em_x, em_y, eo_x, eo_y, eo_s)


def _component_pick_scores(cfg, sp_cap, seed_x, seed_y, seed_scale,
                           seed_score, seed_keep, e_src, e_dst, em_x, em_y,
                           e_score, e_valid, eo_x, eo_y, eo_s):
    """Person-component grouping, the parallel analog of the reference's
    occupancy skipping (processor.py:163-179): link the peak seeds the PAF
    tables connect, take components by 10 rounds of min-label propagation,
    and lift every component's best seed (and every kept flat seed) by 10
    so that each is guaranteed a pick slot."""
    p = cfg.n_pos
    b = seed_x.shape[0]
    dev = seed_x.device
    n_peak = p * sp_cap

    def blk(v):
        return v[:, :n_peak].reshape(b, p, sp_cap)

    bx, by = blk(seed_x), blk(seed_y)
    bsc = torch.clamp(blk(seed_scale), min=cfg.min_scale)
    bkeep = blk(seed_keep)
    qx, qy, qs = bx[:, e_src], by[:, e_src], bsc[:, e_src]      # [B, E, Sp]
    qkeep = bkeep[:, e_src]
    # An invalid candidate has score 0, so it never matches (JAX's mvalid).
    ms_all = torch.where(e_valid, e_score, 0.0)
    fc, fx, fy, _ = find_connection(
        *(t[:, :, None] for t in (em_x, em_y, ms_all, eo_x, eo_y, eo_s)),
        qx, qy, qs)                                              # [B, E, Sp]

    tx, ty = bx[:, e_dst], by[:, e_dst]
    tocc, tkeep = bsc[:, e_dst], bkeep[:, e_dst]
    near = (
        (qkeep & (fc > 0.0))[..., None]
        & tkeep[:, :, None, :]
        & ((fx[..., None] - tx[:, :, None, :]).abs() <= tocc[:, :, None, :])
        & ((fy[..., None] - ty[:, :, None, :]).abs() <= tocc[:, :, None, :])
    )                                                            # [B, E, Sp, Sp]
    sp_i = torch.arange(sp_cap, device=dev)
    rows = e_src[:, None, None] * sp_cap + sp_i[None, :, None]
    cols = e_dst[:, None, None] * sp_cap + sp_i[None, None, :]
    flat = (rows * n_peak + cols).reshape(-1)
    # Duplicate (row, col) pairs OR together: counts of 0/1 are exact.
    adj = torch.zeros(b, n_peak * n_peak, device=dev)
    adj.index_add_(1, flat, near.reshape(b, -1).to(torch.float32))
    adj = adj.reshape(b, n_peak, n_peak) > 0
    eye = torch.eye(n_peak, dtype=torch.bool, device=dev)
    adj = adj | adj.transpose(1, 2) | eye
    pkeep = seed_keep[:, :n_peak]
    big = torch.full((), n_peak, device=dev)  # made on the device: no host copy
    labels = torch.where(pkeep, torch.arange(n_peak, device=dev), big)
    for _ in range(10):
        labels = torch.where(adj, labels[:, None, :], big).amin(dim=2)

    same_comp = labels[:, :, None] == labels[:, None, :]
    key = torch.where(pkeep, seed_score[:, :n_peak], _NEG) \
        - torch.arange(n_peak, dtype=torch.float32, device=dev) * 1e-7
    comp_best = torch.where(same_comp, key[:, None, :], _NEG).amax(dim=2)
    is_rep = torch.cat([pkeep & (key >= comp_best), seed_keep[:, n_peak:]], dim=1)
    return torch.where(seed_keep, seed_score + 10.0 * is_rep.to(torch.float32),
                       _NEG)


def _finish_prepare(cfg, pick_scores, seed_part, seed_x, seed_y, seed_scale,
                    seed_score, seed_keep, e_valid, e_score,
                    em_x, em_y, eo_x, eo_y, eo_s) -> dict:
    """Top-MH pick without sorting (slot r takes the seed of rank r; ties
    to the lower index) and the edge tables."""
    mh = cfg.max_humans
    pick_rank = _pairwise_rank(pick_scores).to(torch.int64)
    slot = torch.clamp(pick_rank, max=mh)               # ranks >= MH overflow
    vals = torch.stack([
        seed_part.to(torch.float32), seed_x, seed_y, seed_scale, seed_score,
        seed_keep.to(torch.float32),
    ], dim=-1)                                           # [B, S, 6]
    picked = vals.new_zeros((vals.shape[0], mh + 1, 6))
    picked.scatter_(1, slot[..., None].expand(*slot.shape, 6), vals)
    picked = picked[:, :mh]
    # Validity folded into the candidate score: a zero score never matches.
    em_s = torch.where(e_valid, e_score, 0.0)
    return {
        "seed_part": picked[..., 0].to(torch.int32),
        "seed_vals": picked[..., 1:5].contiguous(),
        "pick_valid": picked[..., 5] > 0.5,
        "tables": (em_x, em_y, em_s, eo_x, eo_y, eo_s),
    }


def _finalize(a_score, a_x, a_y, a_sc, pick_valid,
              cfg: PifPafDecoderConfig, in_hw: tuple[int, int]):
    """Keypoint-wise NMS + scoring + fixed-shape output; all [B, MH, P]
    (reference: processor.py:245-259)."""
    hin, win = in_hw
    a_score = torch.where(pick_valid[..., None], a_score, 0.0)
    # Duplicates grown from different seeds can have equal totals from
    # differently ordered part scores: an order-free sum ranks them alike on
    # every device.
    totals = _exact_sum(a_score)                         # [B, MH]
    inv_rank = _pairwise_rank(totals)
    occ_r = torch.clamp(a_sc, min=cfg.min_scale)
    # ann i is suppressed at part k by a better-ranked ann j nearby.
    near = (
        (a_score[:, None, :, :] > 0)
        & ((a_x[:, :, None, :] - a_x[:, None, :, :]).abs() <= occ_r[:, None, :, :])
        & ((a_y[:, :, None, :] - a_y[:, None, :, :]).abs() <= occ_r[:, None, :, :])
        & (inv_rank[:, None, :, None] < inv_rank[:, :, None, None])
    )                                                    # [B, MH(i), MH(j), P]
    a_score = torch.where(near.any(dim=2), 0.0, a_score)

    part_valid = a_score > 0.0
    n_parts = part_valid.sum(dim=2)
    human_score = _exact_sum(a_score) / torch.clamp(n_parts, min=1)
    human_valid = (n_parts >= cfg.part_num_thresh) & (human_score >= cfg.score_thresh)
    coords = torch.stack([a_x / win, a_y / hin], dim=-1)
    coords = torch.where(part_valid[..., None], coords, 0.0)
    part_scores = torch.where(part_valid, a_score, 0.0)
    part_valid = part_valid & human_valid[..., None]
    human_score = torch.where(human_valid, human_score, 0.0)
    return coords, part_scores, part_valid, human_score, human_valid


def restore_maps(predict: dict, stride: int) -> dict:
    """Inference activations + coordinate restoration (reference: model.py
    infer, utils.py restore_pif_maps/restore_paf_maps) on raw NHWC fields,
    cast to float32 first. The grid is x along W and y along H (the JAX
    `meshgrid` is "xy"); softplus is log(1 + e^x) at every x, as
    `jax.nn.softplus` (`F.softplus` turns linear above 20)."""
    predict = {k: v.to(torch.float32) for k, v in predict.items()}
    pif_conf = torch.sigmoid(predict["pif_conf"])
    b, h, w, _ = pif_conf.shape
    dev = pif_conf.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    mesh = torch.stack([xs, ys], dim=-1)[None, :, :, None, :]   # [1, H, W, 1, 2]

    def vec(v):
        return (v + mesh) * stride

    def sc(s):
        return torch.logaddexp(s, torch.zeros_like(s)) * stride

    return {
        "pif_conf": pif_conf,
        "pif_vec": vec(predict["pif_vec"]),
        "pif_scale": sc(predict["pif_scale"]),
        "paf_conf": torch.sigmoid(predict["paf_conf"]),
        "paf_src_vec": vec(predict["paf_src_vec"]),
        "paf_dst_vec": vec(predict["paf_dst_vec"]),
        "paf_src_scale": sc(predict["paf_src_scale"]),
        "paf_dst_scale": sc(predict["paf_dst_scale"]),
    }


def grow_inputs(prep: dict, cfg: PifPafDecoderConfig, topology: Topology) -> tuple:
    """`fused_grow`'s arguments for `_prepare`'s output. The reverse tables
    are the forward ones permuted by rev(e) = (e + L) % 2L."""
    limbs = np.asarray(topology.limbs)
    e_src = tuple(int(v) for v in np.concatenate([limbs[:, 0], limbs[:, 1]]))
    e_dst = tuple(int(v) for v in np.concatenate([limbs[:, 1], limbs[:, 0]]))
    rev = _edge_tables(topology, prep["seed_part"].device)[4]
    rev_tables = tuple(t[:, rev] for t in prep["tables"])
    return (prep["seed_part"], prep["seed_vals"], prep["tables"], rev_tables,
            e_src, e_dst, cfg.n_pos, cfg.growth_steps, cfg.reverse_match)


def pifpaf_decode_batch(
    predict: dict,
    cfg: PifPafDecoderConfig = PifPafDecoderConfig(),
    stride: int = 8,
    in_hw: tuple[int, int] = (368, 432),
    topology: Topology = PIFPAF_TOPOLOGY,
) -> DecodedSkeletons:
    """Batched decode from RAW model outputs (pre-activation NHWC fields,
    tensors or numpy arrays) on the device of `predict["pif_conf"]`."""
    predict = {k: torch.as_tensor(v) for k, v in predict.items()}
    if cfg.grow_backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"grow_backend must be 'auto', 'xla' or 'pallas', "
                         f"got {cfg.grow_backend!r}")
    maps = restore_maps(predict, stride)
    prep = _prepare(maps, cfg, topology)
    grow = fused_grow_plain if cfg.grow_backend == "xla" else fused_grow
    a_score, a_x, a_y, a_sc = grow(*grow_inputs(prep, cfg, topology))
    return DecodedSkeletons(*_finalize(a_score, a_x, a_y, a_sc,
                                       prep["pick_valid"], cfg, in_hw))
