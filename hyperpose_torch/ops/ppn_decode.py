"""Fixed-shape PoseProposal decoder in PyTorch.

Counterpart of `hyperpose_tpu/ops/ppn_decode.py` (reference:
src/pose_proposal.cpp:68-337, hyperpose/Model/pose_proposal/processor.py:55-204):
per-part box NMS over the top-K cells, edge scores gathered from the
[L, hnei, wnei, H, W] tensor, greedy global-max matching per limb, and
person ids propagated down the limb tree.

The JAX code vmaps one image's decode over the batch; here the batch
dimension is written out. Its two early-exit `lax.while_loop`s run exactly
K rounds: the NMS settles box i by round i and a stable round is its fixed
point, and a matching round with no positive candidate changes nothing, so
K rounds give the same result with no host sync. Ranking uses a stable
descending sort, which breaks ties toward the lower index as `lax.top_k`
does, and every argmax takes the first maximum, as `jnp.argmax` does. The
float operations round in JAX's order, so the decode of the same maps is
bit-exact: a coordinate is divided by the input size as XLA divides by a
constant, as a product with the float32 reciprocal, and each human's
score sums its parts left to right, as XLA's reduction does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.topology import PPN_TOPOLOGY, Topology
from .kernels.line_gather import limb_index, limb_pairs
from .paf_decode import DecodedSkeletons, _top_sorted

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class PpnDecoderConfig:
    """The same fields and defaults as the JAX package's `PpnDecoderConfig`
    (thresholds: reference processor.py:42)."""

    max_boxes: int = 16          # kept proposals per part after NMS
    max_humans: int = 16
    thresh_part_score: float = 0.2
    thresh_edge_score: float = 0.2
    thresh_nms_iou: float = 0.3
    min_parts: int = 4
    instance_part: int = 1       # PpnCocoPart.Instance


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] center-format boxes -> [..., K, K] IoU."""
    x, y, w, h = boxes.unbind(-1)
    x1, x2 = x - w / 2, x + w / 2
    y1, y2 = y - h / 2, y + h / 2
    ix = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :])).clamp_min(0.0)
    iy = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :])).clamp_min(0.0)
    inter = ix * iy
    area = w * h
    union = area[..., :, None] + area[..., None, :] - inter + 1e-6
    return inter / union


def _per_part_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes [B, P, K, 4]; returns the keep
    mask [B, P, K] (reference: pose_proposal/utils.py:204-230).

    Box i is kept iff valid and no kept earlier box overlaps it by at least
    the threshold. Iterating keep <- valid & ~any(conflicts & keep) from
    keep = valid settles box i by round i, so K rounds reach the JAX loop's
    fixed point."""
    k = boxes.shape[-2]
    ar = torch.arange(k, device=boxes.device)
    conflicts = (ar[:, None] > ar[None, :]) & (_iou_matrix(boxes) >= iou_thresh)
    keep = valid
    for _ in range(k):
        keep = valid & ~(conflicts & keep[..., None, :]).any(dim=-1)
    return keep


def _greedy_match(match: torch.Tensor) -> torch.Tensor:
    """Greedy global-max matching per limb (reference: processor.py:141-176):
    match [B, L, K, K] -> dst_to_src [B, L, K], the source slot matched to
    each destination slot or -1. Each of K rounds takes every limb's first
    largest candidate and, where it is positive, records it and zeroes its
    row and column."""
    b, l, k, _ = match.shape
    ar = torch.arange(k, device=match.device)
    dst_to_src = torch.full((b, l, k), -1, dtype=torch.int64, device=match.device)
    for _ in range(k):
        best_val, best = match.reshape(b, l, k * k).max(dim=-1)   # ties: the first
        bi, bj = best // k, best % k
        ok = best_val > 0.0
        col = ar == bj[..., None]
        dst_to_src = torch.where(ok[..., None] & col, bi[..., None], dst_to_src)
        zero = (ar == bi[..., None])[..., :, None] | col[..., None, :]
        match = torch.where(ok[..., None, None] & zero, 0.0, match)
    return dst_to_src


def ppn_decode_batch(
    predict: dict,
    cfg: PpnDecoderConfig = PpnDecoderConfig(),
    hnei: int = 9,
    wnei: int = 9,
    in_hw: tuple[int, int] = (384, 384),
    topology: Topology = PPN_TOPOLOGY,
) -> DecodedSkeletons:
    """Batched decode on the device of the maps. predict: {c, i, x, y, w, h}
    as NHWC [B, hout, wout, K] and e as [B, L, hnei, wnei, hout, wout]
    (tensors of any strides, or numpy arrays); x/y/w/h restored to input
    pixels (`PoseProposal.restore_coor`). `i` is not read, as in JAX."""
    pred = {k: torch.as_tensor(v) for k, v in predict.items()}
    pc, pe = pred["c"], pred["e"]
    b, hout, wout, p = pc.shape
    dev = pc.device
    n = hout * wout
    k = min(cfg.max_boxes, n)
    pairs = limb_pairs(topology.limbs)
    limbs = limb_index(pairs, dev)
    l = len(pairs)

    # Top-K cells per part by score: [B, P, K].
    top_scores, top_idx = _top_sorted(pc.reshape(b, n, p).transpose(1, 2), k)
    valid = top_scores > cfg.thresh_part_score
    cell_y, cell_x = top_idx // wout, top_idx % wout

    def g(m):
        return torch.gather(m.reshape(b, n, p).transpose(1, 2), 2, top_idx)

    bx, by, bw, bh = g(pred["x"]), g(pred["y"]), g(pred["w"]), g(pred["h"])
    keep = _per_part_nms(torch.stack([bx, by, bw, bh], dim=-1), valid, cfg.thresh_nms_iou)
    scores = torch.where(keep, top_scores, 0.0)

    # Edge scores between the kept proposals of each limb's two parts
    # (reference: processor.py:125-137): e[b, l, ey, ex, sy, sx] for every
    # (b, l, i, j), gathered through e's strides (no copy of e).
    src, dst = limbs[:, 0], limbs[:, 1]
    sy, sx = cell_y[:, src, :, None], cell_x[:, src, :, None]        # [B, L, K, 1]
    ddy = cell_y[:, dst, None, :] - sy                                # [B, L, K, K]
    ddx = cell_x[:, dst, None, :] - sx
    in_nei = (ddy.abs() <= hnei // 2) & (ddx.abs() <= wnei // 2)
    ey = (ddy + hnei // 2).clamp(0, hnei - 1)
    ex = (ddx + wnei // 2).clamp(0, wnei - 1)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    li = torch.arange(l, device=dev)[None, :, None, None]
    e_val = pe[bi, li, ey, ex, sy, sx]
    e_val = torch.where(in_nei & (e_val >= cfg.thresh_edge_score), e_val, 0.0)
    match = scores[:, src, :, None] * e_val * scores[:, dst, None, :]
    match = torch.where(keep[:, src, :, None] & keep[:, dst, None, :], match, 0.0)
    dst_to_src = _greedy_match(match)

    # Person ids down the limb tree (reference: processor.py:138-181):
    # instance proposals seed ids; each limb copies its source slot's id
    # into its matched destination slot. The limbs are topologically
    # ordered, so one pass suffices; each part's row is a fresh tensor.
    # A limb assigns destination slot j where j is matched and kept: JAX's
    # where(d2s >= 0, id of the source slot, -1), kept only there.
    inst = cfg.instance_part
    rows = [torch.full((b, k), -1, dtype=torch.int64, device=dev)] * p
    rows[inst] = torch.where(keep[:, inst], torch.arange(k, device=dev), -1)
    assign = (dst_to_src >= 0) & keep[:, dst]                        # [B, L, K]
    src_slot = dst_to_src.clamp(min=0)
    for li_, (sp, dp) in enumerate(pairs):
        rows[dp] = torch.where(assign[:, li_], torch.gather(rows[sp], 1, src_slot[:, li_]),
                               rows[dp])
    assem = torch.stack(rows, dim=1)                                  # [B, P, K]

    # Fixed-shape humans: human h <-> instance slot h.
    mh = cfg.max_humans
    hid = torch.arange(mh, device=dev)
    member = (assem[:, None] == hid[None, :, None, None]) & keep[:, None]  # [B, MH, P, K]
    part_score, best_k = torch.where(member, scores[:, None], _NEG).max(dim=-1)
    part_valid = part_score > _NEG * 0.5
    part_score = torch.where(part_valid, part_score, 0.0)

    def at_best(v):
        return torch.gather(v[:, None].expand(b, mh, p, k), 3, best_k[..., None])[..., 0]

    # XLA turns `bx / win` into a product with the float32 reciprocal.
    inv_h, inv_w = (float(np.float32(1.0) / np.float32(s)) for s in in_hw)
    coords = torch.stack([at_best(bx) * inv_w, at_best(by) * inv_h], dim=-1)
    coords = torch.where(part_valid[..., None], coords, 0.0)

    n_parts = part_valid.sum(dim=-1)
    inst_valid = keep[:, inst, :mh]
    if k < mh:
        inst_valid = torch.cat([inst_valid, inst_valid.new_zeros(b, mh - k)], dim=1)
    human_valid = inst_valid & (n_parts >= cfg.min_parts)
    total = part_score[..., 0]
    for q in range(1, p):
        total = total + part_score[..., q]
    human_score = torch.where(human_valid, total, 0.0)
    return DecodedSkeletons(coords, part_score, part_valid & human_valid[..., None],
                            human_score, human_valid)
