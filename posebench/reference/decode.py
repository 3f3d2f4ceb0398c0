"""The plain PAF decode: conf and PAF maps -> fixed-shape skeletons.

A frozen copy of the port's plain decode path (`ops/paf_decode.py` with
`peak_topk_plain` and `limb_scores_plain`, the versions its kernels are
held to bit for bit) at the default decoder settings, in plain PyTorch
float32: Gaussian smooth (reflect-101 borders), 3x3 NMS with the plateau
tie-break, top-K by argmax rounds, quadratic sub-pixel fit; the
line-integral score of every peak pair of every limb (PAF values rounded
to bf16 as the decoder's gather does); greedy connection NMS; skeletons by
min-label propagation; per-skeleton part choice and filters. It imports
nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
N_PARTS, MAX_PEAKS, MAX_CANDIDATES, MAX_HUMANS = 18, 16, 64, 32
UPSAMPLE, N_SAMPLES, SMOOTH_KSIZE, SMOOTH_SIGMA = 4, 10, 5, 0.75
CONF_THRESH, PAF_THRESH, CRIT1_THRESH = 0.05, 0.05, 8
MIN_PARTS, MIN_HUMAN_SCORE, LABEL_PROP_ITERS = 4, 0.4, 18

# 19 COCO limbs in channel order: limb i reads PAF channels 2i (x), 2i + 1 (y).
COCO_LIMBS = (
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
    (1, 2), (2, 3), (3, 4), (2, 16), (1, 5), (5, 6), (6, 7),
    (5, 17), (1, 0), (0, 14), (0, 15), (14, 16), (15, 17),
)


def _taps(ksize: int, sigma: float) -> list[float]:
    half = (ksize - 1) / 2.0
    xs = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return [float(t) for t in (k / k.sum()).astype(np.float32)]


def _smooth(x: torch.Tensor, taps) -> torch.Tensor:
    """Separable smooth of [N, C, H, W] planes, reflect-101, taps summed
    centre first and then the pairs at distance 1, 2, ..."""
    r = len(taps) // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, r, r), mode="reflect")
    sm_v = taps[r] * xp[..., r:r + h, :]
    for i in range(1, r + 1):
        sm_v = sm_v + taps[r - i] * xp[..., r - i:r - i + h, :]
        sm_v = sm_v + taps[r + i] * xp[..., r + i:r + i + h, :]
    xp = F.pad(sm_v, (r, r, 0, 0), mode="reflect")
    sm = taps[r] * xp[..., r:r + w]
    for i in range(1, r + 1):
        sm = sm + taps[r - i] * xp[..., r - i:r - i + w]
        sm = sm + taps[r + i] * xp[..., r + i:r + i + w]
    return sm


def _subpix(fp, fm, f0):
    denom = fp - 2.0 * f0 + fm
    off = torch.where(denom.abs() > 1e-9, 0.5 * (fm - fp) / denom, 0.0)
    return off.clamp(-0.5, 0.5)


def find_peaks(conf: torch.Tensor):
    """conf [B, H, W, P] -> (xy [B, P, K, 2], score [B, P, K], valid)."""
    b, h, w, p = conf.shape
    k = min(MAX_PEAKS, h * w)
    x = conf.permute(0, 3, 1, 2).to(torch.float32)
    sm = _smooth(x, _taps(SMOOTH_KSIZE, SMOOTH_SIGMA))
    pooled = F.max_pool2d(sm, 3, 1, padding=1)
    is_peak = (sm >= pooled) & (sm > CONF_THRESH)
    pix = torch.arange(h * w, device=x.device, dtype=torch.float32).view(h, w)
    cand = torch.where(is_peak, pix, -1.0)
    is_peak = is_peak & (pix == F.max_pool2d(cand, 3, 1, padding=1))
    cur = torch.where(is_peak, sm, NEG).reshape(b, p, h * w)
    smoothed, raw = sm.reshape(b, p, h * w), x.reshape(b, p, h * w)
    hw = h * w
    iota = torch.arange(hw, device=x.device)
    vals, idxs = [], []
    for _ in range(k):
        v, i = cur.max(dim=-1)
        vals.append(v)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], 2.0 * NEG, cur)
    sval = torch.stack(vals, dim=-1)
    top = torch.stack(idxs, dim=-1)
    ys, xs = top // w, top % w

    def g(flat, idx):
        return flat.gather(-1, idx.clamp(0, hw - 1))

    f0 = g(smoothed, top)
    xy = torch.stack([
        xs.to(torch.float32) + _subpix(g(smoothed, top + 1), g(smoothed, top - 1), f0),
        ys.to(torch.float32) + _subpix(g(smoothed, top + w), g(smoothed, top - w), f0),
    ], dim=-1)
    valid = sval > NEG * 0.5
    return xy, torch.where(valid, g(raw, top), 0.0), valid


def limb_scores(paf, peak_xy, peak_valid, limbs: torch.Tensor) -> torch.Tensor:
    """cand_score [B, L, K, K]: the line-integral score of each peak pair, NEG
    where a pair fails."""
    b, h, w, _ = paf.shape
    dev = paf.device
    l, s, k = limbs.shape[0], N_SAMPLES, peak_xy.shape[2]
    pa, pb = peak_xy[:, limbs[:, 0]], peak_xy[:, limbs[:, 1]]
    va, vb = peak_valid[:, limbs[:, 0]], peak_valid[:, limbs[:, 1]]
    diff = pb[:, :, None, :, :] - pa[:, :, :, None, :]
    dx, dy = diff[..., 0], diff[..., 1]
    norm = torch.sqrt(dx * dx + dy * dy)
    den = torch.clamp(norm, min=1e-12)
    ux, uy = dx / den, dy / den
    fs = torch.full((), float(s), dtype=torch.float32, device=dev)
    ts = (torch.arange(s, dtype=torch.float32, device=dev) / fs).reshape(s, 1)
    loc = pa[:, :, :, None, None, :] + ts * diff[:, :, :, :, None, :]
    loc = torch.floor(loc + 0.5).to(torch.int32)
    lx = loc[..., 0].clamp(0, w - 1).long().reshape(b, l, -1)
    ly = loc[..., 1].clamp(0, h - 1).long().reshape(b, l, -1)
    planes = paf.reshape(b, h, w, l, 2).permute(0, 3, 4, 1, 2).to(torch.float32)
    planes = planes.to(torch.bfloat16).to(torch.float32)
    flat = (ly * w + lx)[:, :, None, :]
    vals = torch.gather(planes.reshape(b, l, 2, h * w), 3, flat.expand(b, l, 2, -1))
    px = vals[:, :, 0].reshape(b, l, k, k, s)
    py = vals[:, :, 1].reshape(b, l, k, k, s)
    dot = ux[..., None] * px + uy[..., None] * py
    total, crit1 = dot[..., 0], (dot[..., 0] > PAF_THRESH).to(torch.int32)
    for i in range(1, s):
        total = total + dot[..., i]
        crit1 = crit1 + (dot[..., i] > PAF_THRESH)
    mean_score = total / fs
    half_h = torch.full((), 0.5 * h, dtype=torch.float32, device=dev)
    crit2 = mean_score + torch.clamp(half_h / torch.clamp(UPSAMPLE * norm, min=1e-12) - 1.0, max=0.0)
    ok = (crit1 > CRIT1_THRESH) & (crit2 > 0) & (norm > 1e-6) & va[:, :, :, None] & vb[:, :, None, :]
    return torch.where(ok, crit2, NEG)


def _top_sorted(x, n):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def greedy_connections(cand_score):
    """Greedy NMS per limb: a candidate is kept iff no earlier kept one
    shares its source or destination peak."""
    b, l, k, _ = cand_score.shape
    t = min(MAX_CANDIDATES, k * k)
    top_vals, top_idx = _top_sorted(cand_score.reshape(b, l, k * k), t)
    src, dst = top_idx // k, top_idx % k
    valid = top_vals > NEG * 0.5
    ar = torch.arange(t, device=cand_score.device)
    earlier = ar[:, None] > ar[None, :]
    conflicts = (earlier & ((src[..., :, None] == src[..., None, :])
                            | (dst[..., :, None] == dst[..., None, :]))).to(torch.float32)
    accepted = valid
    for _ in range(t):
        hits = torch.matmul(conflicts, accepted.to(torch.float32)[..., None])
        accepted = valid & (hits[..., 0] == 0)
    return src, dst, top_vals, accepted


def assemble(src, dst, conn_score, accepted, peak_xy, peak_score, limbs, hw):
    """Accepted connections -> skeletons: each connected component of
    (part, peak) nodes is one human."""
    p, k = N_PARTS, MAX_PEAKS
    n = p * k
    b = src.shape[0]
    dev = src.device
    uf = (limbs[None, :, 0:1] * k + src).reshape(b, -1)
    vf = (limbs[None, :, 1:2] * k + dst).reshape(b, -1)
    af = accepted.reshape(b, -1)
    sf = torch.where(af, conn_score.reshape(b, -1), 0.0)
    adj = torch.zeros(b, n * n, dtype=torch.float32, device=dev)
    adj.scatter_add_(1, uf * n + vf, af.to(torch.float32))
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    adj = adj.reshape(b, n, n) > 0
    adj = adj | adj.transpose(1, 2) | eye
    labels0 = torch.arange(n, device=dev)
    labels = labels0.expand(b, n)
    big = torch.full((), n, device=dev)
    for _ in range(LABEL_PROP_ITERS):
        labels = torch.where(adj, labels[:, None, :], big).amin(dim=2)
    in_edge = torch.any(adj & ~eye, dim=2)
    comp_member = (labels[:, None, :] == labels0[None, :, None]) & in_edge[:, None, :]
    cm = comp_member.to(torch.float32)
    edge_root = torch.gather(cm.transpose(1, 2), 1, uf[..., None].expand(b, uf.shape[1], n))
    conn_sum = torch.einsum("ber,be->br", edge_root, sf)
    presence = comp_member.reshape(b, n, p, k).any(dim=-1)
    n_parts_comp = presence.sum(dim=-1)
    peak_sum = torch.einsum("brn,bn->br", cm, peak_score.reshape(b, n))
    comp_score = peak_sum + conn_sum
    is_root = (labels == labels0) & in_edge
    keep = (is_root & (n_parts_comp >= MIN_PARTS)
            & (comp_score / torch.clamp(n_parts_comp, min=1) >= MIN_HUMAN_SCORE))
    rank = torch.where(keep, comp_score, NEG)
    top_scores, top_roots = _top_sorted(rank, MAX_HUMANS)
    human_valid = top_scores > NEG * 0.5
    member = (labels[:, None, :] == top_roots[:, :, None]) & in_edge[:, None, :]
    member = member.reshape(b, MAX_HUMANS, p, k)
    member_scores = torch.where(member, peak_score[:, None], NEG)
    part_score, best_k = member_scores.max(dim=-1)
    part_valid = part_score > NEG * 0.5
    part_score = torch.where(part_valid, part_score, 0.0)
    xy = torch.gather(peak_xy[:, None].expand(b, MAX_HUMANS, p, k, 2), 3,
                      best_k[..., None, None].expand(b, MAX_HUMANS, p, 1, 2))[:, :, :, 0]
    h, w = hw
    coords = torch.stack([(xy[..., 0] + 0.5) / w, (xy[..., 1] + 0.5) / h], dim=-1)
    coords = torch.where(part_valid[..., None], coords, 0.0)
    scores = torch.where(human_valid, top_scores, 0.0)
    return coords, part_score, part_valid & human_valid[..., None], scores, human_valid


def paf_decode(conf: torch.Tensor, paf: torch.Tensor) -> dict:
    """conf [B, H, W, >= 18], paf [B, H, W, 38] -> numpy skeleton fields
    `coords` [B, 32, 18, 2] (normalized x, y), `part_scores`, `part_valid`,
    `scores`, `valid`."""
    b, h, w, _ = conf.shape
    conf = conf.to(torch.float32)[..., :N_PARTS]
    paf = paf.to(torch.float32)
    limbs = torch.tensor(COCO_LIMBS, dtype=torch.int64, device=conf.device)
    xy, score, valid = find_peaks(conf)
    cand = limb_scores(paf, xy, valid, limbs)
    src, dst, cscore, accepted = greedy_connections(cand)
    out = assemble(src, dst, cscore, accepted, xy, score, limbs, (h, w))
    names = ("coords", "part_scores", "part_valid", "scores", "valid")
    return {n: t.cpu().numpy() for n, t in zip(names, out)}
