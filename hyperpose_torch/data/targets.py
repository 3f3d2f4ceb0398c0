"""Training targets of the three model families, built on the device of the
keypoints.

A port of `hyperpose_tpu/data/targets.py` (reference:
hyperpose/Model/openpose/utils.py:55-216 put_heatmap / cal_vectormap_fast,
pose_proposal/utils.py:17-69 get_pose_proposals, pifpaf/utils.py:117-240
put_pifmap / put_pafmap): fixed-shape tensor functions vectorized over
batch, people and parts, so the host ships only uint8 images and keypoint
arrays and the device builds the dense maps inside the training step.

Conventions shared by all generators:
  kpts  [B, M, P, 2] float32 — (x, y) in input-image pixels; missing
        keypoints hold a large negative sentinel (augment.MISSING).
  valid [B, M, P] bool — per-keypoint visibility.
  limbs [L, 2] int — part-index pairs in channel order (numpy or a tensor;
        a tensor on the keypoints' device is used as it is, with no copy
        from the host, as a CUDA graph of the step needs).

The OpenPose maps are dense and equal JAX's up to the last place of `exp`.
The PoseProposal and PifPaf generators sum each person's contribution into
its cell with `index_add_` where JAX uses `.at[idx].add`: counts are exact
integers; a float sum over several people in one cell may round in another
order (on the GPU the atomics order it differently from run to run), within
1 ulp of the sum per added term.
"""
from __future__ import annotations

import numpy as np
import torch

# Threshold on the Gaussian exponent; exp(-4.6052) ~ 0.01
# (reference: openpose/utils.py:75 `arg > 4.6052` cutoff).
_CONF_ARG_CUTOFF = 4.6052


def _limbs(limbs, device) -> torch.Tensor:
    if isinstance(limbs, torch.Tensor):
        return limbs.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(limbs), dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# OpenPose family: part-confidence + part-affinity-field maps
# ---------------------------------------------------------------------------

def openpose_conf_map(kpts: torch.Tensor, valid: torch.Tensor, in_hw: tuple[int, int],
                      out_hw: tuple[int, int], sigma: float = 7.0) -> torch.Tensor:
    """Gaussian part-confidence maps + background channel.

    Returns [B, hout, wout, P+1]; channel P is the background
    `clip(1 - max_parts, 0, 1)` (reference: openpose/utils.py:48,55-86:
    per-person max-combined Gaussians with the 4.6052 exponent cutoff, grid
    sample points at stride*i + stride/2 - 0.5)."""
    hin, win = in_hw
    hout, wout = out_hw
    sy, sx = hin / hout, win / wout
    dev = kpts.device
    gy = torch.arange(hout, dtype=torch.float32, device=dev) * sy + sy / 2.0 - 0.5
    gx = torch.arange(wout, dtype=torch.float32, device=dev) * sx + sx / 2.0 - 0.5

    cx, cy = kpts[..., 0], kpts[..., 1]  # [B, M, P]
    ok = valid & (cx >= 0) & (cy >= 0)
    dy2 = (gy - cy[..., None]) ** 2      # [B, M, P, hout]
    dx2 = (gx - cx[..., None]) ** 2      # [B, M, P, wout]
    arg = (dy2[..., :, None] + dx2[..., None, :]) / (2.0 * sigma * sigma)
    g = torch.where((arg <= _CONF_ARG_CUTOFF) & ok[..., None, None], torch.exp(-arg), 0.0)
    heat = g.amax(dim=1)                 # [B, P, hout, wout]: max over people
    bg = torch.clamp(1.0 - heat.amax(dim=1), 0.0, 1.0)
    return torch.cat([heat, bg[:, None]], dim=1).permute(0, 2, 3, 1)


def openpose_paf_map(kpts: torch.Tensor, valid: torch.Tensor, limbs,
                     in_hw: tuple[int, int], out_hw: tuple[int, int],
                     width: float = 1.0) -> torch.Tensor:
    """Count-normalized part-affinity vector fields.

    Returns [B, hout, wout, 2L] with limb l writing channels (2l, 2l+1) =
    (vx, vy). A grid cell inside a limb's band (|perpendicular| <= width grid
    cells, 0 <= projection <= limb length) accumulates the limb's unit
    vector; overlapping people average by contribution count
    (reference: openpose/utils.py:89-216 get_paf_map / cal_vectormap_fast)."""
    dev = kpts.device
    limbs = _limbs(limbs, dev)
    hin, win = in_hw
    hout, wout = out_hw
    # Filled on the device, not copied from the host: a CUDA graph of the
    # training step holds the targets (`train/graphs.py`).
    scale = torch.full((2,), win / wout, dtype=torch.float32, device=dev)
    scale[1:].fill_(hin / hout)

    src = kpts[:, :, limbs[:, 0]] / scale  # [B, M, L, 2] grid coords
    dst = kpts[:, :, limbs[:, 1]] / scale
    ok = valid[:, :, limbs[:, 0]] & valid[:, :, limbs[:, 1]]  # [B, M, L]

    vec = dst - src
    norm = torch.sqrt(torch.sum(vec * vec, dim=-1))  # [B, M, L]
    unit = vec / torch.clamp_min(norm, 1e-8)[..., None]

    gy = torch.arange(hout, dtype=torch.float32, device=dev)
    gx = torch.arange(wout, dtype=torch.float32, device=dev)
    rel_x = gx.view(1, 1, 1, 1, wout) - src[..., 0][..., None, None]
    rel_y = gy.view(1, 1, 1, hout, 1) - src[..., 1][..., None, None]
    ux = unit[..., 0][..., None, None]
    uy = unit[..., 1][..., None, None]
    along = rel_x * ux + rel_y * uy
    perp = torch.abs(rel_x * uy - rel_y * ux)
    band = ((along >= 0.0) & (along <= norm[..., None, None]) & (perp <= width)
            & ok[..., None, None])
    bandf = band.to(torch.float32)
    # Sum unit vectors over people, normalize by contributor count
    # (reference: utils.py:169-216 vectormap accumulated then /= count).
    sum_x = torch.sum(bandf * ux, dim=1)  # [B, L, hout, wout]
    sum_y = torch.sum(bandf * uy, dim=1)
    count = torch.clamp_min(torch.sum(bandf, dim=1), 1.0)
    paf = torch.stack([sum_x / count, sum_y / count], dim=2)  # [B, L, 2, h, w]
    b, n_limbs = paf.shape[0], paf.shape[1]
    return paf.reshape(b, 2 * n_limbs, hout, wout).permute(0, 2, 3, 1)


def openpose_targets(kpts: torch.Tensor, valid: torch.Tensor, limbs,
                     in_hw: tuple[int, int], out_hw: tuple[int, int],
                     mask: torch.Tensor | None = None, sigma: float = 7.0) -> dict:
    """Bundle conf + paf maps. `mask` is accepted for signature parity; the
    OpenPose loss applies the don't-care mask itself (models/openpose.py)."""
    del mask
    return {
        "conf_map": openpose_conf_map(kpts, valid, in_hw, out_hw, sigma),
        "paf_map": openpose_paf_map(kpts, valid, limbs, in_hw, out_hw),
    }


# ---------------------------------------------------------------------------
# PoseProposal: grid-cell detection + limb edge tensor
# ---------------------------------------------------------------------------

def _scatter_add(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros([V, n]).at[:, idx].add(vals) for idx [K] and vals [V, K]
    (or zeros([n]) for vals [K])."""
    out = torch.zeros((*vals.shape[:-1], n), dtype=vals.dtype, device=vals.device)
    return out.index_add_(out.ndim - 1, idx, vals)


def ppn_targets(kpts: torch.Tensor, valid: torch.Tensor, bbxs: torch.Tensor, limbs,
                in_hw: tuple[int, int], out_hw: tuple[int, int],
                nei: tuple[int, int] = (9, 9), instance_idx: int = 1) -> dict:
    """PoseProposal grid targets.

    Returns dict of
      c/x/y/w/h [B, hout, wout, K]  — cell one-hot confidence, fractional
        cell offsets, and box sizes normalized by (win, hin); part boxes are
        max(bbox_w, bbox_h)/8 px, the Instance anchor /4
        (reference: pose_proposal/utils.py:17-69 get_pose_proposals).
      e      [B, L, hnei, wnei, hout, wout] — 1 where limb l connects the
        source cell to the (di, dj) neighborhood offset of its target cell.
      e_mask [B, L, hnei, wnei, hout, wout] — supervision window: the full
        neighborhood of every cell holding a valid source part of limb l."""
    dev = kpts.device
    limbs = _limbs(limbs, dev)
    hin, win = in_hw
    hout, wout = out_hw
    hnei, wnei = nei
    sy, sx = hin / hout, win / wout
    b, m, p, _ = kpts.shape
    n_limbs = int(limbs.shape[0])
    hw = hout * wout

    gx = kpts[..., 0] / sx  # [B, M, P] grid coords
    gy = kpts[..., 1] / sy
    cxi = torch.floor(gx).to(torch.int64)
    cyi = torch.floor(gy).to(torch.int64)
    inb = valid & (cxi >= 0) & (cxi < wout) & (cyi >= 0) & (cyi < hout)
    cell = cyi.clamp(0, hout - 1) * wout + cxi.clamp(0, wout - 1)  # [B, M, P]

    tx = gx - cxi.to(torch.float32)
    ty = gy - cyi.to(torch.float32)
    # Box sizes: parts max(bbox)/8, Instance anchor /4, normalized to input.
    size = torch.maximum(bbxs[..., 2], bbxs[..., 3])  # [B, M]
    is_inst = (torch.arange(p, device=dev) == instance_idx).view(1, 1, p)
    size_px = torch.where(is_inst, (size / 4.0)[..., None], (size / 8.0)[..., None])
    tw = size_px / win
    th = size_px / hin

    okf = inb.to(torch.float32)
    # One flat index per (image, part, cell): the vmap over the batch of the
    # JAX version becomes a batch offset.
    part = torch.arange(p, device=dev).view(1, 1, p)
    bidx = torch.arange(b, device=dev).view(b, 1, 1)
    idx = ((bidx * p + part) * hw + cell).reshape(-1)
    count = _scatter_add(b * p * hw, idx, okf.reshape(-1))
    vals = torch.stack([tx, ty, tw, th]) * okf  # [4, B, M, P]
    sums = _scatter_add(b * p * hw, idx, vals.reshape(4, -1))
    count = count.view(b, p, hout, wout)
    sums = sums.view(4, b, p, hout, wout)
    denom = torch.clamp_min(count, 1.0)
    c = torch.clamp(count, 0.0, 1.0)
    x_t, y_t, w_t, h_t = (sums[i] / denom for i in range(4))

    def to_nhwc(t):
        return t.permute(0, 2, 3, 1)

    # Edge tensor: source cell -> neighborhood offset of the target cell.
    s_idx, d_idx = limbs[:, 0], limbs[:, 1]
    scy, scx = cyi[:, :, s_idx], cxi[:, :, s_idx]   # [B, M, L]
    dcy, dcx = cyi[:, :, d_idx], cxi[:, :, d_idx]
    s_ok, d_ok = inb[:, :, s_idx], inb[:, :, d_idx]
    di = dcy - scy + hnei // 2
    dj = dcx - scx + wnei // 2
    nei_ok = (di >= 0) & (di < hnei) & (dj >= 0) & (dj < wnei)
    edge_ok = (s_ok & d_ok & nei_ok).to(torch.float32)
    mask_ok = (s_ok & d_ok).to(torch.float32)

    n_win = hnei * wnei
    scell = scy.clamp(0, hout - 1) * wout + scx.clamp(0, wout - 1)  # [B, M, L]
    noff = di.clamp(0, hnei - 1) * wnei + dj.clamp(0, wnei - 1)
    limb = torch.arange(n_limbs, device=dev).view(1, 1, n_limbs)
    bidx = torch.arange(b, device=dev).view(b, 1, 1)
    e_idx = ((bidx * n_limbs + limb) * n_win + noff) * hw + scell
    e = _scatter_add(b * n_limbs * n_win * hw, e_idx.reshape(-1), edge_ok.reshape(-1))
    em_idx = (bidx * n_limbs + limb) * hw + scell
    em = _scatter_add(b * n_limbs * hw, em_idx.reshape(-1), mask_ok.reshape(-1))
    e = torch.clamp(e.view(b, n_limbs, hnei, wnei, hout, wout), 0.0, 1.0)
    e_mask = torch.clamp(em.view(b, n_limbs, 1, 1, hout, wout), 0.0, 1.0).expand(e.shape)
    return {
        "c": to_nhwc(c), "x": to_nhwc(x_t), "y": to_nhwc(y_t),
        "w": to_nhwc(w_t), "h": to_nhwc(h_t), "e": e, "e_mask": e_mask,
    }


# ---------------------------------------------------------------------------
# PifPaf: composite intensity (CIF) + association (CAF) fields
# ---------------------------------------------------------------------------

def _person_scales(kpts: torch.Tensor, valid: torch.Tensor, stride: float,
                   sigmas, n_parts: int) -> torch.Tensor:
    """Per-keypoint scale targets in feature-grid units from the visible
    bounding-box area heuristic (reference: pifpaf/utils.py:49-78 get_scale)."""
    big = 1e6
    xmin = torch.where(valid, kpts[..., 0], big).amin(dim=-1)
    ymin = torch.where(valid, kpts[..., 1], big).amin(dim=-1)
    xmax = torch.where(valid, kpts[..., 0], -big).amax(dim=-1)
    ymax = torch.where(valid, kpts[..., 1], -big).amax(dim=-1)
    extent = torch.sqrt(torch.clamp_min((xmax - xmin) * (ymax - ymin), 1.0))  # [B, M] px
    if sigmas is None:
        sig = torch.full((n_parts,), 0.05, dtype=torch.float32, device=kpts.device)
    else:
        if not isinstance(sigmas, torch.Tensor):
            sigmas = np.asarray(sigmas, np.float32)
        sig = torch.as_tensor(sigmas, dtype=torch.float32, device=kpts.device)[:n_parts]
    scale_px = torch.clamp_min(extent[..., None] * sig * 4.0, 4.0)  # [B, M, P]
    return scale_px / stride


def pifpaf_targets(kpts: torch.Tensor, valid: torch.Tensor, limbs,
                   in_hw: tuple[int, int], out_hw: tuple[int, int],
                   mask: torch.Tensor | None = None, side: int = 1, n_samples: int = 9,
                   bmin: float = 0.1, sigmas=None) -> dict:
    """CIF/CAF composite-field targets with NaN don't-care semantics.

    Keys (all [B, hout, wout, ...]): pif_conf/pif_bmin/pif_scale [.., P],
    pif_vec [.., P, 2], paf_conf/paf_*_bmin/paf_*_scale [.., L],
    paf_src_vec/paf_dst_vec [.., L, 2].

    Vector targets are offsets from the grid cell to the keypoint in
    feature-grid units; scale targets are raw grid-unit sizes (the model
    predicts them through softplus). Cells not written by any person are NaN
    for regression channels (the losses mask NaN, models/pifpaf.py) and 0 for
    confidence; `mask` == 0 regions become NaN everywhere
    (reference: pifpaf/utils.py:117-240 put_pifmap/put_pafmap — NaN padding,
    nearest-cell patch writes, line-sampled CAF fields). `sigmas`: the parts'
    keypoint sigmas (numpy, or a float32 tensor on the keypoints' device, used
    as it is, as `limbs` is); COCO's by default."""
    if sigmas is None:
        from ..utils.topology import COCO_SIGMAS

        sigmas = COCO_SIGMAS
    dev = kpts.device
    limbs = _limbs(limbs, dev)
    hin, win = in_hw
    hout, wout = out_hw
    stride = hin / hout
    b, m, p, _ = kpts.shape
    n_limbs = int(limbs.shape[0])
    hw = hout * wout
    nan = float("nan")
    bidx = torch.arange(b, device=dev)

    g = kpts / stride  # [B, M, P, 2] feature-grid coords
    scales = _person_scales(kpts, valid, stride, sigmas, p)  # [B, M, P]

    # --- CIF: write a (2*side+1)^2 patch around each keypoint -------------
    r = torch.arange(-side, side + 1, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1).reshape(-1, 2)  # (dy, dx)
    base = torch.floor(g).to(torch.int64)  # [B, M, P, 2] (x, y)
    cx = base[..., 0][..., None] + offs[:, 1]  # [B, M, P, O]
    cy = base[..., 1][..., None] + offs[:, 0]
    ok = valid[..., None] & (cx >= 0) & (cx < wout) & (cy >= 0) & (cy < hout)
    cell = cy.clamp(0, hout - 1) * wout + cx.clamp(0, wout - 1)
    vx = g[..., 0][..., None] - cx.to(torch.float32)  # offset cell->kpt
    vy = g[..., 1][..., None] - cy.to(torch.float32)
    sc = scales[..., None].expand(ok.shape)

    okf = ok.to(torch.float32)
    part = torch.arange(p, device=dev).view(1, 1, p, 1)
    idx = ((bidx.view(b, 1, 1, 1) * p + part) * hw + cell).reshape(-1)
    count = _scatter_add(b * p * hw, idx, okf.reshape(-1))
    sums = _scatter_add(b * p * hw, idx, (torch.stack([vx, vy, sc]) * okf).reshape(3, -1))
    count = count.view(b, p, hout, wout).permute(0, 2, 3, 1)
    sums = sums.view(3, b, p, hout, wout).permute(1, 3, 4, 2, 0)  # [B, h, w, P, 3]
    hit = count > 0
    denom = torch.clamp_min(count, 1.0)
    pif_conf = torch.clamp(count, 0.0, 1.0)
    pif_vec = torch.where(hit[..., None], sums[..., 0:2] / denom[..., None], nan)
    pif_scale = torch.where(hit, sums[..., 2] / denom, nan)
    pif_bmin = torch.where(hit, bmin, nan)

    # --- CAF: sample cells along each bone ---------------------------------
    s_idx, d_idx = limbs[:, 0], limbs[:, 1]
    gs, gd = g[:, :, s_idx], g[:, :, d_idx]  # [B, M, L, 2]
    lok = valid[:, :, s_idx] & valid[:, :, d_idx]  # [B, M, L]
    ss, ds = scales[:, :, s_idx], scales[:, :, d_idx]

    t = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=dev)
    pos = gs[..., None, :] + t.view(1, 1, 1, -1, 1) * (gd - gs)[..., None, :]  # [B,M,L,S,2]
    pcx = torch.round(pos[..., 0]).to(torch.int64)
    pcy = torch.round(pos[..., 1]).to(torch.int64)
    pok = lok[..., None] & (pcx >= 0) & (pcx < wout) & (pcy >= 0) & (pcy < hout)
    pcell = pcy.clamp(0, hout - 1) * wout + pcx.clamp(0, wout - 1)
    pcxf, pcyf = pcx.to(torch.float32), pcy.to(torch.float32)
    paf_vals = torch.stack([
        gs[..., 0][..., None] - pcxf, gs[..., 1][..., None] - pcyf,
        gd[..., 0][..., None] - pcxf, gd[..., 1][..., None] - pcyf,
        ss[..., None].expand(pok.shape), ds[..., None].expand(pok.shape)])

    pokf = pok.to(torch.float32)
    limb = torch.arange(n_limbs, device=dev).view(1, 1, n_limbs, 1)
    pidx = ((bidx.view(b, 1, 1, 1) * n_limbs + limb) * hw + pcell).reshape(-1)
    pcount = _scatter_add(b * n_limbs * hw, pidx, pokf.reshape(-1))
    psums = _scatter_add(b * n_limbs * hw, pidx, (paf_vals * pokf).reshape(6, -1))
    pcount = pcount.view(b, n_limbs, hout, wout).permute(0, 2, 3, 1)
    psums = psums.view(6, b, n_limbs, hout, wout).permute(1, 3, 4, 2, 0)
    phit = pcount > 0
    pden = torch.clamp_min(pcount, 1.0)
    paf_conf = torch.clamp(pcount, 0.0, 1.0)

    def reg(i):
        return torch.where(phit, psums[..., i] / pden, nan)

    out = {
        "pif_conf": pif_conf, "pif_vec": pif_vec, "pif_bmin": pif_bmin,
        "pif_scale": pif_scale,
        "paf_conf": paf_conf, "paf_src_vec": torch.stack([reg(0), reg(1)], dim=-1),
        "paf_dst_vec": torch.stack([reg(2), reg(3)], dim=-1),
        "paf_src_bmin": torch.where(phit, bmin, nan),
        "paf_dst_bmin": torch.where(phit, bmin, nan),
        "paf_src_scale": reg(4), "paf_dst_scale": reg(5),
    }
    if mask is not None:
        care = mask.reshape(b, hout, wout) > 0.5
        for k, v in out.items():
            c = care[..., None, None] if v.ndim == 5 else care[..., None]
            out[k] = torch.where(c.expand(v.shape), v, nan)
    return out
