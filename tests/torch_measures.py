"""Measures shared by the port's tests and chip_smoke.py: bf16 distances in
units in the last place, the slack of float32 sums taken in another order,
the work that PifPaf growth, the PAF limb scoring and an int8 depthwise
conv need on given inputs (the evaluations, operations and bytes behind
those kernels' bounds), and a network's conv operations.

It imports torch and the port only, and has no side effects at import, so
chip_smoke.py can use it on the card as it is.
"""
from __future__ import annotations

import torch

from hyperpose_torch.ops.kernels.grow import find_connection, fused_grow_plain


def sum_order(k: int) -> float:
    """Two float32 sums of the same k products, taken in any two orders,
    differ by at most this times the sum of the products' magnitudes
    (2 * k * 2^-24)."""
    return 2 * k * 2.0 ** -24


SUM_ORDER = sum_order(384)   # the 384-deep sums of the fused stem's kernel


def _ulp_distance(a, b, slack=None):
    """Elementwise distance between two bf16 tensors in units in the last
    place: how many bf16 values apart they lie (+0 and -0 are 0 apart).
    Elements whose difference is within `slack` (a number or a tensor)
    count as 0."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    d = (ordered(a) - ordered(b)).abs()
    if slack is not None:
        d = torch.where((a.float() - b.float()).abs() <= slack, 0, d)
    return d


def bf16_ulps(a, b, slack=None) -> int:
    """The largest `_ulp_distance` of two bf16 tensors. Near zero, float32
    sums in another order move a bf16 result by more than one of its tiny
    ulps: pass SUM_ORDER * (each output's sum of product magnitudes) as
    `slack` to count only what the order of the sums does not explain."""
    return int(_ulp_distance(a, b, slack).max())


def bf16_agreement(got, want, scale) -> dict:
    """A bf16 kernel's result against its plain version, both float32 sums
    of 384 products rounded once: the largest distance in ulps, how many
    outputs lie more than 1 ulp apart, and the largest distance beyond what
    the order of the sums explains (`scale`: each output's sum of product
    magnitudes)."""
    d = _ulp_distance(got, want)
    return {"max_ulps": int(d.max()), "outputs_beyond_1_ulp": int((d > 1).sum()),
            "max_ulps_beyond_sum_order": bf16_ulps(got, want, SUM_ORDER * scale)}


def _winners(mx, my, ms, qx, qy, qs):
    """find_connection's best and second-best candidate indices (ties to the
    lowest index), and whether the best one matched (weight > 0)."""
    sf = 2.0 * qs
    sg = torch.clamp(0.25 * qs * qs, min=1e-6)
    dx = mx - qx[..., None]
    dy = my - qy[..., None]
    near = (dx.abs() <= sf[..., None]) & (dy.abs() <= sf[..., None])
    w = torch.where(near, torch.exp(-0.5 * (dx * dx + dy * dy) / sg[..., None]) * ms, 0.0)
    k = w.shape[-1]
    iota = torch.arange(k, device=w.device)

    def first_argmax(v):
        s = v.amax(dim=-1)
        return s, torch.where(v >= s[..., None], iota, k).amin(dim=-1)

    s1, i1 = first_argmax(w)
    _, i2 = first_argmax(w.scatter(-1, i1[..., None], 0.0))
    return i1, i2, s1 > 0.0


def grow_work(args) -> dict:
    """The work that `fused_grow_plain(*args)` needs on these inputs, from
    one pass over its rounds.

    evaluations: in each round, K for every (seed slot, edge) whose source
    part has grown and whose destination has not (no other edge can commit),
    and K more for its reverse check where the forward merge score is > 0.
    bytes: each value read once, each output written once: the match-side
    rows (x, y, score) of every (image, edge) evaluated at least once in
    either direction, the output-side (x, y, scale) values at the best and
    second-best candidates of every evaluation that matched, the seeds, and
    the four [B, MH, P] outputs."""
    seed_part, seed_vals, tables, rev_tables, e_src, e_dst, n_parts, steps, rev = args
    dev = seed_part.device
    src = torch.tensor(e_src, device=dev)
    dst = torch.tensor(e_dst, device=dev)
    b, mh = seed_part.shape
    e, k = tables[0].shape[1:]
    piota = torch.arange(n_parts, device=dev)
    seed_oh = (piota == seed_part[..., None]).to(torch.float32)
    sv = seed_vals.to(torch.float32)
    ann = [seed_oh * sv[..., i:i + 1] for i in (3, 0, 1, 2)]   # score, x, y, scale
    fwd = [t[:, None] for t in tables]
    bwd = [t[:, None] for t in rev_tables]
    dst_oh = dst[:, None] == piota[None, :]
    eiota = torch.arange(e, device=dev)[:, None]
    bidx = torch.arange(b, device=dev)[:, None, None].expand(b, mh, e)
    eidx = torch.arange(e, device=dev).expand(b, mh, e)
    rows = torch.zeros((2, b, e), dtype=torch.bool, device=dev)
    picked = torch.zeros((2, b, e, k), dtype=torch.bool, device=dev)
    evaluations = 0

    def record(side, mask, i1, i2, matched):
        rows[side] |= mask.any(dim=1)
        hit = mask & matched
        for i in (i1, i2):
            picked[side][bidx[hit], eidx[hit], i[hit]] = True

    for _ in range(steps):
        score, x, y, sc = ann
        src_score, dst_score = score[..., src], score[..., dst]
        qx, qy, qs = x[..., src], y[..., src], sc[..., src]
        active = (src_score > 0.0) & (dst_score <= 0.0)
        if not bool(active.any()):
            break   # nothing can commit now or in any later round
        evaluations += k * int(active.sum())
        fc, fx, fy, fs = find_connection(*fwd, qx, qy, qs)
        record(0, active, *_winners(*fwd[:3], qx, qy, qs))
        merge = torch.sqrt(torch.clamp(fc * src_score, min=0.0))
        if rev:
            checked = active & (merge > 0.0)
            evaluations += k * int(checked.sum())
            record(1, checked, *_winners(*bwd[:3], fx, fy, fs))
            rc, rx, ry, _ = find_connection(*bwd, fx, fy, fs)
            merge = torch.where((rc > 0.0) & ((qx - rx).abs() + (qy - ry).abs() <= qs),
                                merge, 0.0)
        merge = torch.where(active & (fc > 0.0), merge, 0.0)
        contrib = torch.where(dst_oh, merge[..., None], 0.0)
        best = contrib.amax(dim=2)
        ibest = torch.where(contrib >= best[:, :, None, :], eiota, e).amin(dim=2)
        do = best > 0.0
        ann = [torch.where(do, best, score)] + [
            torch.where(do, torch.gather(v, -1, ibest), old)
            for v, old in ((fx, x), (fy, y), (fs, sc))]
    want = fused_grow_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(ann, want)), \
        "grow_work's rounds differ from fused_grow_plain's"
    nbytes = 4 * (3 * k * int(rows.sum()) + 3 * int(picked.sum())
                  + 5 * b * mh + 4 * b * mh * n_parts)
    return {"evaluations": evaluations, "bytes": nbytes}


def limb_scores_work(paf_shape, peak_xy, peak_valid, limbs, n_samples: int = 10) -> dict:
    """The bytes and float operations that `limb_scores` needs on these
    peaks: only pairs of two valid peaks more than 1e-6 apart are sampled
    (any other pair scores -1e30 whatever the field holds), and each
    distinct sampled pixel of a limb's two channels is read once (8 bytes);
    the peaks are read once and cand_score [B, L, K, K] written once.
    Operations per sampled pair: 9 for its length and direction, 18 per
    sample (its position, clamps, dot product, compare and sum) and 9 for the
    score; 1 per other pair (its validity). paf_shape is [B, H, W, 2L];
    peak_xy [B, P, K, 2] and peak_valid [B, P, K] may lie on any device."""
    b, h, w, _ = paf_shape
    xy = peak_xy.detach().cpu().float()
    valid = peak_valid.detach().cpu()
    idx = torch.as_tensor([[int(a), int(c)] for a, c in limbs], dtype=torch.int64)
    k = xy.shape[2]
    pa, pb = xy[:, idx[:, 0]], xy[:, idx[:, 1]]               # [B, L, K, 2]
    diff = pb[:, :, None] - pa[:, :, :, None]                 # [B, L, K, K, 2]
    norm = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    need = (valid[:, idx[:, 0]][:, :, :, None] & valid[:, idx[:, 1]][:, :, None, :]
            & (norm > 1e-6))                                  # [B, L, K, K]
    fs = torch.tensor(float(n_samples))
    ts = (torch.arange(n_samples, dtype=torch.float32) / fs).reshape(n_samples, 1)
    loc = torch.floor(pa[:, :, :, None, None] + ts * diff[:, :, :, :, None] + 0.5)
    x = loc[..., 0].to(torch.int64).clamp(0, w - 1)
    y = loc[..., 1].to(torch.int64).clamp(0, h - 1)          # [B, L, K, K, S]
    bl = (torch.arange(b)[:, None] * len(idx) + torch.arange(len(idx))[None])
    key = (bl[:, :, None, None, None] * h + y) * w + x
    pixels = int(torch.unique(key[need]).numel())
    pairs = int(need.sum())
    total_pairs = b * len(idx) * k * k
    return {
        "sampled_pairs": pairs, "pairs": total_pairs, "field_pixels": pixels,
        "bytes": 8 * pixels + peak_xy.numel() * 4 + peak_valid.numel() + 4 * total_pairs,
        "operations": pairs * (18 + 18 * n_samples) + (total_pairs - pairs),
    }


def _taps_inside(n: int, out: int, k: int, stride: int, pad: int, dil: int) -> int:
    """Along one axis: the filter taps that fall inside the image, summed
    over the `out` output positions (the others read the zero border)."""
    return sum(sum(0 <= o * stride - pad + t * dil < n for t in range(k)) for o in range(out))


def int8_dwconv_work(x_shape, kernel_size, stride, padding, dilation, channels: int,
                     out_itemsize: int, in_itemsize: int) -> dict:
    """The bytes and integer operations that one int8 depthwise conv
    (`int8_dwconv`) needs: the C channels of its input [B, H, W, >= C] read
    once at `in_itemsize` bytes a value (1 for the quantized buffer of the
    two-kernel path, the activation's itemsize for the fused kernel, which
    reads the float input itself; channels beyond C are layout, not work),
    the C channels' taps [kh, kw], dq and bias read once, the output
    [B*Ho*Wo, C] written once at `out_itemsize` bytes a value; 2 operations
    (a multiply and an add) for each of the C channels' taps that fall
    inside the image, the border's taps needing none. The rate to set them
    against is the card's integer rate outside the tensor cores."""
    b, h, w, _ = x_shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    taps = _taps_inside(h, ho, kh, sh, ph, dh) * _taps_inside(w, wo, kw, sw, pw, dw)
    nbytes = (b * h * w * in_itemsize + kh * kw + 8) * channels \
        + b * ho * wo * channels * out_itemsize
    return {"bytes": nbytes, "operations": 2 * b * taps * channels}


def conv_operations(model: torch.nn.Module, images_shape) -> int:
    """2 x the multiply-adds of every conv in one forward of a copy of
    `model` on NHWC images of `images_shape`, counted on the meta device
    (no data, no compute): for each `nn.Conv2d`, 2 * output elements *
    (input channels / groups) * kh * kw; for each `SeparableConv` (two convs
    on bare parameters, no `nn.Conv2d`), its depthwise conv and its 1x1
    conv alike."""
    import copy

    from hyperpose_torch.models.openpose import SeparableConv

    meta = copy.deepcopy(model).to("meta")
    total = 0

    def count(conv, _args, out):
        nonlocal total
        kh, kw = conv.kernel_size
        total += 2 * out.numel() * (conv.in_channels // conv.groups) * kh * kw

    def count_separable(sep, args, out):
        nonlocal total
        b, cin, h, w = args[0].shape
        total += 2 * b * h * w * cin * sep.dw_kernel[0, 0].numel() + 2 * out.numel() * cin

    hooks = [m.register_forward_hook(count) for m in meta.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(count_separable) for m in meta.modules()
              if isinstance(m, SeparableConv)]
    try:
        with torch.no_grad():
            meta(torch.zeros(images_shape, device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return total
