"""The facts the CUDA peak top-K relies on, checked on the plain version.

`csrc/peak_topk.cu` does not run the K argmax rounds of `select_peaks`: it
writes their result out as a rule. These tests hold the rounds to that rule
on the CPU, in both border modes:

  * where every pixel of a ranked plane holds either _NEG or a value above
    it (n pixels), the rounds are the first K of those n stably sorted by
    (value descending, pixel index ascending), then K - n fillers of value
    _NEG: pixel 0 each time with zero borders (taken == _NEG), the _NEG
    pixels in index order with reflect borders (taken == 2 * _NEG);
  * after the plateau tie-break no two survivors touch (8-neighbourhood), so
    a plane holds at most ceil(H/2) * ceil(W/2) of them, the length of the
    kernel's survivor list;
  * so the plain peak top-K on maps follows the rule for any threshold above
    _NEG.

Exact comparisons: the rule picks pixels and values, it computes nothing.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_parity  # noqa: F401  (one thread per test)
from torch_parity import tie_maps
from hyperpose_torch.ops.kernels.peak_topk import (
    _NEG, _smooth_nms, _taps, peak_topk, peak_topk_plain, select_peaks,
)
from hyperpose_torch.ops.paf_decode import PafDecoderConfig

TAKEN = {"zero": _NEG, "reflect": 2.0 * _NEG}


def rule(ranked: np.ndarray, k: int, border: str) -> tuple[np.ndarray, np.ndarray]:
    """(pixel indices [..., K], values [..., K]) of the stated rule for
    ranked planes [..., H*W] whose pixels hold _NEG or more."""
    flat = ranked.reshape(-1, ranked.shape[-1])
    idx = np.zeros((flat.shape[0], k), np.int64)
    val = np.full((flat.shape[0], k), _NEG, np.float32)
    for row, plane in enumerate(flat):
        surv = np.nonzero(plane > _NEG)[0]
        order = sorted(surv, key=lambda i: (-plane[i], i))[:k]
        n = len(order)
        idx[row, :n] = order
        val[row, :n] = plane[order]
        if border == "reflect":
            idx[row, n:] = np.nonzero(plane == np.float32(_NEG))[0][:k - n]
    return idx.reshape(*ranked.shape[:-1], k), val.reshape(*ranked.shape[:-1], k)


def _ranked(h, w, n, seed, ties=False, planes=3):
    """[planes, H*W] ranked planes with n pixels above _NEG (distinct
    random values, or two values only), _NEG elsewhere."""
    rng = np.random.default_rng(seed)
    ranked = np.full((planes, h * w), _NEG, np.float32)
    for p in range(planes):
        pix = rng.choice(h * w, n, replace=False)
        vals = rng.choice([0.25, 0.5], n) if ties else rng.uniform(0.06, 1.0, n)
        ranked[p, pix] = vals.astype(np.float32)
    return ranked


CASES = {  # name: (h, w, survivors, k, ties)
    "fewer_survivors_than_k": (7, 9, 5, 16, False),
    "as_many_as_k": (7, 9, 16, 16, False),
    "more_than_k": (7, 9, 40, 16, False),
    "no_survivor": (7, 9, 0, 16, False),
    "ties": (7, 9, 30, 24, True),
    "k_1": (7, 9, 12, 1, False),
    "k_hw": (5, 6, 8, 30, False),
    "k_hw_all_ties": (5, 6, 8, 30, True),
}


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_select_peaks_is_a_stable_sort(case, border):
    """The K argmax rounds equal the stable sort and the filler rule; the
    gathered raw plane holds each pixel's own index, so it shows which
    pixel each slot took."""
    h, w, n, k, ties = CASES[case]
    ranked = _ranked(h, w, n, seed=len(case), ties=ties)
    pix = torch.arange(h * w, dtype=torch.float32).expand(ranked.shape[0], h * w)
    smoothed = torch.from_numpy(
        np.random.default_rng(1).uniform(0, 1, ranked.shape).astype(np.float32))
    xy, raw, sval = select_peaks(torch.from_numpy(ranked)[None], smoothed[None],
                                 pix[None], h, w, k, TAKEN[border], border == "zero")
    want_idx, want_val = rule(ranked, k, border)
    assert np.array_equal(raw[0].numpy().astype(np.int64), want_idx)
    assert np.array_equal(sval[0].numpy(), want_val)
    assert bool((xy[0, ..., 0] - torch.from_numpy(want_idx % w).float()).abs().max() <= 0.5)


def _maps(kind: str, h: int, w: int) -> np.ndarray:
    """[2, H, W, 4] score maps: uniform noise, the densest lattice of
    peaks (distinct and equal values), or plateaus of equal values."""
    rng = np.random.default_rng(h * w)
    if kind == "random":
        return rng.uniform(0, 1, (2, h, w, 4)).astype(np.float32)
    m = np.zeros((2, h, w, 4), np.float32)
    if kind == "lattice":
        m[:, ::2, ::2] = rng.uniform(0.9, 1.0, m[:, ::2, ::2].shape)
    elif kind == "lattice_ties":
        m[:, ::2, ::2] = 0.75
    else:  # plateaus
        m[:, h // 4:h // 4 + 3, w // 4:w // 4 + 3] = 0.6
        m[:, h // 2:h // 2 + 3, w // 2:w // 2 + 3] = 0.6
    return m


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("kind", ["random", "lattice", "lattice_ties", "plateaus"])
@pytest.mark.parametrize("hw", [(46, 54), (7, 9), (3, 11), (10, 3)])
def test_survivors_never_touch(kind, zero, hw):
    """After the tie-break each survivor's 3x3 window holds no other
    survivor, so a plane has at most ceil(H/2) * ceil(W/2) of them; the
    lattice reaches that bound."""
    h, w = hw
    x = torch.from_numpy(_maps(kind, h, w)).permute(0, 3, 1, 2)
    _, peaks = _smooth_nms(x, _taps(5, 0.75), 0.05, zero)
    p = peaks.float()
    window = F.conv2d(p.reshape(-1, 1, h, w), torch.ones(1, 1, 3, 3), padding=1)
    assert bool((window.reshape(p.shape)[peaks] == 1).all())
    per_plane = peaks.flatten(2).sum(-1)
    cap = ((h + 1) // 2) * ((w + 1) // 2)
    assert int(per_plane.max()) <= cap
    if kind == "lattice" and min(h, w) > 2:
        assert int(per_plane.min()) == cap


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("kind", ["random", "lattice", "lattice_ties", "plateaus", "ties"])
def test_plain_peaks_follow_the_rule(kind, k, border):
    """The plain peak top-K on maps (threshold 0.05 > _NEG): its slots are
    the rule's, pixel for pixel and value for value."""
    conf = tie_maps()[..., :4] if kind == "ties" else _maps(kind, 46, 54)
    b, h, w, p = conf.shape
    x = torch.from_numpy(conf)
    xy, _, sval = peak_topk_plain(x, k, 5, 0.75, 0.05, border)
    sm, peaks = _smooth_nms(x.permute(0, 3, 1, 2), _taps(5, 0.75), 0.05, border == "zero")
    ranked = torch.where(peaks, sm, _NEG).reshape(b, p, h * w).numpy()
    want_idx, want_val = rule(ranked, k, border)
    assert np.array_equal(sval.numpy(), want_val)
    # xy is the pixel plus an offset within [-0.5, 0.5]
    assert bool((xy[..., 0] - torch.from_numpy(want_idx % w).float()).abs().max() <= 0.5)
    assert bool((xy[..., 1] - torch.from_numpy(want_idx // w).float()).abs().max() <= 0.5)


def test_threshold_at_or_below_neg_is_refused_on_every_device():
    """The card's selection needs thresh > _NEG, so the wrapper refuses less
    before it looks at the device (the card's refusal:
    tests/test_torch_cuda.py), and so does the decoder's config; the plain
    rounds still take any threshold."""
    conf = torch.from_numpy(_maps("random", 6, 7))
    for thresh in (_NEG, 2.0 * _NEG):
        with pytest.raises(ValueError, match="thresh"):
            peak_topk(conf, 4, thresh=thresh)
        with pytest.raises(ValueError, match="conf_thresh"):
            PafDecoderConfig(conf_thresh=thresh)
        xy, raw, sval = peak_topk_plain(conf, 4, thresh=thresh)
        assert xy.shape == (conf.shape[0], conf.shape[-1], 4, 2)
    assert peak_topk(conf, 4, thresh=0.05)[0].shape == xy.shape
