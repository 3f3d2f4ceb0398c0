"""The port's decoder kernels: their plain PyTorch versions against the JAX
package (Pallas kernels run with interpret=True, as its own tests run them).
The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py, on a card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import tie_maps
from hyperpose_tpu.ops import paf_decode as JD
from hyperpose_tpu.ops.pallas.line_gather import fused_line_gather
from hyperpose_tpu.ops.pallas.peak_kernel import (
    fused_peak_candidates, fused_peak_topk,
)
from hyperpose_torch.ops.kernels import build
from hyperpose_torch.ops.kernels.line_gather import (
    limb_scores, limb_scores_plain, line_gather_plain,
)
from hyperpose_torch.ops.kernels.peak_topk import (
    peak_candidates, peak_candidates_plain, peak_topk, peak_topk_plain,
)
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from chip_smoke import limb_scores_inputs, nan_peak_maps
from test_paf_decode import TWO_PEOPLE, make_synthetic_maps
from test_paf_golden import random_scene

_jax_find_peaks = jax.jit(JD.find_peaks, static_argnames=("cfg",))
K, KSIZE, SIGMA, THRESH = 16, 5, 0.75, 0.05


@functools.lru_cache(maxsize=None)
def peak_inputs(name: str) -> np.ndarray:
    if name == "ties":
        return tie_maps()
    if name == "random":
        return np.random.default_rng(11).uniform(0, 1, (2, 46, 54, 18)).astype(np.float32)
    scenes = [TWO_PEOPLE, random_scene(np.random.default_rng(1), 2),
              random_scene(np.random.default_rng(2), 3)]
    return np.stack([make_synthetic_maps(s)[0][..., :18] for s in scenes])


# -- line gather ---------------------------------------------------------------

def _gather_inputs(seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    b, l, h, w, m = 2, 3, 12, 16, 128
    paf = rng.standard_normal((b, l, 2, h, w)).astype(np.float32)
    lo = -2 if out_of_range else 0
    ly = rng.integers(lo, h + 2 if out_of_range else h, (b, l, m)).astype(np.int32)
    lx = rng.integers(lo, w + 2 if out_of_range else w, (b, l, m)).astype(np.int32)
    return paf, ly, lx


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_line_gather_plain_matches_pallas(bf16, out_of_range):
    """Exact (atol 0): the selection is exact and both round to bf16 by
    round-to-nearest-even; indices off the plane read 0 in both."""
    paf, ly, lx = _gather_inputs(3, out_of_range)
    want = np.asarray(fused_line_gather(
        jnp.asarray(paf), jnp.asarray(ly), jnp.asarray(lx), bf16=bf16,
        interpret=True))
    got = line_gather_plain(torch.from_numpy(paf), torch.from_numpy(ly),
                            torch.from_numpy(lx), bf16)
    np.testing.assert_array_equal(got.numpy(), want)


def limb_inputs(seed):
    """chip_smoke.limb_scores_inputs at a small size: 2 images, a 12 x 14
    field, K = 4."""
    return limb_scores_inputs(np.random.default_rng(seed), 2, 12, 14, 4)


def _jax_limb_scores(paf, xy, valid, limbs, **cfg):
    return np.asarray(JD._limb_pair_scores(
        jnp.asarray(paf), jnp.asarray(xy), jnp.asarray(valid), limbs,
        JD.PafDecoderConfig(max_peaks=xy.shape[2], **cfg)))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_limb_scores_plain_matches_jax(backend, bf16, seed):
    """limb_scores_plain against JAX `_limb_pair_scores` with the Pallas
    gather (interpret mode) and with the XLA one-hot gather: the same pairs
    pass (masks equal) and their scores agree within 1e-5 (float32 sums
    in another order)."""
    paf, xy, valid, limbs = limb_inputs(seed)
    want = _jax_limb_scores(paf, xy, valid, limbs, gather_backend=backend,
                            gather_bf16=bf16)
    got = limb_scores_plain(torch.from_numpy(paf), torch.from_numpy(xy),
                            torch.from_numpy(valid), limbs, bf16=bf16).numpy()
    ok = want > -5e29
    assert ok.any() and (~ok).any()
    np.testing.assert_array_equal(got > -5e29, ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)
    assert (got[~ok] == -1e30).all()


def test_limb_scores_fail_zero_length_and_invalid_pairs():
    """A pair fails, whatever its samples hold, when a peak is invalid or
    the two peaks coincide."""
    paf, xy, valid, limbs = limb_inputs(2)
    got = limb_scores_plain(torch.from_numpy(paf), torch.from_numpy(xy),
                            torch.from_numpy(valid), limbs).numpy()
    a, b = limbs[:, 0], limbs[:, 1]
    invalid = ~(valid[:, a, :, None] & valid[:, b, None, :])
    same = (xy[:, a, :, None] == xy[:, b, None, :]).all(-1)
    assert invalid.any() and same.any()
    assert (got[invalid | same] == -1e30).all()


def test_limb_scores_takes_strided_fields():
    """The decoder may hand over the field as a view (the model permutes
    its NCHW output); the result does not depend on the strides."""
    paf, xy, valid, limbs = limb_inputs(4)
    nchw = torch.from_numpy(paf).permute(0, 3, 1, 2).contiguous()
    view = nchw.permute(0, 2, 3, 1)
    args = (torch.from_numpy(xy), torch.from_numpy(valid), limbs)
    assert view.stride()[-1] != 1
    assert torch.equal(limb_scores(view, *args), limb_scores_plain(torch.from_numpy(paf), *args))


# -- peak top-K ----------------------------------------------------------------

def _assert_peaks_equal(got, want, on_valid_only, xy_atol=1e-5):
    gxy, graw, gsval = (np.asarray(t) for t in got)
    wxy, wraw, wsval = (np.asarray(t) for t in want)
    valid = wsval > -5e29
    np.testing.assert_array_equal(gsval > -5e29, valid)
    assert valid.any()
    sel = valid if on_valid_only else np.ones_like(valid)
    np.testing.assert_allclose(gxy[sel], wxy[sel], rtol=0, atol=xy_atol)
    # Exact up to subnormals, which XLA on the CPU flushes to zero.
    np.testing.assert_allclose(graw[sel], wraw[sel], rtol=0,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_topk_zero_matches_pallas(maps):
    """border="zero" reproduces fused_peak_topk slot for slot, invalid slots
    included: valid exact, raw exact, xy atol 1e-5 (sub-pixel offsets of
    smoothed values summed in the same order, up to fused multiply-adds)."""
    conf = peak_inputs(maps)
    want = fused_peak_topk(jnp.asarray(conf), K, KSIZE, SIGMA, THRESH,
                           interpret=True)
    got = peak_topk_plain(torch.from_numpy(conf), K, KSIZE, SIGMA, THRESH,
                          border="zero")
    _assert_peaks_equal(got, want, on_valid_only=False)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_topk_reflect_matches_find_peaks(maps):
    """border="reflect" reproduces the decoder's XLA front end: valid masks
    exact, xy atol 1e-5 and raw scores exact on valid slots."""
    conf = peak_inputs(maps)
    wxy, wscore, wvalid = _jax_find_peaks(jnp.asarray(conf), JD.PafDecoderConfig())
    xy, raw, sval = peak_topk_plain(torch.from_numpy(conf), K, KSIZE, SIGMA,
                                    THRESH, border="reflect")
    valid = (sval > -5e29).numpy()
    np.testing.assert_array_equal(valid, np.asarray(wvalid))
    np.testing.assert_allclose(xy.numpy()[valid], np.asarray(wxy)[valid],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(raw.numpy()[valid], np.asarray(wscore)[valid])


def test_ties_resolve_to_the_lowest_index():
    """Equal peaks come out in pixel-index order, and a plateau yields one
    peak (its highest-index pixel), in both border modes."""
    conf = torch.from_numpy(tie_maps())
    for border in ("reflect", "zero"):
        xy, _, sval = peak_topk_plain(conf, K, KSIZE, SIGMA, THRESH, border)
        valid = sval > -5e29
        # The plateau's 2x2 top survives at (13, 13); its equal left and
        # upper neighbours pull the sub-pixel fit half a pixel.
        assert int(valid[0, 0].sum()) == 1
        assert xy[0, 0, 0].tolist() == [12.5, 12.5]
        assert int(valid[0, 1].sum()) == 2 and sval[0, 1, 0] == sval[0, 1, 1]
        assert xy[0, 1, :2].tolist() == [[34.0, 9.0], [12.0, 29.0]]


def test_peak_topk_rejects_bad_arguments():
    conf = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError):
        peak_topk(conf, border="wrap")
    with pytest.raises(ValueError):
        peak_topk(conf, ksize=4)


# -- peak candidates (the use_pallas_peaks front end) ---------------------------

@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_candidates_plain_matches_pallas(maps):
    """Equal peak masks; smoothed and ranked values within 1e-6 (the taps are
    summed in the same order, up to fused multiply-adds); `neg` elsewhere."""
    conf = peak_inputs(maps)
    w_ranked, w_sm = (np.asarray(t) for t in fused_peak_candidates(
        jnp.asarray(conf), KSIZE, SIGMA, THRESH, -1e30, interpret=True))
    ranked, sm = peak_candidates_plain(torch.from_numpy(conf), KSIZE, SIGMA,
                                       THRESH, -1e30)
    assert ranked.shape == sm.shape == (conf.shape[0], 18, 46, 54)
    mask = w_ranked > -5e29
    assert mask.any()
    np.testing.assert_array_equal(ranked.numpy() > -5e29, mask)
    np.testing.assert_allclose(sm.numpy(), w_sm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ranked.numpy()[mask], w_ranked[mask], rtol=0,
                               atol=1e-6)
    assert (ranked.numpy()[~mask] == -1e30).all()


@pytest.mark.parametrize("maps", ["painted", "random"])
def test_peak_candidates_plain_matches_pallas_on_nan_maps(maps):
    """Maps with NaN pixels (`chip_smoke.nan_peak_maps`: a lone NaN three
    columns beside a peak, a NaN plane): the plain version and the Pallas
    kernel give equal peak masks and NaN in the same places; JAX's NMS
    carries NaN through its 3x3 maximum, so the peak beside the NaN is
    dropped, and the NaN plane has no peak."""
    clean = peak_inputs(maps)
    conf = nan_peak_maps(clean)
    w_ranked, w_sm = (np.asarray(t) for t in fused_peak_candidates(
        jnp.asarray(conf), KSIZE, SIGMA, THRESH, -1e30, interpret=True))
    ranked, sm = (t.numpy() for t in peak_candidates_plain(
        torch.from_numpy(conf), KSIZE, SIGMA, THRESH, -1e30))
    mask = w_ranked > -5e29
    np.testing.assert_array_equal(ranked > -5e29, mask)
    np.testing.assert_array_equal(np.isnan(sm), np.isnan(w_sm))
    np.testing.assert_array_equal(np.isnan(ranked), np.isnan(w_ranked))
    assert np.isnan(sm[0, 1]).all() and not mask[0, 1].any()
    np.testing.assert_allclose(sm, w_sm, rtol=0, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(ranked[mask], w_ranked[mask], rtol=0, atol=1e-6)
    # Every image lost the peak beside its NaN, and nothing else changed
    # outside the NaN's reach.
    clean_mask = peak_candidates_plain(torch.from_numpy(clean))[0].numpy() > -5e29
    lost = clean_mask & ~mask
    assert lost.reshape(len(conf), -1).any(axis=1).all()
    assert not (mask & ~clean_mask).any()


def test_peak_candidates_share_peak_topk_zero_front_end():
    """The candidates' top K by value are peak_topk(border="zero")'s peaks."""
    conf = torch.from_numpy(peak_inputs("painted"))
    ranked, _ = peak_candidates_plain(conf)
    _, _, sval = peak_topk_plain(conf, K, border="zero")
    top = ranked.reshape(*ranked.shape[:2], -1).topk(K, dim=-1).values
    valid = sval > -5e29
    assert torch.equal(top > -5e29, valid)
    assert torch.equal(top[valid], sval[valid])


def test_peak_candidates_take_the_decoders_strided_view():
    full = torch.from_numpy(peak_inputs("random"))
    view = torch.cat([full, full[..., :1]], dim=-1)[..., :18]
    got = peak_candidates(view, neg=-7.0)
    want = peak_candidates_plain(full, neg=-7.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(got[0].min()) == -7.0


# -- dispatch: the plain version only for CPU tensors, never a fallback --------

def test_cpu_tensors_take_the_plain_version():
    conf = torch.from_numpy(peak_inputs("painted"))
    before = (limb_scores.launches, peak_topk.launches)
    a = peak_topk(conf)
    b = peak_topk_plain(conf)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    paf, xy, valid, limbs = limb_inputs(5)
    args = (torch.from_numpy(paf), torch.from_numpy(xy), torch.from_numpy(valid), limbs)
    assert torch.equal(limb_scores(*args, bf16=False), limb_scores_plain(*args, bf16=False))
    assert (limb_scores.launches, peak_topk.launches) == before


def test_other_devices_raise():
    meta = torch.empty(1, 8, 8, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        peak_topk(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        limb_scores(torch.empty(1, 8, 8, 38, device="meta"),
                    torch.empty(1, 18, 4, 2, device="meta"),
                    torch.empty(1, 18, 4, dtype=torch.bool, device="meta"),
                    COCO_TOPOLOGY.limbs)


def test_peak_candidates_dispatch():
    conf = torch.from_numpy(peak_inputs("painted"))
    before = peak_candidates.launches
    assert all(torch.equal(a, b) for a, b in
               zip(peak_candidates(conf), peak_candidates_plain(conf)))
    assert peak_candidates.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        peak_candidates(torch.empty(1, 8, 8, 2, device="meta"))
    with pytest.raises(ValueError):
        peak_candidates(conf, ksize=4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler means no kernel: the build raises instead of falling
    back."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(("line_gather",))


def test_library_names_follow_the_source():
    """An edited source or changed flags build a new library."""
    path = build.library_path("peak_topk")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libpeak_topk-")
    assert build.library_path("line_gather") != path


def test_library_names_follow_the_headers(monkeypatch, tmp_path):
    """An edited, added or removed header (`csrc/*.cuh`) renames every
    library, so no source that includes it loads a stale build."""
    assert all((build.CSRC / f"{n}.cu").exists() for n in build.KERNELS)
    assert (build.CSRC / "sm90.cuh").exists()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    for name in ("one", "two"):
        (tmp_path / f"{name}.cu").write_text(f"// {name}\n")
    header = tmp_path / "shared.cuh"
    header.write_text("// first\n")
    first = {n: build.library_path(n) for n in ("one", "two")}
    assert first["one"] != first["two"]
    assert first == {n: build.library_path(n) for n in ("one", "two")}
    header.write_text("// second\n")
    second = {n: build.library_path(n) for n in ("one", "two")}
    assert all(second[n] != first[n] for n in first)
    (tmp_path / "more.cuh").write_text("")
    assert build.library_path("one") not in (first["one"], second["one"])
    header.unlink()
    (tmp_path / "more.cuh").unlink()
    assert build.library_path("one") not in (first["one"], second["one"])
