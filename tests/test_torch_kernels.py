"""The port's two kernels: their plain PyTorch versions against the JAX
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
from hyperpose_tpu.ops.pallas.peak_kernel import fused_peak_topk
from hyperpose_torch.ops.kernels import build
from hyperpose_torch.ops.kernels.line_gather import line_gather, line_gather_plain
from hyperpose_torch.ops.kernels.peak_topk import peak_topk, peak_topk_plain
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


def test_line_gather_takes_strided_planes():
    """The decoder hands over a permuted view of the NHWC field."""
    rng = np.random.default_rng(4)
    paf = rng.standard_normal((2, 12, 16, 3 * 2)).astype(np.float32)
    planes = torch.from_numpy(paf).reshape(2, 12, 16, 3, 2).permute(0, 3, 4, 1, 2)
    ly = torch.from_numpy(rng.integers(0, 12, (2, 3, 64)).astype(np.int32))
    lx = torch.from_numpy(rng.integers(0, 16, (2, 3, 64)).astype(np.int32))
    got = line_gather(planes, ly, lx, False)
    want = line_gather_plain(planes.contiguous(), ly, lx, False)
    assert torch.equal(got, want)


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


# -- dispatch: the plain version only for CPU tensors, never a fallback --------

def test_cpu_tensors_take_the_plain_version():
    conf = torch.from_numpy(peak_inputs("painted"))
    before = (line_gather.launches, peak_topk.launches)
    a = peak_topk(conf)
    b = peak_topk_plain(conf)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    planes = torch.zeros(1, 2, 2, 4, 4)
    idx = torch.zeros(1, 2, 8, dtype=torch.int32)
    line_gather(planes, idx, idx)
    assert (line_gather.launches, peak_topk.launches) == before


def test_other_devices_raise():
    meta = torch.empty(1, 8, 8, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        peak_topk(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        line_gather(torch.empty(1, 1, 2, 4, 4, device="meta"),
                    torch.empty(1, 1, 3, dtype=torch.int32, device="meta"),
                    torch.empty(1, 1, 3, dtype=torch.int32, device="meta"))


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
