"""The port's `paf_decode_batch` against the JAX decoder and the sequential
golden model, on painted maps (tests/test_paf_decode.py) and the random
scenes of tests/test_paf_golden.py.

Tolerances: valid and part_valid exact; coords atol 1e-5 in every slot
(invalid human slots included, which holds only because both rank with a
stable top-K); human scores atol 1e-3 (float32 sums taken in another order).
"""
import functools

import numpy as np
import pytest
import torch

from torch_parity import tie_maps
from golden_paf import golden_decode
from hyperpose_tpu.ops import paf_decode as JD
from hyperpose_torch.ops import paf_decode as TD
from test_paf_decode import TWO_PEOPLE, make_synthetic_maps
from test_paf_golden import random_scene

SEEDS = [(0, 1), (1, 2), (2, 3), (3, 2)]
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _scenes():
    return [TWO_PEOPLE] + [
        random_scene(np.random.default_rng(seed), n) for seed, n in SEEDS
    ]


def _maps(scenes):
    pairs = [make_synthetic_maps(s) for s in scenes]
    return (np.stack([c for c, _ in pairs]), np.stack([p for _, p in pairs]))


def _decode_both(conf, paf, **cfg):
    j = JD.paf_decode_batch(conf, paf, JD.PafDecoderConfig(**cfg))
    t = TD.paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf),
                            TD.PafDecoderConfig(**cfg))
    return ({f: np.asarray(getattr(j, f)) for f in FIELDS},
            {f: getattr(t, f).numpy() for f in FIELDS})


def _assert_same(want, got, idx=slice(None)):
    np.testing.assert_array_equal(got["valid"][idx], want["valid"][idx])
    np.testing.assert_array_equal(got["part_valid"][idx], want["part_valid"][idx])
    np.testing.assert_allclose(got["coords"][idx], want["coords"][idx],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"][idx], want["scores"][idx],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["part_scores"][idx], want["part_scores"][idx],
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


@pytest.fixture(scope="module")
def default_decode(scenes):
    conf, paf = _maps(scenes)
    want, got = _decode_both(conf, paf)
    return conf, paf, want, got


def test_config_fields_and_defaults_match():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JD.PafDecoderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TD.PafDecoderConfig)}
    assert jf == tf


@pytest.mark.parametrize("i", range(1 + len(SEEDS)))
def test_decode_matches_jax(default_decode, i):
    _, _, want, got = default_decode
    assert got["coords"].shape == (5, 32, 18, 2)
    _assert_same(want, got, i)


def test_two_people_found(default_decode):
    _, _, _, got = default_decode
    assert int(got["valid"][0].sum()) == 2


@pytest.mark.parametrize("i", range(1 + len(SEEDS)))
def test_decode_matches_golden(default_decode, i):
    """Stages 2-5 against the sequential golden model on the port's own
    peaks (the check tests/test_paf_golden.py makes of the JAX decoder)."""
    conf, paf, _, got = default_decode
    cfg = TD.PafDecoderConfig()
    pxy, psc, pva = TD.find_peaks(torch.from_numpy(conf[i:i + 1, ..., :18]), cfg)
    golden = golden_decode(pxy[0].numpy(), psc[0].numpy(), pva[0].numpy(),
                           paf[i], cfg)
    humans = [
        {p: (got["coords"][i, h, p, 0] * 54 - 0.5,
             got["coords"][i, h, p, 1] * 46 - 0.5)
         for p in np.nonzero(got["part_valid"][i, h])[0]}
        for h in np.nonzero(got["valid"][i])[0]
    ]
    assert len(humans) == len(golden)
    for g in golden:
        best = max(
            sum(1 for p, (gx, gy, _) in g["parts"].items()
                if p in d and abs(d[p][0] - gx) <= 1.5 and abs(d[p][1] - gy) <= 1.5)
            for d in humans
        )
        assert best == len(g["parts"])


def test_small_tables_and_f32_gather_match_jax(scenes):
    """T < K*K, fewer humans than components could fill, and an unrounded
    gather."""
    conf, paf = _maps(scenes[:3])
    want, got = _decode_both(conf, paf, max_peaks=8, max_candidates=16,
                             max_humans=8, gather_bf16=False)
    _assert_same(want, got)


def test_pallas_peak_backend_matches_jax(scenes):
    """peaks_backend="pallas" is the zero-border kernel in both packages."""
    conf, paf = _maps(scenes[:2])
    want, got = _decode_both(conf, paf, peaks_backend="pallas")
    _assert_same(want, got)


def test_backends_agree_on_cpu(default_decode):
    conf, paf, _, got = default_decode
    out = TD.paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf),
                              TD.PafDecoderConfig(peaks_backend="xla",
                                                  gather_backend="xla"))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), got[f])


def test_empty_maps_decode_to_nobody():
    conf = torch.zeros(2, 46, 54, 19)
    paf = torch.zeros(2, 46, 54, 38)
    out = TD.paf_decode_batch(conf, paf)
    assert not out.valid.any() and not out.part_valid.any()
    assert float(out.scores.abs().max()) == 0.0


@pytest.fixture
def jax_candidates_interpreted(monkeypatch):
    """JAX's use_pallas_peaks branch calls the Pallas kernel without
    `interpret`; run it in interpret mode in this test process only."""
    from hyperpose_tpu.ops.pallas import peak_kernel

    monkeypatch.setattr(peak_kernel, "fused_peak_candidates", functools.partial(
        peak_kernel.fused_peak_candidates, interpret=True))


@pytest.mark.parametrize("maps", ["painted", "ties"])
def test_pallas_peaks_find_peaks_matches_jax(jax_candidates_interpreted, maps,
                                             scenes):
    """use_pallas_peaks: the candidates kernel, then find_peaks' own argmax
    rounds and clipped-index sub-pixel fit. Valid exact, xy atol 1e-5, the
    raw scores exact."""
    import jax.numpy as jnp

    conf = (tie_maps() if maps == "ties"
            else _maps(scenes[:3])[0][..., :18])
    cfg = dict(use_pallas_peaks=True)
    wxy, wsc, wva = (np.asarray(t) for t in JD.find_peaks(
        jnp.asarray(conf), JD.PafDecoderConfig(**cfg)))
    xy, sc, va = (t.numpy() for t in TD.find_peaks(
        torch.from_numpy(conf), TD.PafDecoderConfig(**cfg)))
    np.testing.assert_array_equal(va, wva)
    assert va.any()
    np.testing.assert_allclose(xy[va], wxy[va], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(sc, wsc)


def test_pallas_peaks_decode_matches_jax(jax_candidates_interpreted, scenes):
    conf, paf = _maps(scenes[:3])
    want, got = _decode_both(conf, paf, use_pallas_peaks=True)
    _assert_same(want, got)
    assert int(got["valid"][0].sum()) == 2


def test_unported_options_raise():
    conf = torch.zeros(1, 46, 54, 19)
    with pytest.raises(ValueError):
        TD.paf_decode_batch(conf, torch.zeros(1, 46, 54, 38),
                            TD.PafDecoderConfig(gather_backend="tpu"))
