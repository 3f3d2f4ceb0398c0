"""The port of the TPU matmul probe, and the measures chip_smoke.py reports
(`tests/torch_measures.py`).

`stem_gemm_plain` (the stem's bf16 GEMM, `hp_stem_gemm` of
`csrc/stem_gemm.cu` on the card) is held against the probe's own XLA formula
(`scripts/probe_mosaic_matmul.py`: `jnp.einsum` with float32 accumulation,
rounded to bf16), written out here: the script sets a JAX cache when it is
imported. Tolerance: one bf16 ulp (the float32 sums are taken in another
order, so a value next to a rounding boundary may round the other way),
except where the difference is within what two float32 sums of the 384
products can differ by (torch_measures.SUM_ORDER)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one thread per test)
from hyperpose_torch.ops.kernels.conv1_pool import stem_gemm, stem_gemm_plain
from hyperpose_torch.ops.kernels.grow import fused_grow_plain
from torch_measures import SUM_ORDER, bf16_agreement, bf16_ulps, grow_work, int8_dwconv_work


def _operands(g, m, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g, m, 384)).astype(np.float32)
    w = (rng.standard_normal((384, 128)) * 0.05).astype(np.float32)
    return (torch.from_numpy(a).bfloat16(), torch.from_numpy(w).bfloat16())


@pytest.mark.parametrize("g,m", [(2, 48), (3, 37)])
def test_stem_gemm_plain_matches_probe_formula(g, m):
    a, w = _operands(g, m)
    ja = jnp.asarray(a.float().numpy(), jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    want = jnp.einsum("gmk,kn->gmn", ja, jw,
                      preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got = stem_gemm_plain(a, w)
    assert got.shape == (g, m, 128) and got.dtype == torch.bfloat16
    scale = torch.matmul(a.float().abs(), w.float().abs())
    assert bf16_ulps(got, want, SUM_ORDER * scale) <= 1


def test_stem_gemm_cpu_takes_the_plain_version():
    a, w = _operands(1, 16)
    before = stem_gemm.launches
    assert torch.equal(stem_gemm(a, w), stem_gemm_plain(a, w))
    assert stem_gemm.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        stem_gemm(a.to("meta"), w.to("meta"))


def test_bf16_ulps_counts_representable_values():
    x = torch.tensor([1.0, -2.0, 0.0, 3.0e-39, -1.5]).bfloat16()
    up = torch.nextafter(x.float(), torch.tensor(float("inf"))).bfloat16()
    assert bf16_ulps(x, x) == 0
    assert bf16_ulps(torch.tensor([0.0]).bfloat16(), torch.tensor([-0.0]).bfloat16()) == 0
    one = torch.tensor([1.0]).bfloat16()
    step = torch.tensor([1.0 + 2.0 ** -7]).bfloat16()    # the next bf16 above 1
    assert bf16_ulps(one, step) == 1
    # The smallest positive and negative subnormals lie two values apart.
    tiny = torch.tensor([2.0 ** -133]).bfloat16()
    assert bf16_ulps(tiny, -tiny) == 2
    assert bf16_ulps(x, up) <= 1
    # Near zero a tiny difference spans many ulps; a slack that covers it
    # counts it as none, and bf16_agreement reports both.
    a = torch.tensor([1e-6, 1.0]).bfloat16()
    b = torch.tensor([2e-6, 1.0]).bfloat16()
    assert bf16_ulps(a, b) > 100 and bf16_ulps(a, b, slack=2e-6) == 0
    assert bf16_agreement(a, b, torch.tensor([1e-6 / SUM_ORDER, 1.0])) == {
        "max_ulps": bf16_ulps(a, b), "outputs_beyond_1_ulp": 1,
        "max_ulps_beyond_sum_order": 0}


def _grow_inputs(steps, reverse_match):
    """Two images of 4 seed slots on a 3-part chain 0 -> 1 -> 2 (both
    directions), candidates on a coarse grid."""
    rng = np.random.default_rng(4)
    e_src, e_dst = (0, 1, 1, 2), (1, 2, 0, 1)
    b, mh, e, k = 2, 4, 4, 32
    grid = lambda *s: rng.integers(0, 8, s).astype(np.float32)  # noqa: E731
    tables = [torch.from_numpy(t) for t in (
        grid(b, e, k), grid(b, e, k), np.full((b, e, k), 0.5, np.float32),
        grid(b, e, k), grid(b, e, k), np.full((b, e, k), 3.0, np.float32))]
    rev = torch.tensor([2, 3, 0, 1])
    seed_part = torch.zeros((b, mh), dtype=torch.int32)
    vals = np.stack([grid(b, mh), grid(b, mh), np.full((b, mh), 3.0),
                     np.full((b, mh), 0.5)], axis=-1).astype(np.float32)
    vals[:, -1, 3] = 0.0                           # one empty slot per image
    return (seed_part, torch.from_numpy(vals), tuple(tables),
            tuple(t[:, rev] for t in tables), e_src, e_dst, 3, steps, reverse_match)


@pytest.mark.parametrize("reverse_match", [True, False])
def test_grow_needed_evaluations_counts_the_frontier(reverse_match):
    """Round 0 evaluates only the seeds' outgoing edge 0 -> 1 (one per live
    slot, plus its reverse check where it matched) and reads that edge's
    match rows once per image however many slots use them; no round
    evaluates more than the dense count, nor reads more than every table;
    no rounds, no evaluations and only the seeds and outputs."""
    b, mh, e, k, p = 2, 4, 4, 32, 3
    sides = 2 if reverse_match else 1
    seeds_and_outputs = 4 * (5 * b * mh + 4 * b * mh * p)
    assert grow_work(_grow_inputs(0, reverse_match)) == {
        "evaluations": 0, "bytes": seeds_and_outputs}
    one = grow_work(_grow_inputs(1, reverse_match))
    live = 2 * 3
    assert live * k <= one["evaluations"] <= live * k * sides
    row = 3 * k * 4                     # x, y, score of one edge's candidates
    winners = 3 * 4 * min(k, 2 * 3)     # at most 2 per slot on the row
    assert (seeds_and_outputs + b * row
            <= one["bytes"] <= seeds_and_outputs + sides * b * (row + winners))
    args = _grow_inputs(4, reverse_match)
    total = grow_work(args)
    assert one["evaluations"] < total["evaluations"] <= b * mh * 4 * e * k * sides
    assert one["bytes"] < total["bytes"] <= seeds_and_outputs + 4 * 12 * b * e * k
    grown = fused_grow_plain(*args)[0]
    assert int((grown[:, :3] > 0).sum()) > 2 * 3   # something grew past the seed


@pytest.mark.parametrize("c,cp,k,stride,pad,dil,in_itemsize", [
    (19, 32, 3, 1, 1, 1, 1), (38, 64, 3, 2, 1, 1, 1), (1209, 1216, 1, 1, 0, 1, 1),
    (40, 64, 3, 1, 2, 2, 1), (1209, 1216, 3, 1, 1, 1, 2)])
def test_int8_dwconv_work_counts_only_the_real_channels(c, cp, k, stride, pad, dil,
                                                         in_itemsize):
    """The bytes are the C channels' input at its itemsize (1 for the
    quantized buffer, 2 for the fused kernel's bf16 input), taps, dq and
    bias and the output, whatever the padding to Cp; the operations are 2
    for each tap of each channel that falls inside the image, counted here
    by a conv of ones over an image of ones."""
    import torch.nn.functional as F

    b, h, w, out_itemsize = 2, 9, 11, 2
    work = int8_dwconv_work((b, h, w, cp), (k, k), (stride, stride), (pad, pad),
                            (dil, dil), c, out_itemsize, in_itemsize)
    inside = F.conv2d(torch.ones(1, 1, h, w), torch.ones(1, 1, k, k), None, stride, pad, dil)
    ho, wo = inside.shape[-2:]
    assert work["bytes"] == (b * h * w * c * in_itemsize + k * k * c + 8 * c
                             + b * ho * wo * c * out_itemsize)
    assert work["operations"] == 2 * b * c * int(inside.sum())
    assert work == int8_dwconv_work((b, h, w, c), (k, k), (stride, stride), (pad, pad),
                                    (dil, dil), c, out_itemsize, in_itemsize)
