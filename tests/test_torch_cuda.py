"""The port on a CUDA device: each CUDA kernel against its plain PyTorch
version, and the decoder and engine on the card against the port on the CPU.

Every test carries the `gpu` marker and skips without a card. This module
imports no JAX (nor tests/conftest.py's fixtures), so on a machine without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: limb_scores exact; peak_topk exact (xy, raw and sval, filler
slots included) and peak_candidates exact (the kernels repeat the plain
versions' float32 operations in the same order); conv1_pool atol and rtol 1e-4 in f32
(384-term sums in another order) and 1e-2 in bf16; in bf16 conv1_pool and
stem_gemm lie at most one bf16 ulp from their plain versions (the tensor
cores sum the float32 products in another order, so a sum next to a
rounding boundary may round the other way), except where the difference is
within what two float32 sums of 384 products in any order can differ by
(torch_measures.SUM_ORDER times the sum of the products' magnitudes: near zero
that is more than one of the result's tiny ulps); decode coords atol
1e-5 and human scores atol 1e-3; the engines' coords atol 1e-4 (cuDNN and the
CPU sum the f32 convs in other orders). The grow kernel equals its plain
version exactly (same float32 steps, no FMA contraction, accurate expf);
PifPaf decodes are compared as sets of humans (duplicates of equal score
may take other slots), coords and scores atol 1e-5 for painted fields and
1e-4 behind the f32 network. int8_gemm s8 equals its plain version
exactly, bf16 within the float32 sum-order slack at its depth
(torch_measures.sum_order); int8_quantize and int8_conv equal their plain
versions exactly (exact s32 sums, the same float32 epilogue operations);
Int8Conv2d on the card equals the CPU; the int8
engines agree with the CPU within their int8 noise (chip_smoke.INT8_TOL;
see the test). The Resnet18 family (PoseProposal, Lightweight-OpenPose on
Resnet18): the PoseProposal decode equals the CPU's bit for bit on the same
maps; f32 outputs within 1e-3 of their largest value of the CPU's; the
card's decode of its maps against the CPU's decode of the same maps, bit
for bit for PoseProposal; for the PAF decoder the peaks equal, the
limb-pair scores equal to their plain version on the card bit for bit and
within 1e-6 of the plain version on the CPU, and the humans within the
decode tolerances above; every int8 conv equal to its plain version and to
a CPU copy on the card's input. The rest of the OpenPose family
(Lightweight-OpenPose on MobilenetDilated, OpenPose on VGG19,
MobileNet-Thin and -Small OpenPose) is held as the Resnet18 family is;
`int8_dwconv` (quantize and depthwise conv in one kernel) equals its plain
version exactly (the quantize's float32 operations, exact sums, the same
float32 epilogue operations); peak_candidates on maps with NaN pixels
equals its plain version with NaN in the same places. The evaluator:
peak_topk exact on planes beyond a block's shared memory (the planes in
scratch, and at 344x344 the survivor lists too); `jax_resize_cubic` within
1e-6 of the largest value of the CPU's; one flagship batch's upsampled maps
within 1e-4 of their largest value of the CPU's and its skeletons within
the decode tolerances, with TF32 on outside the evaluator. Training: one
f32 step (TF32 off) of the flagship, PoseProposal and PifPaf at a small size
against the CPU, the loss within 1e-5 relative and the new BatchNorm
statistics within 1e-5, the card's gradients within 2e-2 in relative L2 of a
float64 step on the card over all and within 0.1 each
(`chip_smoke.check_step1`).
"""
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, SYNTH_NPZ, tie_maps
from torch_measures import SUM_ORDER, bf16_ulps, sum_order
from chip_smoke import (
    INT8_TOL, LW_MOBILENET, LW_RESNET18, MBSMALL_OPENPOSE, MBTHIN_OPENPOSE, OPENPOSE_VGG19,
    PPN, TWO_PEOPLE, _convs_card_vs_cpu, _convs_equal_plain, _equal_nan, _numpy,
    _peak_maps as serving_peak_maps, _record_int8_inputs, dense_ppn_maps, find_people,
    human_deltas, limb_scores_inputs, make_synthetic_maps, painted_pifpaf_batch,
    eval_peak_maps, nan_peak_maps, painted_ppn_batch, peak_candidates_cases, peak_topk_cases,
    served_weights,
)
from hyperpose_torch.models.backbones import (
    VggTiny, VggTinyFusedStem, remap_vggtiny_to_fused,
)
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
from hyperpose_torch.ops import pifpaf_decode as PD
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.conv1_pool import (
    conv1_pool, conv1_pool_plain, stem_gemm, stem_gemm_plain,
)
from hyperpose_torch.ops.kernels.grow import fused_grow, fused_grow_plain
from hyperpose_torch.ops.kernels.int8_gemm import (
    int8_conv, int8_conv_plain, int8_dwconv, int8_dwconv_fused_plain, int8_gemm,
    int8_gemm_plain, int8_quantize, int8_quantize_plain, padded_channels,
)
from hyperpose_torch.ops.kernels.line_gather import limb_scores, limb_scores_plain
from hyperpose_torch.ops.kernels.peak_topk import (
    peak_candidates, peak_candidates_plain, peak_topk, peak_topk_plain,
)
from hyperpose_torch.ops.paf_decode import PafDecoderConfig, paf_decode_batch
from hyperpose_torch.ops.ppn_decode import ppn_decode_batch
from hyperpose_torch.quant import Int8Conv2d, calibrate_engine, quantize_engine
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.topology import COCO_TOPOLOGY, PIFPAF_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

pytestmark = pytest.mark.gpu
LIMBS = np.asarray(COCO_TOPOLOGY.limbs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _peak_maps(name):
    if name == "ties":
        return tie_maps()
    rng = np.random.default_rng(11)
    if name == "random":
        return rng.uniform(0, 1, (3, 46, 54, 18)).astype(np.float32)
    return make_synthetic_maps(TWO_PEOPLE, LIMBS)[0][None, ..., :18]


def _field(paf, layout, cuda):
    """The field on the card channels-last, or as a view of an NCHW tensor."""
    f = torch.from_numpy(paf).to(cuda)
    if layout == "nchw_view":
        return f.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return f


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("layout", ["nhwc", "nchw_view"])
@pytest.mark.parametrize("shape", [(2, 46, 54, 16), (3, 13, 17, 5)])
def test_limb_scores_matches_plain(cuda, bf16, layout, shape):
    """Bit for bit, with invalid, coincident and edge peaks and samples the
    clamp moves (chip_smoke.limb_scores_inputs), in both layouts."""
    b, h, w, k = shape
    paf, xy, valid, limbs = limb_scores_inputs(np.random.default_rng(5), b, h, w, k)
    field = _field(paf, layout, cuda)
    xy, valid = torch.from_numpy(xy).to(cuda), torch.from_numpy(valid).to(cuda)
    before = limb_scores.launches
    got = limb_scores(field, xy, valid, limbs, bf16=bf16)
    want = limb_scores_plain(field, xy, valid, limbs, bf16=bf16)
    torch.cuda.synchronize()
    assert limb_scores.launches == before + 1
    assert got.shape == (b, len(limbs), k, k)
    assert bool((want > -5e29).any())
    assert torch.equal(got > -5e29, want > -5e29)
    assert torch.equal(got, want)


# (ksize, sigma) of the smooth: the PAF decoder's 5 / 0.75 (compiled with its
# taps unrolled), and 3 / 0.5 and the JAX evaluator's 9 / 1.5 (radius read
# at run time).
SMOOTHS = [(3, 0.5), (5, 0.75), (9, 1.5)]


@pytest.mark.parametrize("ksize,sigma", SMOOTHS)
@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_topk_matches_plain(cuda, border, maps, ksize, sigma):
    full = torch.from_numpy(_peak_maps(maps)).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    before = peak_topk.launches
    got = peak_topk(conf, 16, ksize, sigma, 0.05, border)
    want = peak_topk_plain(conf, 16, ksize, sigma, 0.05, border)
    torch.cuda.synchronize()
    assert peak_topk.launches == before + 1
    assert torch.equal(got[2] > -5e29, want[2] > -5e29)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("case", [
    "painted_k1", "random_k1", "random_k128", "lattice_k128", "lattice_ties_k16",
    "lattice_ties_k128", "no_survivor", "plateaus", "small_k_hw", "small_sparse_k_hw",
    "batch_strided", "nan_painted", "nan_random",
])
def test_peak_topk_edge_cases_match_plain(cuda, border, case):
    """K = 1, 128 and H*W, no survivor, the densest lattice of survivors
    (621 a plane, more than the block's threads) with distinct and equal
    values, plateaus, a batch-strided view, NaN pixels: equal to the plain
    version bit for bit, filler slots included (chip_smoke.peak_topk_cases;
    a filler on a NaN plane reads its raw score there, NaN in both)."""
    maps = serving_peak_maps(np.random.default_rng(0), LIMBS)
    conf, k = {n: (c, k) for n, c, k in peak_topk_cases(maps, cuda)}[case]
    got = peak_topk(conf, k, 5, 0.75, 0.05, border)
    want = peak_topk_plain(conf, k, 5, 0.75, 0.05, border)
    torch.cuda.synchronize()
    assert got[0].shape == (conf.shape[0], conf.shape[3], k, 2)
    assert all(_equal_nan(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("ksize,sigma", [(5, 0.75), (9, 1.5)])
@pytest.mark.parametrize("k", [24, 128])
@pytest.mark.parametrize("hw", [(120, 160), (184, 216), (344, 344)])
@pytest.mark.parametrize("maps", ["painted", "random"])
def test_peak_topk_beyond_shared_memory_matches_plain(cuda, maps, hw, k, ksize, sigma, border):
    """Planes too large for a block's shared memory (the evaluator's decode
    maps of a 480x640 input, and larger): the kernel keeps them in the
    scratch it is given, with the survivor lists in shared memory up to
    184x216 and in the scratch too at 344x344 (a 1376x1376 input), and
    equals the plain version bit for bit."""
    from hyperpose_torch.ops.kernels.peak_topk import scratch_plan

    tag = "x".join(map(str, hw))
    maps_np = eval_peak_maps(serving_peak_maps(np.random.default_rng(0), LIMBS))
    full = torch.from_numpy(maps_np[f"{maps}_{tag}"]).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    floats, global_lists = scratch_plan(conf.device.index, *hw)
    assert floats > 0 and global_lists == (hw == (344, 344))
    before = peak_topk.launches
    got = peak_topk(conf, k, ksize, sigma, 0.05, border)
    want = peak_topk_plain(conf, k, ksize, sigma, 0.05, border)
    torch.cuda.synchronize()
    assert peak_topk.launches == before + 1
    assert bool((want[2] > -5e29).any())
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_jax_resize_cubic_on_card_matches_cpu(cuda):
    """The evaluator's map upsample on the card (two float32 contractions,
    TF32 off) against the CPU, up 2x and down."""
    from hyperpose_torch.ops.image import jax_resize_cubic

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 46, 54, 19))
                         .astype(np.float32))
    for hw in ((92, 108), (23, 31)):
        got = jax_resize_cubic(x.to(cuda), hw).cpu()
        torch.testing.assert_close(got, jax_resize_cubic(x, hw), rtol=0,
                                   atol=1e-6 * float(x.abs().max()))


def test_flagship_evaluator_batch_on_card_matches_cpu(cuda):
    """One batch of the flagship evaluator (f32, 368x432, the synthetic
    frame and 7 random frames), called with TF32 on as PyTorch's cuDNN
    default has it: the evaluator runs its step with TF32 off and leaves the
    flags as they were; the card's maps after the cubic upsample within
    1e-4 of their largest value of the CPU's, and the skeletons of the two
    decodes equal within the decode tolerances."""
    from hyperpose_torch.eval.evaluate import Evaluator
    from hyperpose_torch.utils.weights import load_flax_weights

    rng = np.random.default_rng(0)
    frame = resize_bilinear(np.load(SYNTH_NPZ)["rgb"], (368, 432))
    batch = np.stack([frame] + [rng.integers(0, 255, frame.shape, dtype=np.uint8)
                                for _ in range(7)])
    out = {}
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        for dev in (cuda, torch.device("cpu")):
            model = load_flax_weights(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ)
            ev = Evaluator(model, None, (368, 432), None, COCO_TOPOLOGY, device=dev)
            conf, paf = ev.maps(batch)
            sk = ev.infer_batch(batch)
            out[dev.type] = (conf.cpu(), paf.cpu(), sk)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        assert a.shape == b.shape == (8, 92, 108, a.shape[-1])
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    gpu, cpu = out["cuda"][2], out["cpu"][2]
    assert len(gpu.to_humans(0)) == 2
    d_xy, d_s = human_deltas(vars(gpu), vars(cpu))
    assert d_xy <= 1e-5 and d_s <= 1e-3


@pytest.mark.parametrize("ksize,sigma", SMOOTHS)
@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_candidates_match_plain(cuda, maps, ksize, sigma):
    full = torch.from_numpy(_peak_maps(maps)).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    before = peak_candidates.launches
    got = peak_candidates(conf, ksize, sigma, 0.05, -1e30)
    want = peak_candidates_plain(conf, ksize, sigma, 0.05, -1e30)
    torch.cuda.synchronize()
    assert peak_candidates.launches == before + 1
    assert torch.equal(got[0] > -5e29, want[0] > -5e29)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("ksize,sigma", SMOOTHS)
@pytest.mark.parametrize("maps", ["painted", "random"])
def test_peak_candidates_match_plain_on_nan_maps(cuda, maps, ksize, sigma):
    """Maps with NaN pixels (chip_smoke.nan_peak_maps: a lone NaN beside a
    peak, a NaN plane): the band kernel equals its plain version, NaN in
    the same places, so a peak with a NaN in its 3x3 window is dropped as
    JAX drops it; peak_topk's zero-border front end keeps the same peaks
    (its top K values are the candidates' top K)."""
    conf = torch.from_numpy(nan_peak_maps(_peak_maps(maps))).to(cuda)
    got = peak_candidates(conf, ksize, sigma, 0.05, -1e30)
    want = peak_candidates_plain(conf, ksize, sigma, 0.05, -1e30)
    _, _, sval = peak_topk(conf, 16, ksize, sigma, 0.05, "zero")
    torch.cuda.synchronize()
    assert bool(got[1].isnan().any()) and not bool(got[0].isnan().any())
    assert _equal_nan(got[0], want[0]) and _equal_nan(got[1], want[1])
    top = got[0].flatten(2).topk(16, dim=-1).values
    valid = sval > -5e29
    assert torch.equal(top > -5e29, valid) and torch.equal(top[valid], sval[valid])


_CANDIDATE_CASES = [name for name, *_ in peak_candidates_cases(
    dict.fromkeys(("painted", "random"), np.zeros((1, 46, 54, 18), np.float32)), "cpu")]


@pytest.mark.parametrize("case", _CANDIDATE_CASES)
def test_peak_candidates_bands_match_plain(cuda, case):
    """The band kernel at ragged and short heights, a ragged part group,
    ksize 3 to 31 on both load orders, and maps wide enough to shrink the
    band: equal to the plain version bit for bit
    (chip_smoke.peak_candidates_cases)."""
    maps = serving_peak_maps(np.random.default_rng(0), LIMBS)
    conf, ks, sg = {name: rest for name, *rest in peak_candidates_cases(maps, cuda)}[case]
    got = peak_candidates(conf, ks, sg, 0.05, -1e30)
    want = peak_candidates_plain(conf, ks, sg, 0.05, -1e30)
    torch.cuda.synchronize()
    assert bool((want[0] > -5e29).any())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _btp(cuda, dtype, shape=(2, 24, 40, 128), seed=6, batch_step=1):
    """A conv0p-like output [B, H, Q, 128] read through channels-last
    strides (every `batch_step`-th image of a larger batch), with weights
    and bias."""
    rng = np.random.default_rng(seed)
    b, h, q, c = shape
    nchw = torch.from_numpy(
        rng.normal(0, 1, (b * batch_step, c, h, q)).astype(np.float32))
    nchw = nchw.to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    w1p = torch.from_numpy(rng.normal(0, 0.1, (3, 128, 128)).astype(np.float32))
    b1p = torch.from_numpy(rng.normal(0, 0.1, (128,)).astype(np.float32))
    return nchw[::batch_step].permute(0, 2, 3, 1), w1p.to(cuda, dtype), b1p.to(cuda)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,batch_step", [
    ((2, 24, 40, 128), 1),
    ((1, 2, 1, 128), 1),     # Q = 1: both border masks on one pair; H = 2
    ((1, 6, 33, 128), 1),
    ((1, 4, 7, 128), 1),     # Q one less than a warp's 8 pairs
    ((2, 2, 9, 128), 1),     # Q one more; H = 2
    ((3, 14, 17, 128), 1),   # B = 3; 7 row pairs; a ragged last q group
    ((3, 90, 100, 128), 1),  # more units than warps: ranges start mid-column
    ((2, 24, 40, 128), 2),   # a batch-strided view
])
def test_conv1_pool_matches_plain(cuda, dtype, tol, shape, batch_step):
    """Every edge of the tiling: the fp32 FMA tiles (32 pairs x 2 rows) and
    the bf16 warp units (8 pairs x 2 rows, persistent warps taking equal
    contiguous ranges of units, each range starting with a full strip)."""
    btp, w1p, b1p = _btp(cuda, dtype, shape, batch_step=batch_step)
    before = conv1_pool.launches
    got = conv1_pool(btp, w1p, b1p)
    want = conv1_pool_plain(btp, w1p, b1p)
    torch.cuda.synchronize()
    assert conv1_pool.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[1] // 2, shape[2], 64)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        scale = conv1_pool_plain(btp.abs(), w1p.abs(), torch.zeros_like(b1p)).float()
        assert bf16_ulps(got, want, SUM_ORDER * scale) <= 1


@pytest.mark.parametrize("g,m", [(1, 16), (3, 37), (64, 321), (1, 1), (1, 127), (1, 128),
                                 (1, 129), (64, 9936)])
def test_stem_gemm_matches_plain(cuda, g, m):
    """The stem's GEMM at ragged row counts around its 128-row tile (rows
    past M load as zeros and are not stored) and at the probe's shape,
    within one bf16 ulp of the float32 product."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(0, 1, (g, m, 384)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.05, (384, 128)).astype(np.float32))
    a, w = a.to(cuda, torch.bfloat16), w.to(cuda, torch.bfloat16)
    before = stem_gemm.launches
    got = stem_gemm(a, w)
    want = stem_gemm_plain(a, w)
    torch.cuda.synchronize()
    assert stem_gemm.launches == before + 1
    assert got.shape == (g, m, 128) and got.dtype == torch.bfloat16
    scale = torch.matmul(a.float().abs(), w.float().abs())
    assert bf16_ulps(got, want, SUM_ORDER * scale) <= 1


def test_stem_gemm_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(2, 32, 384, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(384, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        stem_gemm(a.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        stem_gemm(a[:, ::2], w)
    with pytest.raises(ValueError):
        stem_gemm(a[..., :128], w)


def test_conv1_pool_refuses_a_transposing_copy(cuda):
    """A [B, H, Q, 128] view whose lanes are not contiguous (an NCHW-
    contiguous conv output) raises instead of being copied."""
    btp, w1p, b1p = _btp(cuda, torch.float32)
    nchw = btp.permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="channels-last"):
        conv1_pool(nchw.permute(0, 2, 3, 1), w1p, b1p)
    with pytest.raises(TypeError):
        conv1_pool(btp, w1p.bfloat16(), b1p)
    with pytest.raises(TypeError):
        conv1_pool(btp, w1p, b1p.double())
    with pytest.raises(ValueError):
        conv1_pool(btp[:, :3], w1p, b1p)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    conf = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(ValueError):
        peak_topk(conf, k=200)
    with pytest.raises(ValueError, match="thresh"):
        peak_topk(conf, thresh=-1e30)
    with pytest.raises(TypeError):
        peak_topk(conf.double())
    paf = torch.zeros(1, 8, 8, 38, device=cuda)
    xy = torch.zeros(1, 18, 4, 2, device=cuda)
    valid = torch.ones(1, 18, 4, dtype=torch.bool, device=cuda)
    limbs = COCO_TOPOLOGY.limbs
    with pytest.raises(TypeError):
        limb_scores(paf.double(), xy, valid, limbs)
    with pytest.raises(TypeError):
        limb_scores(paf, xy, valid.float(), limbs)
    with pytest.raises(ValueError):
        limb_scores(paf[..., :36], xy, valid, limbs)       # not 2 channels a limb
    with pytest.raises(ValueError):
        limb_scores(paf, xy[:, :10], valid[:, :10], limbs)  # a limb past the parts
    with pytest.raises(ValueError):
        limb_scores(paf, xy, valid, limbs, n_samples=0)
    with pytest.raises(ValueError, match="no band"):
        peak_candidates(torch.zeros(1, 4, 4000, 2, device=cuda), ksize=31, sigma=5.0)


def test_decode_on_card_matches_cpu(cuda):
    conf, paf = make_synthetic_maps(TWO_PEOPLE, LIMBS)
    conf = np.repeat(conf[None], 2, axis=0)
    paf = np.repeat(paf[None], 2, axis=0)
    cfg = PafDecoderConfig()
    gpu = paf_decode_batch(torch.from_numpy(conf).to(cuda),
                           torch.from_numpy(paf).to(cuda), cfg)
    cpu = paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf), cfg)
    assert gpu.valid.sum(dim=1).tolist() == [2, 2]
    assert torch.equal(gpu.valid.cpu(), cpu.valid)
    assert torch.equal(gpu.part_valid.cpu(), cpu.part_valid)
    torch.testing.assert_close(gpu.coords.cpu(), cpu.coords, rtol=0, atol=1e-5)
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=0, atol=1e-3)


def test_engine_on_card_matches_cpu(cuda):
    """f32 with TF32 off: the card and the CPU decode the same skeletons."""
    batch = resize_bilinear(np.load(SYNTH_NPZ)["rgb"], (184, 216))[None]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eng = PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=(184, 216),
                         max_batch_size=1, device=dev)
        d = eng.infer_batch_device(batch)
        out[dev.type] = {f: getattr(d, f).cpu() for f in ("valid", "coords", "scores")}
    assert torch.equal(out["cuda"]["valid"], out["cpu"]["valid"])
    torch.testing.assert_close(out["cuda"]["coords"], out["cpu"]["coords"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"]["scores"], out["cpu"]["scores"],
                               rtol=0, atol=1e-3)


def test_fused_stem_engine_on_card_matches_cpu(cuda):
    """The fused serving stem runs conv1_pool on the card and decodes the
    skeletons the port decodes on the CPU."""
    batch = resize_bilinear(np.load(SYNTH_NPZ)["rgb"], (184, 216))[None]
    weights = remap_vggtiny_to_fused(FLAGSHIP_NPZ)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eng = PoseEngine(LightWeightOpenPose(backbone=VggTinyFusedStem), weights,
                         input_hw=(184, 216), max_batch_size=1, device=dev)
        before = conv1_pool.launches
        d = eng.infer_batch_device(batch)
        assert conv1_pool.launches == before + (dev.type == "cuda")
        out[dev.type] = {f: getattr(d, f).cpu() for f in ("valid", "coords", "scores")}
    assert torch.equal(out["cuda"]["valid"], out["cpu"]["valid"])
    torch.testing.assert_close(out["cuda"]["coords"], out["cpu"]["coords"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"]["scores"], out["cpu"]["scores"],
                               rtol=0, atol=1e-3)


# -- int8 serving: the GEMM, Int8Conv2d and the int8 engine ------------------------

@pytest.mark.parametrize("k", [32, 192, 1824, 3456])
@pytest.mark.parametrize("n", [19, 38, 200, 256])
@pytest.mark.parametrize("m", [1, 17, 4099])
def test_int8_gemm_matches_plain(cuda, m, n, k):
    """s8 x s8 -> s32 equals the exact float64 product at the M, N and K
    tails the convolutions give it (N odd: scalar stores; K = 1824: a
    partial last slice)."""
    rng = np.random.default_rng(m * n + k)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(cuda)
    bt = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8)).to(cuda)
    before = int8_gemm.launches
    got = int8_gemm(a, bt)
    want = int8_gemm_plain(a, bt)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,n,k", [(4096, 256, 1792), (17, 19, 48), (4099, 200, 1824)])
def test_int8_gemm_bf16_matches_plain(cuda, m, n, k):
    """bf16 -> f32 at the probe's shape and at tails: within what two
    float32 sums of the same K products in any order differ by."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(cuda, torch.bfloat16)
    bt = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32)).to(cuda, torch.bfloat16)
    got = int8_gemm(a, bt)
    want = int8_gemm_plain(a, bt)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    slack = sum_order(k) * torch.matmul(a.float().abs(), bt.float().abs().T)
    assert bool(((got - want).abs() <= slack).all())


def test_int8_gemm_probe_shape_exact(cuda):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (4096, 1792)).astype(np.int8)).to(cuda)
    bt = torch.from_numpy(rng.integers(-127, 128, (256, 1792)).astype(np.int8)).to(cuda)
    assert torch.equal(int8_gemm(a, bt), int8_gemm_plain(a, bt))


def test_int8_gemm_refuses_what_it_does_not_take(cuda):
    a = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    bt = torch.zeros(4, 64, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        int8_gemm(a, bt.bfloat16())
    with pytest.raises(TypeError):
        int8_gemm(a.float(), bt.float())
    with pytest.raises(ValueError, match="multiple"):
        int8_gemm(a[:, :48], bt[:, :48])
    with pytest.raises(ValueError, match="contiguous"):
        int8_gemm(a[:, 32:], bt[:, 32:])
    with pytest.raises(ValueError):
        int8_gemm(a, bt[:, :32])
    with pytest.raises(ValueError, match="different devices"):
        int8_gemm(a, bt.cpu())


def _int8_conv_operands(cuda, cin, cout, k, stride, pad, dil, b, h, w, seed=0, cp=None):
    """A quantized buffer and padded weights as `Int8Conv2d` holds them
    (Cp = `padded_channels(cin)` unless given)."""
    rng = np.random.default_rng(seed)
    cp, np_ = cp or padded_channels(cin), -(-cout // 8) * 8
    xq = np.zeros((b, h, w, cp), np.int8)
    xq[..., :cin] = rng.integers(-127, 128, (b, h, w, cin))
    wq = np.zeros((np_, k, k, cp), np.int8)
    wq[:cout, ..., :cin] = rng.integers(-127, 128, (cout, k, k, cin))
    dq = rng.uniform(1e-5, 1e-3, cout).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return t(xq), t(wq), t(dq), t(bias), (stride, stride), (pad, pad), (dil, dil)


# cin, cout, k, stride, padding, dilation, batch, H, W: the padded layouts
# (Cp 32, 192, 224; Np 24, 40, 64), odd sizes, both strides, dilation 2, M
# tails, and the ResNet50 stem and downsample.
INT8_CONV_GRID = [
    (3, 19, 1, 1, 0, 1, 1, 37, 45), (3, 64, 7, 2, 3, 1, 2, 67, 61),
    (185, 38, 3, 1, 2, 2, 2, 23, 29), (200, 64, 7, 2, 3, 1, 1, 31, 27),
    (3, 38, 3, 2, 2, 2, 2, 33, 41), (185, 19, 7, 1, 6, 2, 1, 19, 25),
    (200, 38, 1, 1, 0, 1, 2, 21, 23), (200, 19, 3, 2, 1, 1, 2, 25, 21),
    (185, 64, 1, 2, 0, 1, 1, 27, 35), (64, 256, 1, 2, 0, 1, 2, 46, 54),
    (128, 512, 1, 1, 0, 1, 1, 9, 7), (384, 128, 3, 1, 1, 1, 1, 1, 1),
]


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_CONV_GRID)
def test_int8_conv_matches_plain(cuda, shape, out_dtype, narrow):
    """The implicit-GEMM conv (im2col TMA boxes, zero borders from the
    hardware, fused dequantize) equals its plain version exactly: the s32
    sums are exact and the epilogue is the same float32 operations. Cp is
    `padded_channels(cin)` (boxes of 32, 64 and 128 bytes), or with `narrow`
    cin rounded up to 32 (32-byte boxes wherever Cp is not a multiple of
    64)."""
    cin, cout, k, stride, pad, dil, b, h, w = shape
    cp = -(-cin // 32) * 32 if narrow else None
    args = _int8_conv_operands(cuda, cin, cout, k, stride, pad, dil, b, h, w, seed=sum(shape),
                               cp=cp)
    before = int8_conv.launches
    got = int8_conv(*args, out_dtype)
    want = int8_conv_plain(*args, out_dtype)
    torch.cuda.synchronize()
    assert int8_conv.launches == before + 1
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want)
    no_bias = args[:3] + (None,) + args[4:]
    assert torch.equal(int8_conv(*no_bias, out_dtype), int8_conv_plain(*no_bias, out_dtype))


def test_int8_conv_matches_plain_at_every_flagship_shape(cuda):
    """Every conv of the flagship step at 368x432, batch 8, on that conv's
    own input shape: the kernel equals its plain version exactly."""
    model = LightWeightOpenPose(backbone=VggTiny).to(cuda).eval()
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a: shapes.append((mod, tuple(a[0].shape))))
        for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        model(torch.zeros(8, 368, 432, 3, device=cuda))
    for hk in hooks:
        hk.remove()
    assert len(shapes) == 40
    for i, (conv, (b, cin, h, w)) in enumerate(shapes):
        args = _int8_conv_operands(cuda, cin, conv.out_channels, conv.kernel_size[0],
                                   conv.stride[0], conv.padding[0], conv.dilation[0], b, h, w,
                                   seed=i)
        got = int8_conv(*args, torch.bfloat16)
        assert torch.equal(got, int8_conv_plain(*args, torch.bfloat16)), (i, cin, h, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,layout", [(3, "nchw"), (37, "channels_last"), (64, "channels_last"),
                                      (185, "channels_last"), (128, "strided"), (200, "strided")])
def test_int8_quantize_matches_plain(cuda, dtype, c, layout):
    """One pass from any NCHW view, ties and clipping included: the 4-channel
    path, and (C a multiple of 16 on 16-byte-aligned channels-last pixels:
    64, 128) the 16-channel path."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy((rng.integers(-600, 601, (3, c, 13, 17)) / 4).astype(np.float32))
    x = x.to(cuda, dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        x = x.contiguous(memory_format=torch.channels_last)[::2, :, 1:, ::3]
    inv_s, cp = float(np.float32(2.0)), padded_channels(c)
    before = int8_quantize.launches
    got = int8_quantize(x, inv_s, cp)
    want = int8_quantize_plain(x, inv_s, cp)
    torch.cuda.synchronize()
    assert int8_quantize.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,k,stride,pad,dil", [
    (3, 3, 1, 1, 1), (3, 7, 2, 3, 1), (6, 3, 1, 2, 2), (12, 3, 2, 0, 1)])
def test_int8_quantize_folded_matches_plain(cuda, dtype, c, k, stride, pad, dil):
    """The folding quantize of a conv on few channels: each output pixel's
    kh * kw * C filter values in (dy, dx, c) order, zero outside the image
    and beyond K, equal to the plain quantize followed by im2col."""
    rng = np.random.default_rng(c + k)
    x = torch.from_numpy((rng.integers(-600, 601, (2, c, 21, 26)) / 4).astype(np.float32))
    x = x.to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    fold = ((k, k), (stride, stride), (pad, pad), (dil, dil))
    cp = padded_channels(k * k * c)
    before = int8_quantize.launches
    got = int8_quantize(x, 2.0, cp, fold)
    want = int8_quantize_plain(x, 2.0, cp, fold)
    torch.cuda.synchronize()
    assert int8_quantize.launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    xq, wq, dq, bias, *geo = _int8_conv_operands(cuda, 32, 24, 3, 1, 1, 1, 1, 8, 8)
    with pytest.raises(TypeError):
        int8_conv(xq.float(), wq, dq, bias, *geo, torch.float32)
    with pytest.raises(TypeError):
        int8_conv(xq, wq, dq.double(), bias, *geo, torch.float32)
    with pytest.raises(TypeError):
        int8_conv(xq, wq, dq, bias, *geo, torch.float16)
    odd = torch.empty(xq.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(xq.shape)
    with pytest.raises(ValueError, match="aligned"):
        int8_conv(odd, wq, dq, bias, *geo, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        int8_conv(xq, wq.cpu(), dq, bias, *geo, torch.float32)
    with pytest.raises(ValueError):
        int8_conv(xq, wq[:, :, :, :16].contiguous(), dq, bias, *geo, torch.float32)
    with pytest.raises(TypeError):
        int8_quantize(torch.zeros(1, 3, 4, 4, device=cuda, dtype=torch.float64), 1.0, 32)
    with pytest.raises(ValueError):
        int8_quantize(torch.zeros(1, 40, 4, 4, device=cuda), 1.0, 32)
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, groups=4)
    with pytest.raises(NotImplementedError, match="grouped"):
        Int8Conv2d.from_conv(conv, np.zeros((3, 3, 2, 8), np.float32), None, 1.0)


@pytest.mark.parametrize("cin,cout,k,stride,dtype", [
    (16, 24, 3, 1, torch.float32), (185, 128, 1, 1, torch.float32),
    (3, 64, 7, 2, torch.float32), (200, 38, 3, 1, torch.bfloat16),
    (384, 512, 1, 1, torch.bfloat16)])
def test_int8_conv_on_card_equals_cpu(cuda, cin, cout, k, stride, dtype):
    """The same Int8Conv2d and channels-last input on the card and on the
    CPU: the s32 sums are exact and the float32 epilogue is the same IEEE
    operations, so the outputs are equal. The card runs one quantize and
    one conv launch, and no GEMM."""
    rng = np.random.default_rng(cin + k)
    kernel = (rng.normal(0, 1, (k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    conv = torch.nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 if stride == 1 else 0)
    q = Int8Conv2d.from_conv(conv, kernel, rng.normal(0, 0.1, cout), 2.5)
    x = torch.from_numpy(rng.normal(0, 1, (2, cin, 23, 27)).astype(np.float32)).to(dtype)
    before = int8_gemm.launches, int8_quantize.launches, int8_conv.launches
    with torch.inference_mode():
        got = q.to(cuda)(x.to(cuda).contiguous(memory_format=torch.channels_last))
        want = q.cpu()(x.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert (int8_gemm.launches, int8_quantize.launches, int8_conv.launches) == (
        before[0], before[1] + 1, before[2] + 1)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def test_int8_engine_on_card_matches_cpu(cuda):
    """The int8 f32 flagship (one scale table) in the plain and fused forms
    on the card and on the CPU: every conv launches the quantize and the
    conv kernels once, never the GEMM (and the fused stem conv1_pool once);
    the maps agree within the int8 noise (a last-place difference between
    the devices' BatchNorms flips roundings that grow through the network:
    chip_smoke.INT8_TOL), and both engines find
    the float engine's people."""
    frame = np.load(SYNTH_NPZ)["rgb"]
    hw = (368, 432)   # at 184x216 the synthetic people are too weak to survive int8
    batch = resize_bilinear(frame, hw)[None]
    for backbone, weights, n_convs in (
            (VggTiny, FLAGSHIP_NPZ, 40),
            (VggTinyFusedStem, remap_vggtiny_to_fused(FLAGSHIP_NPZ), 39)):
        kw = {"backbone": backbone}
        cpu = PoseEngine(LightWeightOpenPose(**kw), weights, input_hw=hw,
                         max_batch_size=1, device="cpu")
        people = cpu.inference([frame])[0]
        assert len(people) == 2
        scales = calibrate_engine(cpu, [batch])
        maps = {}
        for dev in (cuda, torch.device("cpu")):
            eng = PoseEngine(LightWeightOpenPose(**kw), weights, input_hw=hw,
                             max_batch_size=1, device=dev, quant_scales=scales)
            before = (int8_conv.launches, int8_quantize.launches, int8_gemm.launches,
                      conv1_pool.launches)
            eng.infer_batch_device(batch)
            on_card = dev.type == "cuda"
            assert (int8_conv.launches, int8_quantize.launches, int8_gemm.launches) == (
                before[0] + on_card * n_convs, before[1] + on_card * n_convs, before[2])
            assert conv1_pool.launches == before[3] + (on_card and n_convs == 39)
            found = find_people(people, eng.inference([frame])[0])
            assert found is not None and found <= INT8_TOL["xy"]
            with torch.inference_mode():
                x = torch.from_numpy(batch).to(dev, torch.float32) / 255.0
                maps[dev.type] = {k: v.cpu() for k, v in eng.model(x).items()
                                  if k in ("conf_map", "paf_map")}
        for k, want in maps["cpu"].items():
            rel = float((maps["cuda"][k] - want).abs().max() / want.abs().max())
            assert rel <= INT8_TOL["maps"], (k, rel)


# -- PifPaf: the grow kernel, the decoder and the engine ------------------------

def _tie_tables(cuda, b=2, mh=8, k=128, seed=3, e=None, p=17, steps=8,
                zero_slots=False):
    """Growth inputs on a coarse integer grid: many candidates at exactly
    equal distances and scores, so best and second best tie often. The
    edges are PifPaf's 38 directed limbs, or `e` random edges over `p`
    parts with a random reverse; with `zero_slots` every other seed slot has
    score 0."""
    rng = np.random.default_rng(seed)
    if e is None:
        limbs = np.asarray(PIFPAF_TOPOLOGY.limbs)
        e_src = tuple(int(v) for v in np.concatenate([limbs[:, 0], limbs[:, 1]]))
        e_dst = tuple(int(v) for v in np.concatenate([limbs[:, 1], limbs[:, 0]]))
        e = len(e_src)
        rev = (np.arange(e) + e // 2) % e
    else:
        e_src = tuple(int(v) for v in rng.integers(0, p, e))
        e_dst = tuple(int(v) for v in rng.integers(0, p, e))
        rev = rng.permutation(e)
    grid = lambda *s: rng.integers(0, 12, s).astype(np.float32)  # noqa: E731
    tables = [grid(b, e, k), grid(b, e, k),
              rng.choice([0.0, 0.5, 1.0], (b, e, k)).astype(np.float32),
              grid(b, e, k), grid(b, e, k),
              rng.integers(2, 5, (b, e, k)).astype(np.float32)]
    tables = [torch.from_numpy(t).to(cuda) for t in tables]
    rev = torch.tensor(rev, device=cuda)
    seed_part = torch.from_numpy(rng.integers(0, p, (b, mh)).astype(np.int32)).to(cuda)
    score = np.full((b, mh), 0.5)
    if zero_slots:
        score[:, 1::2] = 0.0
    vals = np.stack([grid(b, mh), grid(b, mh), rng.integers(2, 5, (b, mh)), score],
                    axis=-1).astype(np.float32)
    return (seed_part, torch.from_numpy(vals).to(cuda), tuple(tables),
            tuple(t[:, rev] for t in tables), e_src, e_dst, p, steps, True)


# Synthetic growth inputs at the edges of the kernel's limits and layout.
GROW_CASES = {
    "k_below_32": dict(k=20),
    "k200": dict(k=200),
    "e1": dict(e=1, p=2),
    "e64_p32": dict(e=64, p=32),
    "p1": dict(e=3, p=1),
    "steps0": dict(steps=0),
    "zero_slots": dict(zero_slots=True),
    "many_slots": dict(b=12, mh=96),   # several seed slots per block
    "e64_k256_p32": dict(e=64, p=32, k=256),  # reverse match tables not staged
    "odd_table": dict(e=3, p=3, k=21),        # E*K not a multiple of 4: plain loads
}


def _grow_args(cuda, case):
    if case == "ties":
        return _tie_tables(cuda)
    if case in GROW_CASES:
        return _tie_tables(cuda, **GROW_CASES[case])
    if case == "painted":
        fields = painted_pifpaf_batch(2)
    else:
        rng = np.random.default_rng(7)
        shapes = {"pif_conf": (17,), "pif_vec": (17, 2), "pif_scale": (17,),
                  "paf_conf": (19,), "paf_src_vec": (19, 2), "paf_dst_vec": (19, 2),
                  "paf_src_scale": (19,), "paf_dst_scale": (19,)}
        fields = {k: rng.normal(size=(2, 24, 28) + s).astype(np.float32)
                  for k, s in shapes.items()}
    cfg = PD.PifPafDecoderConfig()
    maps = PD.restore_maps({k: torch.from_numpy(v).to(cuda) for k, v in fields.items()}, 8)
    return PD.grow_inputs(PD._prepare(maps, cfg, PIFPAF_TOPOLOGY), cfg, PIFPAF_TOPOLOGY)


@pytest.mark.parametrize("case", ["painted", "dense_random", "ties", *GROW_CASES])
@pytest.mark.parametrize("reverse_match", [True, False])
def test_grow_matches_plain(cuda, case, reverse_match):
    args = _grow_args(cuda, case)[:8] + (reverse_match,)
    before = fused_grow.launches
    got = fused_grow(*args)
    want = fused_grow_plain(*args)
    torch.cuda.synchronize()
    assert fused_grow.launches == before + 1
    assert float(got[0].max()) > 0, "no annotation grew"
    for g, w in zip(got, want):
        assert g.shape == w.shape == (args[0].shape[0], args[0].shape[1], args[6])
        assert torch.equal(g, w)


def test_grow_refuses_what_it_does_not_take(cuda):
    args = list(_grow_args(cuda, "ties"))
    bad = {
        0: args[0].long(),                                    # seed_part int64
        1: args[1][..., :3],                                  # seed_vals width
        2: args[2][:5],                                       # 5 forward tables
        3: tuple(t.double() for t in args[3]),                # float64 tables
        4: args[4][:-1],                                      # edge count
        5: (99,) + args[5][1:],                               # edge end >= P
        6: 40,                                                # P > 32
    }
    for i, value in bad.items():
        with pytest.raises((TypeError, ValueError)):
            fused_grow(*(value if j == i else a for j, a in enumerate(args)))
    wide = tuple(torch.zeros(2, 38, 300, device=cuda) for _ in range(6))
    with pytest.raises(ValueError, match="K=300"):
        fused_grow(args[0], args[1], wide, wide, *args[4:])


def test_pifpaf_decode_on_card_matches_cpu(cuda):
    fields = painted_pifpaf_batch(2)
    before = fused_grow.launches
    gpu = _numpy(PD.pifpaf_decode_batch(
        {k: torch.from_numpy(v).to(cuda) for k, v in fields.items()}))
    assert fused_grow.launches == before + 1
    cpu = _numpy(PD.pifpaf_decode_batch(fields))
    assert gpu["valid"].sum(axis=1).tolist() == [2, 2]
    d_xy, d_s = human_deltas(gpu, cpu)
    assert d_xy <= 1e-5 and d_s <= 1e-5


def test_pifpaf_engine_on_card_matches_cpu(cuda):
    """f32 with TF32 off, seeded random weights, 64x96: the card runs the
    grow kernel and decodes the humans the port decodes on the CPU."""
    weights = random_flax_weights(Pifpaf(), seed=11)
    rng = np.random.default_rng(12)
    batch = np.stack([resize_bilinear(np.load(SYNTH_NPZ)["rgb"], (64, 96)),
                      rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)])
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = Pifpaf()
        eng = PoseEngine(model, weights, input_hw=(64, 96), max_batch_size=2,
                         device=dev, topology=PIFPAF_TOPOLOGY,
                         fused_decode=pifpaf_fused_decode(model))
        before = fused_grow.launches
        out[dev.type] = _numpy(eng.infer_batch_device(batch))
        assert fused_grow.launches == before + (dev.type == "cuda")
    assert out["cpu"]["valid"].sum() > 0
    d_xy, d_s = human_deltas(out["cuda"], out["cpu"])
    assert d_xy <= 1e-4 and d_s <= 1e-4


# -- the Resnet18 family: PoseProposal and Lightweight-OpenPose on Resnet18 ------

@pytest.mark.parametrize("case", ["painted", "ties"])
def test_ppn_decode_on_card_matches_cpu(cuda, case):
    """Bit for bit: the ties case has equal c in many cells (the stable
    top-K decides) and equal match values (the first maximum decides)."""
    maps = (painted_ppn_batch(2) if case == "painted"
            else dense_ppn_maps(6, b=2, levels=(0.1, 0.5, 0.5, 0.75)))
    gpu = _numpy(ppn_decode_batch({k: torch.from_numpy(v).to(cuda) for k, v in maps.items()}))
    cpu = _numpy(ppn_decode_batch(maps))
    for k in gpu:
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    assert gpu["valid"].sum(axis=1).tolist() == ([2, 2] if case == "painted"
                                                 else cpu["valid"].sum(axis=1).tolist())


SERVED = {"ppn": PPN, "lw_resnet18": LW_RESNET18, "lw_mobilenet": LW_MOBILENET,
          "openpose_vgg19": OPENPOSE_VGG19, "mbthin_openpose": MBTHIN_OPENPOSE,
          "mbsmall_openpose": MBSMALL_OPENPOSE}


def _r18_setup(kind):
    spec = SERVED[kind]
    rng = np.random.default_rng(13)
    batch = np.stack([resize_bilinear(np.load(SYNTH_NPZ)["rgb"], spec.hw),
                      rng.integers(0, 256, (*spec.hw, 3), dtype=np.uint8)])
    return spec, served_weights(spec), batch


@pytest.mark.parametrize("kind", ["ppn", "lw_resnet18"])
def test_resnet18_engines_on_card_match_cpu(cuda, kind):
    """f32 (TF32 off), seeded random weights, full size, batch 2: the
    outputs within 1e-3 of their largest value of the CPU's, and
    `chip_smoke.py`'s check of the card's decode of the card's maps
    (PoseProposal: equal to the CPU's decode of the same maps bit for bit;
    PAF: peaks equal to the CPU's, `limb_scores` equal to its plain version
    on the card bit for bit and within 1e-6 of the CPU's, the humans within
    1e-5 in coords and 1e-3 in scores). The Lightweight-OpenPose step
    launches `peak_topk` and `limb_scores` once each, the PoseProposal step
    neither."""
    spec, weights, batch = _r18_setup(kind)
    eng = spec.engine(weights, torch.float32, device=cuda, batch=2)
    cpu = spec.engine(weights, torch.float32, device="cpu", batch=2)
    before = (peak_topk.launches, limb_scores.launches)
    eng.infer_batch_device(batch)
    n = 0 if kind == "ppn" else 1
    assert (peak_topk.launches, limb_scores.launches) == (before[0] + n, before[1] + n)
    x = torch.from_numpy(batch).to(torch.float32) / 255.0
    with torch.inference_mode():
        out, ref = eng.model(x.to(cuda)), cpu.model(x)
        for k, v in ref.items():
            if torch.is_tensor(v):
                rel = float((out[k].cpu() - v).abs().max() / v.abs().max())
                assert rel <= 1e-3, (k, rel)
        row = spec.check_decode(eng, out, kind)   # exits non-zero on a mismatch
    if kind == "ppn":
        assert row["decode_equal_to_cpu"]
        assert int(_numpy(spec.decode(eng, out))["valid"].sum()) > 0
    else:
        assert row["limb_scores_equal_to_plain_on_card"]
        assert row["limb_scores_vs_cpu_plain"]["valid"] > 0


@pytest.mark.parametrize("kind,n_convs", [("ppn", 21), ("lw_resnet18", 49)])
def test_resnet18_int8_engines_on_card(cuda, kind, n_convs):
    """int8 with bf16 activations (`quantize_engine` on the batch): a step
    launches `int8_quantize` and `int8_conv` once a conv, and every conv, on
    the card's input, equals its plain version on the card and a CPU copy of
    it (the 7x7 stem folded, add1 / add2 with their bias, the 1485-channel
    PoseProposal head)."""
    spec, weights, batch = _r18_setup(kind)
    eng = quantize_engine(spec.engine(weights, torch.bfloat16, device=cuda, batch=2), [batch])
    assert len(eng.quant_scales) == n_convs
    before = (int8_conv.launches, int8_quantize.launches)
    eng.infer_batch_device(batch)
    assert (int8_conv.launches, int8_quantize.launches) == (before[0] + n_convs,
                                                            before[1] + n_convs)
    x = torch.from_numpy(batch).to(cuda, torch.bfloat16) / 255.0
    with torch.inference_mode():
        seen = _record_int8_inputs(eng.model, lambda: eng.model(x))
        assert len(seen) == n_convs
        _convs_equal_plain(seen, kind)        # both exit non-zero on a mismatch
        assert _convs_card_vs_cpu(seen, kind) == n_convs
    assert 1485 in {c.out_channels for c, _ in seen} or kind != "ppn"


# -- the rest of the OpenPose family and the int8 depthwise conv --------------------------

# channels, kernel, stride, padding, dilation, batch, H, W: 3x3 and 1x1 (and
# 7x7, 49 taps) taps, both strides, dilation 2, channel counts that are not
# multiples of 16 or 32 (Cp 32, 64, 192, 1216), the widths of the family,
# and maps wider than one 64-column tile (108 and 216 columns).
INT8_DWCONV_GRID = [
    (32, 3, 1, 1, 1, 2, 23, 29), (64, 3, 2, 0, 1, 2, 46, 54), (48, 3, 2, 1, 1, 1, 37, 45),
    (512, 3, 1, 2, 2, 1, 23, 29), (19, 1, 1, 0, 1, 2, 9, 11), (185, 3, 1, 1, 1, 2, 13, 17),
    (1209, 3, 1, 1, 1, 1, 11, 13), (1152, 1, 1, 0, 1, 1, 46, 54), (40, 7, 1, 3, 1, 1, 15, 17),
    (16, 3, 2, 1, 2, 2, 21, 19), (1209, 1, 1, 0, 1, 2, 23, 27), (96, 3, 2, 0, 1, 2, 47, 55),
    (144, 3, 1, 1, 1, 1, 30, 108), (32, 3, 1, 1, 1, 1, 40, 216),
]


def _dw_operands(cuda, c, k, stride, pad, dil, b, h, w, dtype, layout, seed=0):
    """(x, inv_s, taps, dq, bias, stride, padding, dilation) of a depthwise
    int8 conv: x [B, C, H, W] normal in `dtype`, channels-last, NCHW
    contiguous, or "shifted": channels 1 .. C of a channels-last tensor of
    C + 1 channels, so that no pixel's run starts on a 16-byte word where
    (C + 1) * itemsize is a multiple of 16, and most start off one
    otherwise; quantized at s_in = 2.5 / 127 (values past 2.5 clip)."""
    rng = np.random.default_rng(seed)
    cp = -(-c // 32) * 32
    extra = int(layout == "shifted")
    x = torch.from_numpy(rng.normal(0, 1, (b, c + extra, h, w)).astype(np.float32)).to(
        cuda, dtype)
    if layout in ("channels_last", "shifted"):
        x = x.contiguous(memory_format=torch.channels_last)[:, extra:]
    wq = np.zeros((k, k, cp), np.int8)
    wq[..., :c] = rng.integers(-127, 128, (k, k, c))
    dq = rng.uniform(1e-5, 1e-3, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    return (x, float(np.float32(127 / 2.5)), t(wq), t(dq), t(bias), (stride, stride),
            (pad, pad), (dil, dil))


@pytest.mark.parametrize("layout", ["channels_last", "nchw", "shifted"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_DWCONV_GRID)
def test_int8_dwconv_matches_plain(cuda, shape, dtype, layout):
    """The fused depthwise kernel (quantize, sums, epilogue) equals its
    plain version (`int8_quantize_plain`, then `int8_dwconv_plain`)
    exactly, with and without a bias, one launch each."""
    args = _dw_operands(cuda, *shape, dtype, layout, seed=sum(shape))
    before = int8_dwconv.launches
    got = int8_dwconv(*args)
    want = int8_dwconv_fused_plain(*args)
    torch.cuda.synchronize()
    assert int8_dwconv.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    no_bias = args[:4] + (None,) + args[5:]
    assert torch.equal(int8_dwconv(*no_bias), int8_dwconv_fused_plain(*no_bias))


def test_int8_dwconv_refuses_what_it_does_not_take(cuda):
    x, inv_s, wq, dq, bias, *geo = _dw_operands(cuda, 40, 3, 1, 1, 1, 1, 8, 8, torch.float32,
                                                "channels_last")
    with pytest.raises(TypeError):
        int8_dwconv(x.to(torch.int8), inv_s, wq, dq, bias, *geo)
    with pytest.raises(TypeError):
        int8_dwconv(x.half(), inv_s, wq, dq, bias, *geo)
    with pytest.raises(TypeError):
        int8_dwconv(x, inv_s, wq.float(), dq, bias, *geo)
    odd = torch.empty(wq.numel() + 1, dtype=torch.int8, device=cuda)[1:].view(wq.shape)
    with pytest.raises(ValueError, match="aligned"):
        int8_dwconv(x, inv_s, odd, dq, bias, *geo)
    with pytest.raises(ValueError, match="different devices"):
        int8_dwconv(x, inv_s, wq.cpu(), dq, bias, *geo)
    with pytest.raises(ValueError):   # C = 40 > Cp = 32
        int8_dwconv(x, inv_s, wq[..., :32].contiguous(), dq, bias, *geo)
    with pytest.raises(ValueError):   # len(dq) != C
        int8_dwconv(x[:, :39], inv_s, wq, dq, bias, *geo)
    big = torch.zeros((9, 9, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="64"):
        int8_dwconv(x, inv_s, big, dq, bias, *geo)
    with pytest.raises(ValueError, match="larger than the padded"):
        int8_dwconv(x, inv_s, wq, dq, bias, (1, 1), (1, 1), (6, 6))


@pytest.mark.parametrize("c,k,stride,dil,dtype", [
    (32, 3, 1, 1, torch.float32), (128, 3, 2, 1, torch.bfloat16),
    (512, 3, 1, 2, torch.bfloat16), (1209, 1, 1, 1, torch.float32)])
def test_depthwise_int8_conv_on_card_equals_cpu(cuda, c, k, stride, dil, dtype):
    """A depthwise Int8Conv2d and channels-last input on the card and on
    the CPU give equal outputs; one forward on the card launches
    `int8_dwconv` once and no quantize pass and no dense conv."""
    rng = np.random.default_rng(c + k)
    kernel = (rng.normal(0, 1, (k, k, 1, c)) / k).astype(np.float32)
    conv = torch.nn.Conv2d(c, c, k, stride=stride, dilation=dil, groups=c, bias=False,
                           padding=dil * (k // 2) if stride == 1 else 0)
    q = Int8Conv2d.from_conv(conv, kernel, None, 2.5)
    assert q.depthwise
    x = torch.from_numpy(rng.normal(0, 1, (2, c, 23, 27)).astype(np.float32)).to(dtype)
    before = int8_quantize.launches, int8_conv.launches, int8_dwconv.launches
    with torch.inference_mode():
        got = q.to(cuda)(x.to(cuda).contiguous(memory_format=torch.channels_last))
        want = q.cpu()(x.contiguous(memory_format=torch.channels_last))
    torch.cuda.synchronize()
    assert (int8_quantize.launches, int8_conv.launches, int8_dwconv.launches) == (
        before[0], before[1], before[2] + 1)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


FAMILY = ["lw_mobilenet", "openpose_vgg19", "mbthin_openpose", "mbsmall_openpose"]


@pytest.mark.parametrize("kind", FAMILY)
def test_family_engines_on_card_match_cpu(cuda, kind):
    """f32 (TF32 off), seeded random weights, full size (OpenPose at
    368x656, MobileNet-Small's 92x108 maps), batch 2, as
    `test_resnet18_engines_on_card_match_cpu`: the outputs within 1e-3 of
    their largest value of the CPU's and the PAF decode's checks; the step
    launches `peak_topk` and `limb_scores` once each."""
    test_resnet18_engines_on_card_match_cpu(cuda, kind)


@pytest.mark.parametrize("kind", FAMILY)
def test_family_int8_engines_on_card(cuda, kind):
    """int8 with bf16 activations: a step launches `int8_quantize` and
    `int8_conv` once a dense conv and `int8_dwconv` once a depthwise one;
    every conv equals its plain version on the card and a CPU copy of it on
    the card's input."""
    spec, weights, batch = _r18_setup(kind)
    eng = quantize_engine(spec.engine(weights, torch.bfloat16, device=cuda, batch=2), [batch])
    assert len(eng.quant_scales) == spec.n_int8
    before = (int8_conv.launches, int8_dwconv.launches, int8_quantize.launches)
    eng.infer_batch_device(batch)
    assert (int8_conv.launches, int8_dwconv.launches, int8_quantize.launches) == (
        before[0] + spec.n_int8 - spec.n_dw, before[1] + spec.n_dw,
        before[2] + spec.n_int8 - spec.n_dw)
    x = torch.from_numpy(batch).to(cuda, torch.bfloat16) / 255.0
    with torch.inference_mode():
        seen = _record_int8_inputs(eng.model, lambda: eng.model(x))
        assert len(seen) == spec.n_int8 and sum(c.depthwise for c, _ in seen) == spec.n_dw
        _convs_equal_plain(seen, kind)        # both exit non-zero on a mismatch
        assert _convs_card_vs_cpu(seen, kind) == spec.n_int8


# -- training: step 1 on the card against the CPU ------------------------------

TRAIN_CASES = {  # name -> (model type, backbone, input, keypoint slots)
    "flagship": ("LightweightOpenpose", "Vggtiny", (64, 80), 19),
    "ppn": ("PoseProposal", "Default", (128, 128), 18),
    "pifpaf": ("Pifpaf", "Default", (64, 64), 17),
}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_step1_on_card_matches_cpu(cuda, tmp_path, name):
    """One f32 training step (TF32 off) of the same flax-initialized trainer
    on the card and on the CPU at a small size, batch 2, on a seeded batch
    (tests/torch_train_cases.py): the loss, every new BatchNorm statistic,
    and the gradients against a float64 step on the card, as
    `chip_smoke.train_step1_vs_cpu` measures them and `check_step1` bounds
    them."""
    from chip_smoke import _train_cfg, check_step1, train_step1_vs_cpu
    from torch_train_cases import bbxs_of, crowd_mask, random_people

    model_type, backbone, hw, n_parts = TRAIN_CASES[name]
    cfg = _train_cfg(model_type, "float32", f"card_test_{name}", backbone, hw=hw, batch=2)
    cfg.model.model_dir = str(tmp_path)
    kpts, valid = random_people(30, 2, 4, n_parts, hw)
    rng = np.random.default_rng(31)
    batch = {"images": rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8), "kpts": kpts,
             "valid": valid, "mask": crowd_mask(2, (cfg.model.hout, cfg.model.wout)),
             "bbxs": bbxs_of(kpts, valid)}
    check_step1(train_step1_vs_cpu(cfg, batch))    # exits non-zero on a mismatch
