"""The port on a CUDA device: each CUDA kernel against its plain PyTorch
version, and the decoder and engine on the card against the port on the CPU.

Every test carries the `gpu` marker and skips without a card. This module
imports no JAX (nor tests/conftest.py's fixtures), so on a machine without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: line_gather exact; peak_topk valid masks exact, xy atol 1e-4, raw
exact, and peak_candidates exact (the kernels repeat the plain versions'
float32 operations in the same order); conv1_pool atol and rtol 1e-4 in f32
(384-term sums in another order) and 1e-2 in bf16 (one bf16 ulp: a sum that
lands near a rounding boundary may round the other way); decode coords atol
1e-5 and human scores atol 1e-3; the engines' coords atol 1e-4 (cuDNN and the
CPU sum the f32 convs in other orders). The grow kernel equals its plain
version exactly (same float32 steps, no FMA contraction, accurate expf);
PifPaf decodes are compared as sets of humans (duplicates of equal score
may take other slots), coords and scores atol 1e-5 for painted fields and
1e-4 behind the f32 network.
"""
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, SYNTH_NPZ, tie_maps
from chip_smoke import (
    TWO_PEOPLE, _numpy, human_deltas, make_synthetic_maps, painted_pifpaf_batch,
)
from hyperpose_torch.models.backbones import VggTinyFusedStem, remap_vggtiny_to_fused
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
from hyperpose_torch.ops import pifpaf_decode as PD
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.conv1_pool import conv1_pool, conv1_pool_plain
from hyperpose_torch.ops.kernels.grow import fused_grow, fused_grow_plain
from hyperpose_torch.ops.kernels.line_gather import line_gather, line_gather_plain
from hyperpose_torch.ops.kernels.peak_topk import (
    peak_candidates, peak_candidates_plain, peak_topk, peak_topk_plain,
)
from hyperpose_torch.ops.paf_decode import PafDecoderConfig, paf_decode_batch
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


@pytest.mark.parametrize("bf16", [True, False])
def test_line_gather_matches_plain(cuda, bf16):
    rng = np.random.default_rng(5)
    b, l, h, w, m = 2, 19, 46, 54, 2560
    planes = torch.from_numpy(
        rng.standard_normal((b, l, 2, h, w)).astype(np.float32)).to(cuda)
    ly = torch.from_numpy(rng.integers(-2, h + 2, (b, l, m)).astype(np.int32)).to(cuda)
    lx = torch.from_numpy(rng.integers(-2, w + 2, (b, l, m)).astype(np.int32)).to(cuda)
    before = line_gather.launches
    got = line_gather(planes, ly, lx, bf16)
    want = line_gather_plain(planes, ly, lx, bf16)
    torch.cuda.synchronize()
    assert line_gather.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_topk_matches_plain(cuda, border, maps):
    full = torch.from_numpy(_peak_maps(maps)).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    before = peak_topk.launches
    got = peak_topk(conf, 16, 5, 0.75, 0.05, border)
    want = peak_topk_plain(conf, 16, 5, 0.75, 0.05, border)
    torch.cuda.synchronize()
    assert peak_topk.launches == before + 1
    assert torch.equal(got[2] > -5e29, want[2] > -5e29)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_candidates_match_plain(cuda, maps):
    full = torch.from_numpy(_peak_maps(maps)).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    before = peak_candidates.launches
    got = peak_candidates(conf, 5, 0.75, 0.05, -1e30)
    want = peak_candidates_plain(conf, 5, 0.75, 0.05, -1e30)
    torch.cuda.synchronize()
    assert peak_candidates.launches == before + 1
    assert torch.equal(got[0] > -5e29, want[0] > -5e29)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _btp(cuda, dtype, shape=(2, 24, 40, 128), seed=6):
    """A conv0p-like output [B, H, Q, 128] read through channels-last
    strides, with weights and bias."""
    rng = np.random.default_rng(seed)
    b, h, q, c = shape
    nchw = torch.from_numpy(rng.normal(0, 1, (b, c, h, q)).astype(np.float32))
    nchw = nchw.to(cuda, dtype).contiguous(memory_format=torch.channels_last)
    w1p = torch.from_numpy(rng.normal(0, 0.1, (3, 128, 128)).astype(np.float32))
    b1p = torch.from_numpy(rng.normal(0, 0.1, (128,)).astype(np.float32))
    return nchw.permute(0, 2, 3, 1), w1p.to(cuda, dtype), b1p.to(cuda)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(2, 24, 40, 128), (1, 2, 1, 128), (1, 6, 33, 128)])
def test_conv1_pool_matches_plain(cuda, dtype, tol, shape):
    """Edge tiles included: Q = 1 (both border masks on one pair) and a
    Q that leaves a partial tile of pairs."""
    btp, w1p, b1p = _btp(cuda, dtype, shape)
    before = conv1_pool.launches
    got = conv1_pool(btp, w1p, b1p)
    want = conv1_pool_plain(btp, w1p, b1p)
    torch.cuda.synchronize()
    assert conv1_pool.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[1] // 2, shape[2], 64)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


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
    with pytest.raises(TypeError):
        peak_topk(conf.double())
    planes = torch.zeros(1, 1, 2, 4, 4, device=cuda)
    idx = torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        line_gather(planes.double(), idx, idx)
    with pytest.raises(TypeError):
        line_gather(planes, idx.long(), idx)


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
        eng = PoseEngine(LightWeightOpenPose(), FLAGSHIP_NPZ, input_hw=(184, 216),
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


# -- PifPaf: the grow kernel, the decoder and the engine ------------------------

def _tie_tables(cuda, b=2, mh=8, k=128, seed=3):
    """Growth inputs on a coarse integer grid: many candidates at exactly
    equal distances and scores, so best and second best tie often."""
    rng = np.random.default_rng(seed)
    limbs = np.asarray(PIFPAF_TOPOLOGY.limbs)
    e_src = tuple(int(v) for v in np.concatenate([limbs[:, 0], limbs[:, 1]]))
    e_dst = tuple(int(v) for v in np.concatenate([limbs[:, 1], limbs[:, 0]]))
    e = len(e_src)
    grid = lambda *s: rng.integers(0, 12, s).astype(np.float32)  # noqa: E731
    tables = [grid(b, e, k), grid(b, e, k),
              rng.choice([0.0, 0.5, 1.0], (b, e, k)).astype(np.float32),
              grid(b, e, k), grid(b, e, k),
              rng.integers(2, 5, (b, e, k)).astype(np.float32)]
    tables = [torch.from_numpy(t).to(cuda) for t in tables]
    rev = torch.tensor((np.arange(e) + e // 2) % e, device=cuda)
    seed_part = torch.from_numpy(rng.integers(0, 17, (b, mh)).astype(np.int32)).to(cuda)
    vals = np.stack([grid(b, mh), grid(b, mh), rng.integers(2, 5, (b, mh)),
                     np.full((b, mh), 0.5)], axis=-1).astype(np.float32)
    return (seed_part, torch.from_numpy(vals).to(cuda), tuple(tables),
            tuple(t[:, rev] for t in tables), e_src, e_dst, 17, 8, True)


def _grow_args(cuda, case):
    if case == "ties":
        return _tie_tables(cuda)
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


@pytest.mark.parametrize("case", ["painted", "dense_random", "ties"])
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
        assert g.shape == w.shape == (args[0].shape[0], args[0].shape[1], 17)
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
