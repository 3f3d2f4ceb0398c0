"""The port's PoseProposal (`models/pose_proposal.py`, `ops/ppn_decode.py`)
against the JAX package on the CPU: the network on seeded random weights,
`restore_coor`, the decoder on the same maps, the fused engine step, and
int8.

Tolerances: network outputs within 1e-4 x each output's max |value| (about
20 float32 conv layers summed in other orders; measured about 1.5e-6);
`restore_coor` and the decoder bit-exact on the same maps (every field,
filler slots included: the port rounds in XLA's order, ranks with a stable
sort and takes first maxima); against the golden oracle, the tolerances of
tests/test_ppn.py (same humans and part sets, coords within 1e-3 pixels,
part scores within 1e-4); the fused engines on the same frames, flags equal
and coords and scores within 1e-5 (the maps differ in the last places);
calibration tables within 1e-5 relative; each int8 conv bit-exact on the
input JAX gave it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import PPN_HW, dense_ppn_maps, painted_ppn_batch
from golden_ppn import golden_decode
from test_ppn import sparse_random_predict
from test_torch_pifpaf import _assert_close, _flax_shapes
from test_torch_pifpaf_decode import assert_same_humans
from test_torch_quant import assert_convs_exact_on_jax_inputs, jax_int8_convs
from torch_parity import nest, synth_frame_rgb
from hyperpose_tpu import quant as jquant
from hyperpose_tpu.models.backbones import Resnet18 as JaxResnet18
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_tpu.models.pose_proposal import PoseProposal as JaxPoseProposal
from hyperpose_tpu.ops.ppn_decode import PpnDecoderConfig as JaxPpnConfig
from hyperpose_tpu.ops.ppn_decode import ppn_decode_batch as jax_ppn_decode
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_tpu.utils.topology import PPN_LIMBS as JAX_PPN_LIMBS
from hyperpose_tpu.utils.topology import PPN_TOPOLOGY as JAX_PPN_TOPOLOGY
from hyperpose_torch import quant
from hyperpose_torch.models.backbones import Resnet18
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pose_proposal import PoseProposal, ppn_fused_decode
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.int8_gemm import int8_conv
from hyperpose_torch.ops.ppn_decode import PpnDecoderConfig, ppn_decode_batch
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.topology import PPN_TOPOLOGY
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

HW = (128, 160)          # a 4x5 grid of 32-pixel cells
GRID = (HW[0] // 32, HW[1] // 32)
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")
MAPS = "cixywh"


def _flat(seed=0):
    return random_flax_weights(_flax_shapes(JaxPoseProposal(hin=HW[0], win=HW[1]), HW), seed)


def _frames(seed, n=2, hw=HW):
    rng = np.random.default_rng(seed)
    return np.stack([resize_bilinear(synth_frame_rgb(), hw)]
                    + [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n - 1)])


def _jax_arrays(d):
    return {f: np.asarray(getattr(d, f)) for f in FIELDS}


def _port_arrays(d):
    return {f: getattr(d, f).numpy() for f in FIELDS}


def _assert_equal_decodes(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


# -- the network ---------------------------------------------------------------------

def test_pose_proposal_matches_jax():
    """Every output, `e`'s layout [B, L, hnei, wnei, hout, wout] included."""
    jm = JaxPoseProposal(hin=HW[0], win=HW[1])
    flat = _flat()
    x = np.random.default_rng(1).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    want = jm.apply(nest(flat), jnp.asarray(x), train=False)
    model = load_flax_weights(PoseProposal(hin=HW[0], win=HW[1]), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for k in MAPS + "e":
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape == ((2, 17, 9, 9, *GRID) if k == "e"
                                                  else (2, *GRID, 18)), k
        assert got[k].dtype == torch.float32
        _assert_close(got[k].numpy(), w, k)


@pytest.mark.parametrize("channels_last", [False, True])
def test_outputs_are_views_of_the_head(channels_last):
    """The maps and `e` share the head's storage in either memory layout:
    no transposing copy of the 1485-channel output."""
    model = PoseProposal(hin=HW[0], win=HW[1]).eval()
    x = torch.rand(2, *HW, 3)
    if channels_last:
        model = model.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        out = model(x)
    storage = out["e"].untyped_storage()
    assert all(out[k].untyped_storage().data_ptr() == storage.data_ptr() for k in MAPS)
    assert storage.nbytes() == 4 * 2 * (6 * 18 + 81 * 17) * GRID[0] * GRID[1]


@pytest.mark.parametrize("grid,in_hw", [((4, 5), (128, 160)), ((12, 12), (384, 384)),
                                        ((7, 13), (384, 416))])
def test_restore_coor_is_bit_exact(grid, in_hw):
    """(x + gx) * (win / wout) in float32, the scale formed in Python: also
    where win / wout is no power of two."""
    rng = np.random.default_rng(grid[0])
    maps = [rng.uniform(0, 1, (2, *grid, 18)).astype(np.float32) for _ in range(4)]
    jm = JaxPoseProposal(hin=in_hw[0], win=in_hw[1])
    want = jm.restore_coor(*map(jnp.asarray, maps), *grid)
    got = PoseProposal(hin=in_hw[0], win=in_hw[1]).restore_coor(
        *map(torch.from_numpy, maps), *grid)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the decoder ----------------------------------------------------------------------

def _sparse_batch():
    preds = [sparse_random_predict(s) for s in range(8)]
    out = {k: np.stack([p[k] for p in preds]) for k in preds[0]}
    out["i"] = out["c"]
    return out


DECODE_CASES = {
    "sparse_seeds_0_7": _sparse_batch,
    "painted": painted_ppn_batch,
    "dense": lambda: dense_ppn_maps(5),
    "ties": lambda: dense_ppn_maps(6, levels=(0.1, 0.5, 0.5, 0.75)),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_jax(case):
    """`ppn_decode_batch` against JAX's on the same maps, bit for bit. The
    ties case has equal c in many cells of every part (top-K and the NMS
    order decide) and equal match values (the first argmax decides)."""
    pred = DECODE_CASES[case]()
    want = _jax_arrays(jax_ppn_decode(pred, JaxPpnConfig(), 9, 9, PPN_HW, JAX_PPN_TOPOLOGY))
    got = _port_arrays(ppn_decode_batch(pred, PpnDecoderConfig(), 9, 9, PPN_HW, PPN_TOPOLOGY))
    _assert_equal_decodes(got, want)
    if case == "painted":
        assert (got["valid"].sum(axis=1) == 2).all()
        assert got["part_valid"][:, :2].all()
    if case in ("dense", "ties"):
        assert got["valid"].sum() > 0


def _humans(d, i, in_hw):
    out = []
    for h in np.nonzero(d["valid"][i])[0]:
        out.append({int(p): (float(d["coords"][i, h, p, 0] * in_hw[1]),
                             float(d["coords"][i, h, p, 1] * in_hw[0]),
                             float(d["part_scores"][i, h, p]))
                    for p in np.nonzero(d["part_valid"][i, h])[0]})
    return out


@pytest.mark.parametrize("case", ["sparse_seeds_0_7", "painted"])
def test_decode_matches_golden(case):
    """Against the sequential oracle (reference processor.py:65-204), with
    tests/test_ppn.py's tolerances."""
    pred = DECODE_CASES[case]()
    got = _port_arrays(ppn_decode_batch(pred))
    n_humans = 0
    for i in range(pred["c"].shape[0]):
        gold = golden_decode(*(pred[k][i] for k in ("c", "x", "y", "w", "h", "e")),
                             np.asarray(JAX_PPN_LIMBS))
        mine = _humans(got, i, PPN_HW)
        assert len(mine) == len(gold)
        n_humans += len(gold)
        for gh in gold:
            best = min(mine, key=lambda dh: sum(abs(dh.get(p, (1e9,))[0] - gh[p][0])
                                                for p in gh))
            assert sorted(best) == sorted(gh)
            for p, (gx, gy, gs) in gh.items():
                assert abs(best[p][0] - gx) < 1e-3 and abs(best[p][1] - gy) < 1e-3
                assert abs(best[p][2] - gs) < 1e-4
    assert case != "painted" or n_humans == 16


def test_decode_empty():
    pred = {k: np.zeros((1, 12, 12, 18), np.float32) for k in MAPS}
    pred["e"] = np.zeros((1, 17, 9, 9, 12, 12), np.float32)
    d = ppn_decode_batch(pred)
    assert not d.valid.any() and not d.part_valid.any()
    assert tuple(d.coords.shape) == (1, 16, 18, 2)
    assert not d.coords.any() and not d.scores.any()


# -- the fused engine step --------------------------------------------------------------

def _jax_ppn_engine(flat, hw, batch, dtype="float32"):
    from hyperpose_tpu import config as Config
    from hyperpose_tpu import models as Model

    Config.reset()
    try:
        Config.set_model_type(Config.MODEL.PoseProposal)
        Config.set_compute_dtype(dtype)
        Config.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // 32, wout=hw[1] // 32)
        cfg = Config.get_config(create_dirs=False)
        jmodel = Model.get_model(cfg)
        return JaxPoseEngine(jmodel, nest(flat), input_hw=hw, max_batch_size=batch,
                             topology=Model.get_topology(cfg),
                             fused_decode=Model._fused_decode_for(cfg, jmodel))
    finally:
        Config.reset()


def _port_ppn_engine(flat, hw=HW, batch=2):
    model = PoseProposal(hin=hw[0], win=hw[1])
    return PoseEngine(model, flat, input_hw=hw, max_batch_size=batch, device="cpu",
                      topology=PPN_TOPOLOGY, fused_decode=ppn_fused_decode(model))


@pytest.fixture(scope="module")
def ppn_run():
    flat = _flat(seed=7)
    frames = _frames(8)
    jeng = _jax_ppn_engine(flat, HW, 2)
    teng = _port_ppn_engine(flat)
    want = _jax_arrays(jeng.infer_batch_device(jnp.asarray(frames)))
    return flat, jeng, teng, frames, want


def test_engine_matches_jax_fused_step(ppn_run):
    """`PoseEngine` on `ppn_fused_decode` against the JAX engine on
    `_fused_decode_for`'s PPN step (models/__init__.py:258-271), the same
    weights and frames. Random weights put every cell's sigmoid near 0.5,
    so the decode fills its proposals: the worst case, not an empty one."""
    _, _, teng, frames, want = ppn_run
    got = _port_arrays(teng.infer_batch_device(frames))
    assert got["coords"].shape == (2, 16, 18, 2)
    assert got["valid"].sum() > 0, "degenerate decode"
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["part_valid"], want["part_valid"])
    for f in ("coords", "part_scores", "scores"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5, err_msg=f)


def test_engine_inference_and_packed_path(ppn_run):
    """`inference` returns the step's humans with the PPN topology's 18
    parts; after `warmup` the packed step unpacks as the JAX engine
    unpacks it."""
    _, jeng, teng, frames, want = ppn_run
    humans = teng.inference(list(frames))
    for i, hs in enumerate(humans):
        assert len(hs) == int(want["valid"][i].sum())
        assert all(4 <= h.n_parts <= 18 for h in hs)
    teng.warmup()
    jeng.warmup()
    assert (teng._out_mh, teng._out_p) == (16, 18)
    packed = teng._step_packed(torch.from_numpy(frames)).numpy()
    got, via_jax = teng.unpack_skeletons(packed), jeng.unpack_skeletons(packed)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(via_jax, f))
    assert_same_humans({f: getattr(got, f) for f in FIELDS}, want, atol=1e-5)


# -- int8 ----------------------------------------------------------------------------

def _n_int8(model):
    return sum(isinstance(m, quant.Int8Conv2d) for m in model.modules())


@pytest.mark.parametrize("name", ["ppn", "lw_resnet18"])
def test_calibrate_covers_all_convs_as_jax_does(name):
    """21 convs in the PPN network (18 in the trunk, add1, add2, head), 49 in
    Lightweight-OpenPose on Resnet18 (18 + 31)."""
    if name == "ppn":
        jm, model, n = JaxPoseProposal(hin=HW[0], win=HW[1]), PoseProposal(hin=HW[0], win=HW[1]), 21
    else:
        jm, model, n = JaxLwOpenPose(backbone=JaxResnet18), LightWeightOpenPose(backbone=Resnet18), 49
    flat = random_flax_weights(_flax_shapes(jm, HW), seed=9)
    load_flax_weights(model, flat).eval()
    x = _frames(10).astype(np.float32) / 255.0
    want = jquant.calibrate(jm, nest(flat), [jnp.asarray(x)], train=False)
    got = quant.calibrate(model, [torch.from_numpy(x)])
    assert len(got) == sum(isinstance(m, torch.nn.Conv2d) for m in model.modules()) == n
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-5, atol=0)


def test_int8_ppn_convs_exact_on_jax_captured_inputs():
    """Each of the 21 int8 convs of the PPN network (the 7x7 stride-2 stem on
    the tap-folding route, the strided 3x3 and 1x1 convs, add1 and add2 with
    their conv bias, the 1485-channel head) on the input JAX's
    `quantized_apply` gave it: JAX's output bit for bit."""
    jm = JaxPoseProposal(hin=HW[0], win=HW[1])
    flat = _flat(seed=11)
    x = _frames(12).astype(np.float32) / 255.0
    scales = jquant.calibrate(jm, nest(flat), [jnp.asarray(x)], train=False)
    seen = jax_int8_convs(jm, nest(flat), x, scales)
    assert len(seen) == 21
    model = load_flax_weights(PoseProposal(hin=HW[0], win=HW[1]), flat).eval()
    quant.quantize_model(model, scales, weights=flat)
    assert _n_int8(model) == 21
    assert model.backbone.stem.conv.folded and model.head.out_channels == 1485
    assert model.add1.conv.bias is not None
    assert_convs_exact_on_jax_inputs(model, seen)


def test_quantize_engine_rebuilds_the_ppn_step(ppn_run):
    """`quantize_engine` on a PPN engine makes its int8 clone through
    `ppn_fused_decode.rebuild`: the clone's step runs 21 Int8Conv2d (their
    plain versions on the CPU, no launch), the original keeps its float
    convs and outputs, and the clone's decode is the port's own decode of
    its int8 maps."""
    flat, _, teng, frames, _ = ppn_run
    before = _port_arrays(teng.infer_batch_device(frames))
    tq = quant.quantize_engine(teng, [frames])
    assert len(tq.quant_scales) == _n_int8(tq.model) == 21 and _n_int8(teng.model) == 0
    assert tq.fused_decode is not teng.fused_decode
    launches = int8_conv.launches
    got = _port_arrays(tq.infer_batch_device(frames))
    assert int8_conv.launches == launches
    with torch.inference_mode():
        out = tq.model(torch.from_numpy(frames).to(torch.float32) / 255.0)
        rx, ry, rw, rh = tq.model.restore_coor(out["x"], out["y"], out["w"], out["h"], *GRID)
        own = _port_arrays(ppn_decode_batch(
            {"c": out["c"], "x": rx, "y": ry, "w": rw, "h": rh, "e": out["e"]},
            PpnDecoderConfig(), 9, 9, HW, PPN_TOPOLOGY))
    _assert_equal_decodes(got, own)
    _assert_equal_decodes(_port_arrays(teng.infer_batch_device(frames)), before)
