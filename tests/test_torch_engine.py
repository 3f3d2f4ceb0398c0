"""The port's PoseEngine (device="cpu") against the JAX PoseEngine: on the
trained flagship weights, and for PifPaf (`fused_decode`) on seeded random
weights at a small input.

Tolerances: valid and part_valid exact, coords atol 1e-5, human scores atol
1e-3 (about 20 float32 conv layers and the decoder's sums, reassociated);
PifPaf coords and scores atol 1e-4 (53 float32 conv layers, then the
decoder), compared as sets of humans (see test_torch_pifpaf_decode.py).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pifpaf_decode import assert_same_humans
from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest, synth_frame_rgb
from hyperpose_tpu.models.backbones import VggTiny as JaxVggTiny
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_tpu.train.checkpoint import load_npz_tree
from hyperpose_torch.models.backbones import VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.grow import fused_grow
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

HW = (368, 432)
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _jax_engine(hw, **kw):
    model = JaxLwOpenPose(backbone=JaxVggTiny, dtype=jnp.float32)
    return JaxPoseEngine(model, load_npz_tree(FLAGSHIP_NPZ), input_hw=hw,
                         max_batch_size=1, **kw)


def _port_engine(hw, **kw):
    return PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=hw,
                      max_batch_size=1, device="cpu", **kw)


def _assert_same(want, got):
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.part_valid, want.part_valid)
    np.testing.assert_allclose(got.coords, want.coords, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-3)


class _Arrays:
    def __init__(self, obj):
        for f in FIELDS:
            setattr(self, f, np.asarray(getattr(obj, f)))


@pytest.fixture(scope="module")
def flagship_run():
    """Both engines on the synthetic frame at 368x432: inference() and the
    raw step on the resized batch."""
    frame = synth_frame_rgb()
    batch = resize_bilinear(frame, HW)[None]
    jeng = _jax_engine(HW)
    teng = _port_engine(HW)
    j_humans = jeng.inference([frame])[0]
    t_humans = teng.inference([frame])[0]
    j_step = _Arrays(jeng.infer_batch_device(jnp.asarray(batch)))
    packed = teng._step_packed(torch.from_numpy(batch)).numpy()
    return jeng, teng, j_humans, t_humans, j_step, packed


def test_inference_finds_the_two_people(flagship_run):
    _, _, j_humans, t_humans, _, _ = flagship_run
    assert len(j_humans) == len(t_humans) == 2
    np.testing.assert_allclose([h.score for h in t_humans],
                               [h.score for h in j_humans], rtol=0, atol=1e-3)
    np.testing.assert_allclose([h.score for h in t_humans], [17.0187, 8.584],
                               rtol=0, atol=1e-3)
    assert [h.n_parts for h in t_humans] == [h.n_parts for h in j_humans]
    for tj, th in zip(j_humans, t_humans):
        for p, part in tj.parts.items():
            assert (th.parts[p].x, th.parts[p].y) == pytest.approx(
                (part.x, part.y), abs=1e-5)


def test_step_matches_jax_through_the_packed_layout(flagship_run):
    """The port's packed step, unpacked by the port and by the JAX engine
    (same layout), equals the JAX step."""
    jeng, teng, _, _, j_step, packed = flagship_run
    assert packed.dtype == np.float32 and packed.shape == (1, 32 * 18 * 4 + 2 * 32)
    got = teng.unpack_skeletons(packed)
    via_jax = jeng.unpack_skeletons(packed)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(via_jax, f))
    _assert_same(j_step, got)


def test_packed_equals_step():
    eng = _port_engine((96, 112))
    x = torch.from_numpy(
        resize_bilinear(synth_frame_rgb(), (96, 112))[None])
    d = eng._step(x)
    sk = eng.unpack_skeletons(eng._step_packed(x).numpy())
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sk, f), getattr(d, f).numpy())


def test_yuv420_infeed_matches_jax():
    hw = (184, 216)
    frame = resize_bilinear(synth_frame_rgb(), hw)
    jeng = _jax_engine(hw, input_format="yuv420")
    teng = _port_engine(hw, input_format="yuv420")
    assert teng.input_batch_shape() == jeng.input_batch_shape() == (1, 276, 216)
    yuv = teng.encode_input(frame)[None]
    want = _Arrays(jeng.infer_batch_device(jnp.asarray(yuv)))
    got = _Arrays(teng.infer_batch_device(yuv))
    _assert_same(want, got)


def test_warmup_and_stats():
    eng = _port_engine((64, 72))
    assert eng.warmup() > 0
    assert (eng._out_mh, eng._out_p) == (32, 18)
    frame = np.random.default_rng(0).integers(0, 256, (50, 60, 3), np.uint8)
    assert len(eng.inference([frame])) == 1
    assert eng.stats.frames == 1 and eng.stats.fps > 0


def test_tracing_scopes_the_host_path():
    from hyperpose_torch.utils import tracing

    eng = _port_engine((64, 72))
    tracing.reset()
    tracing.enable()
    try:
        eng.inference([np.zeros((64, 72, 3), np.uint8)])
    finally:
        tracing.enable(False)
    rep = tracing.report()
    assert set(rep) == {"engine/preprocess", "engine/device_step", "engine/step",
                        "engine/network", "engine/decode"}
    assert all(r["count"] == 1 and r["total_s"] > 0 for r in rep.values())
    tracing.reset()
    eng.inference([np.zeros((64, 72, 3), np.uint8)])
    assert tracing.report() == {}


def test_letterbox_inference_runs():
    eng = _port_engine((96, 112), keep_ratio=True)
    res = eng.inference([synth_frame_rgb()])
    assert len(res) == 1


def test_entry_points_default_to_cuda():
    assert inspect.signature(PoseEngine).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            PoseEngine(LightWeightOpenPose(backbone=VggTiny), max_batch_size=1)


def test_rejected_arguments(tmp_path):
    with pytest.raises(ValueError):
        _port_engine((64, 72), input_format="bogus")
    with pytest.raises(ValueError):
        _port_engine((66, 72), input_format="yuv420")
    with pytest.raises(ValueError):
        _port_engine((64, 72)).inference([np.zeros((8, 8, 3), np.uint8)] * 2)
    with pytest.raises(ValueError, match="float32"):   # bf16 weights, no checkpoint
        PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), None, input_hw=(64, 72),
                   max_batch_size=1, device="cpu", quant_scales={"cpm/init": 1.0})
    with pytest.raises(FileNotFoundError):   # save / load: tests/test_torch_export.py
        PoseEngine.load_executable(str(tmp_path / "missing.pt2"))


def test_quant_scales_swap_every_calibrated_conv():
    """`quant_scales` (JAX `PoseEngine(quant_scales=...)`): every conv with
    a scale runs in int8, the engine keeps the table and its float32
    weights, and the step decodes on the CPU through the int8 kernels'
    plain versions (no launch)."""
    from hyperpose_torch import quant
    from hyperpose_torch.ops.kernels.int8_gemm import int8_conv, int8_quantize

    x = torch.from_numpy(resize_bilinear(synth_frame_rgb(), (64, 72))[None])
    scales = quant.calibrate(LightWeightOpenPose(backbone=VggTiny).eval(), [x.float() / 255.0])
    scales = {k: v for k, v in scales.items() if k != "ref_heads/paf2"}
    eng = _port_engine((64, 72), quant_scales=scales)
    convs = {n: type(m) for n, m in eng.model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, quant.Int8Conv2d))}
    assert len(convs) == 40 and eng.quant_scales == scales
    assert convs.pop("ref_heads.paf2") is torch.nn.Conv2d
    assert all(t is quant.Int8Conv2d for t in convs.values())
    assert sorted(eng.variables) == sorted(flagship_flat())
    before = int8_conv.launches, int8_quantize.launches
    d = eng.infer_batch_device(x.numpy())
    assert (int8_conv.launches, int8_quantize.launches) == before
    assert d.coords.shape == (1, 32, 18, 2)


# -- PifPaf through fused_decode -------------------------------------------------

PIFPAF_HW = (64, 96)    # fields 8x12, stride 8


@pytest.fixture(scope="module")
def pifpaf_run():
    """The JAX engine built by `_fused_decode_for` and the port's engine on
    `pifpaf_fused_decode`, with the same random weights, on one batch of
    two frames (packed step and inference)."""
    from hyperpose_tpu import config as Config
    from hyperpose_tpu import models as Model

    flat = random_flax_weights(Pifpaf(), seed=11)
    Config.reset()
    try:
        Config.set_model_type(Config.MODEL.Pifpaf)
        Config.set_compute_dtype("float32")
        Config.set_model_inout(hin=PIFPAF_HW[0], win=PIFPAF_HW[1],
                               hout=PIFPAF_HW[0] // 8, wout=PIFPAF_HW[1] // 8)
        cfg = Config.get_config(create_dirs=False)
        jmodel = Model.get_model(cfg)
        jeng = JaxPoseEngine(jmodel, nest(flat), input_hw=PIFPAF_HW,
                             max_batch_size=2, topology=Model.get_topology(cfg),
                             fused_decode=Model._fused_decode_for(cfg, jmodel))
    finally:
        Config.reset()
    model = Pifpaf()
    teng = PoseEngine(model, flat, input_hw=PIFPAF_HW, max_batch_size=2,
                      topology=PIFPAF_TOPOLOGY, device="cpu",
                      fused_decode=pifpaf_fused_decode(model))
    rng = np.random.default_rng(12)
    frames = [resize_bilinear(synth_frame_rgb(), PIFPAF_HW),
              rng.integers(0, 256, (*PIFPAF_HW, 3), dtype=np.uint8)]
    batch = np.stack(frames)
    want = _Arrays(jeng.infer_batch_device(jnp.asarray(batch)))
    return jeng, teng, frames, batch, want


def test_pifpaf_engine_matches_jax(pifpaf_run):
    _, teng, _, batch, want = pifpaf_run
    before = fused_grow.launches
    got = _Arrays(teng.infer_batch_device(batch))
    assert fused_grow.launches == before          # the CPU runs the plain version
    assert got.coords.shape == (2, 32, 17, 2)
    assert int(got.valid.sum()) > 0, "degenerate decode"
    assert_same_humans(vars(got), vars(want))


def test_pifpaf_unpack_needs_warmup(pifpaf_run):
    """The packed layout of a fused-decode engine is known only from its
    step: before warmup() unpacking raises (the PAF sizes would mis-slice
    17 parts); after it the port's and the JAX engine's unpacking agree."""
    jeng, teng, _, batch, want = pifpaf_run
    packed = teng._step_packed(torch.from_numpy(batch)).numpy()
    assert packed.shape == (2, 32 * 17 * 4 + 2 * 32)
    fresh = PoseEngine(Pifpaf(), None, input_hw=PIFPAF_HW, max_batch_size=2,
                       device="cpu", fused_decode=lambda x: None)
    with pytest.raises(RuntimeError, match="warmup"):
        fresh.unpack_skeletons(packed)
    assert teng.warmup() > 0
    assert (teng._out_mh, teng._out_p) == (32, 17)
    jeng.warmup()
    got = teng.unpack_skeletons(packed)
    via_jax = jeng.unpack_skeletons(packed)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(via_jax, f))
    assert_same_humans(vars(_Arrays(got)), vars(want))


def test_pifpaf_inference_matches_the_step(pifpaf_run):
    _, teng, frames, batch, _ = pifpaf_run
    humans = teng.inference(frames)
    d = teng.infer_batch_device(batch)
    for i, hs in enumerate(humans):
        assert len(hs) == int(d.valid[i].sum())
        assert all(h.n_parts >= 4 for h in hs)


def test_pifpaf_yuv420_infeed():
    """The I420 infeed reconstructs RGB, rounds it to uint8 and runs the
    fused step on it, as the JAX engine does."""
    flat = random_flax_weights(Pifpaf(), seed=13)
    model = Pifpaf()
    eng = PoseEngine(model, flat, input_hw=PIFPAF_HW, max_batch_size=1,
                     device="cpu", input_format="yuv420",
                     fused_decode=pifpaf_fused_decode(model))
    frame = resize_bilinear(synth_frame_rgb(), PIFPAF_HW)
    yuv = eng.encode_input(frame)[None]
    from hyperpose_torch.ops.image import yuv420_to_rgb

    rgb = (yuv420_to_rgb(torch.from_numpy(yuv)) + 0.5).to(torch.uint8)
    want = pifpaf_fused_decode(model)(rgb)
    got = eng.infer_batch_device(yuv)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
