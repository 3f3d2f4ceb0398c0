"""int8 serving engines: the port's `quant.quantize_engine` and
`PoseEngine(quant_scales=...)` (device="cpu") against the JAX package's on the
same weights and frames.

Tolerances: scale tables within 1e-5 relative (float32 activations summed in
another order). Each int8 conv is bit-exact, but a last-place difference in
the float ops between them (BatchNorm's formula, another device) flips an
int8 rounding now and then, and the flips grow through the network until
two int8 runs differ about as much as int8 and float do (4-8% of the maps'
range; measured by perturbing the BatchNorm scales by 1-2 ulp): a part near
the threshold may come or go, a weak human may appear. So decodes are
compared person by person (`chip_smoke.find_people`: each reference person
found with at least half its parts, at the same places within 0.01 of the
image size, `chip_smoke.INT8_TOL`), and PifPaf's int8 fields within 0.1 of
their largest value (see the test).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import INT8_TOL, find_people
from test_torch_engine import _Arrays, _jax_engine, _port_engine
from torch_parity import FLAGSHIP_NPZ, nest, synth_frame_rgb
from hyperpose_tpu import quant as jquant
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_torch import quant
from hyperpose_torch.models.backbones import VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf, pifpaf_fused_decode
from hyperpose_torch.ops import pifpaf_decode as PD
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.human import SkeletonBatch
from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

HW = (96, 112)
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _frames(hw, seed):
    rng = np.random.default_rng(seed)
    return np.stack([resize_bilinear(synth_frame_rgb(), hw),
                     rng.integers(0, 256, (*hw, 3), dtype=np.uint8)])


def _humans(decoded):
    """Per image, the Human list of a decode (either package's arrays)."""
    sk = SkeletonBatch(*(np.asarray(getattr(decoded, f)) for f in FIELDS))
    return [sk.to_humans(i) for i in range(sk.coords.shape[0])]


def _n_int8(model):
    return sum(isinstance(m, quant.Int8Conv2d) for m in model.modules())


def _assert_scales_close(got, want):
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-5, atol=0)


def test_quantize_engine_matches_jax_flagship():
    frames = _frames(HW, 3)
    jeng = _jax_engine(HW)
    teng = _port_engine(HW)
    before = _Arrays(teng.infer_batch_device(frames))
    jq = jquant.quantize_engine(jeng, [frames])
    tq = quant.quantize_engine(teng, [frames])
    _assert_scales_close(tq.quant_scales, jq.quant_scales)
    assert _n_int8(tq.model) == len(tq.quant_scales) == 40
    want = _humans(jq.infer_batch_device(jnp.asarray(frames)))
    got = _humans(tq.infer_batch_device(frames))
    assert sum(map(len, want)) > 0
    for w, g in zip(want, got):
        found = find_people(w, g)
        assert found is not None and found <= INT8_TOL["xy"]
    # The original engine is untouched: float convs, the same outputs.
    assert _n_int8(teng.model) == 0 and teng.quant_scales is None
    after = _Arrays(teng.infer_batch_device(frames))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(after, f), getattr(before, f))


def _jax_pifpaf_engine(flat, hw, batch):
    from hyperpose_tpu import config as Config
    from hyperpose_tpu import models as Model

    Config.reset()
    try:
        Config.set_model_type(Config.MODEL.Pifpaf)
        Config.set_compute_dtype("float32")
        Config.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // 8, wout=hw[1] // 8)
        cfg = Config.get_config(create_dirs=False)
        jmodel = Model.get_model(cfg)
        return JaxPoseEngine(jmodel, nest(flat), input_hw=hw, max_batch_size=batch,
                             topology=Model.get_topology(cfg),
                             fused_decode=Model._fused_decode_for(cfg, jmodel))
    finally:
        Config.reset()


def test_quantize_engine_matches_jax_pifpaf():
    """The int8 PifPaf engine rebuilds its fused step on the clone: the
    clone's step runs the int8 convs, the original's the float ones.

    JAX's `quantize_engine` cannot calibrate through the jitted PifPaf step
    (its observer reads a tracer: ROADMAP Queue 3), so JAX's table comes
    from `calibrate` on the model with the step's own /255 input. On these
    random weights a first flipped int8 rounding (float noise of 1e-7 in a
    BatchNorm, 5 convs in) grows through the 55 int8 convs until the two
    packages' int8 fields differ as much as int8 and float do (measured max
    |d| / max |v| 0.050 against 0.046 to 0.056), and their decodes differ
    with them; so the fields are held within 0.1 of their largest value and
    the engine's decode against the port's own decode of its int8 fields."""
    hw = (64, 96)
    flat = random_flax_weights(Pifpaf(), seed=11)
    frames = _frames(hw, 12)
    model = Pifpaf()
    teng = PoseEngine(model, flat, input_hw=hw, max_batch_size=2, device="cpu",
                      topology=PIFPAF_TOPOLOGY, fused_decode=pifpaf_fused_decode(model))
    before = _Arrays(teng.infer_batch_device(frames))
    jeng = _jax_pifpaf_engine(flat, hw, 2)
    x = jnp.asarray(frames, jnp.float32) / 255.0
    scales = jquant.calibrate(jeng.model, jeng.variables, [x], train=False)
    tq = quant.quantize_engine(teng, [frames])
    _assert_scales_close(tq.quant_scales, scales)
    assert _n_int8(tq.model) == len(tq.quant_scales) == 55 and _n_int8(model) == 0
    want = jquant.quantized_apply(jeng.model, scales)(jeng.variables, x, train=False)
    with torch.inference_mode():
        fields = tq.model(torch.from_numpy(frames).to(torch.float32) / 255.0)
    for k, v in fields.items():
        w = np.asarray(want[k])
        assert np.abs(v.numpy() - w).max() <= 0.1 * np.abs(w).max(), k
    got = _Arrays(tq.infer_batch_device(frames))
    assert int(got.valid.sum()) > 0
    own = _Arrays(PD.pifpaf_decode_batch(fields, PD.PifPafDecoderConfig(), 8, hw))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(own, f))
    after = _Arrays(teng.infer_batch_device(frames))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(after, f), getattr(before, f))


def test_quantize_engine_needs_a_rebuildable_step():
    eng = PoseEngine(Pifpaf(), None, input_hw=(64, 96), max_batch_size=1,
                     device="cpu", fused_decode=lambda x: None)
    with pytest.raises(ValueError, match="rebuild"):
        quant.quantize_engine(eng, [])


def test_bf16_engine_quantizes_its_float32_checkpoint():
    """A bf16 engine given `variables` quantizes them (float32), as the JAX
    engine does; without them it refuses, rather than quantizing the bf16
    weights its model holds."""
    scales = {"backbone/block_3/conv": 3.0}
    with pytest.raises(ValueError, match="float32"):
        PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), None, input_hw=(64, 72),
                   max_batch_size=1, device="cpu", quant_scales=scales)
    eng = PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), FLAGSHIP_NPZ,
                     input_hw=(64, 72), max_batch_size=1, device="cpu",
                     quant_scales=scales)
    q = eng.model.backbone.block_3.conv
    w_q, s_w = quant.weight_scales(eng.variables["params/backbone/block_3/conv/kernel"])
    assert torch.equal(q.s_w, torch.from_numpy(s_w))
    assert torch.equal(q.w_taps[:128, :, :, :128], torch.from_numpy(w_q.transpose(3, 0, 1, 2)))
    assert _n_int8(eng.model) == 1 and eng.quant_scales == scales


def test_int8_flagship_finds_the_two_people():
    """368x432, the synthetic frame: the int8 f32 engine finds the people
    the float engine finds."""
    hw = (368, 432)
    frame = synth_frame_rgb()
    eng = PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=hw,
                     max_batch_size=1, device="cpu")
    qeng = quant.quantize_engine(eng, [resize_bilinear(frame, hw)[None]])
    want, got = eng.inference([frame])[0], qeng.inference([frame])[0]
    assert len(want) == 2
    found = find_people(want, got)
    assert found is not None and found <= INT8_TOL["xy"]
