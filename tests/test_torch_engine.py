"""The port's PoseEngine (device="cpu") against the JAX PoseEngine on the
trained flagship weights.

Tolerances: valid and part_valid exact, coords atol 1e-5, human scores atol
1e-3 (about 20 float32 conv layers and the decoder's sums, reassociated).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, synth_frame_rgb
from hyperpose_tpu.models.backbones import VggTiny as JaxVggTiny
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_tpu.train.checkpoint import load_npz_tree
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.runtime.engine import PoseEngine

HW = (368, 432)
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _jax_engine(hw, **kw):
    model = JaxLwOpenPose(backbone=JaxVggTiny, dtype=jnp.float32)
    return JaxPoseEngine(model, load_npz_tree(FLAGSHIP_NPZ), input_hw=hw,
                         max_batch_size=1, **kw)


def _port_engine(hw, **kw):
    return PoseEngine(LightWeightOpenPose(), FLAGSHIP_NPZ, input_hw=hw,
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
    assert set(rep) == {"engine/preprocess", "engine/device_step"}
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
            PoseEngine(LightWeightOpenPose(), max_batch_size=1)


def test_rejected_arguments():
    with pytest.raises(ValueError):
        _port_engine((64, 72), input_format="bogus")
    with pytest.raises(ValueError):
        _port_engine((66, 72), input_format="yuv420")
    with pytest.raises(ValueError):
        _port_engine((64, 72)).inference([np.zeros((8, 8, 3), np.uint8)] * 2)
    for kw in ({"fused_decode": lambda v, x: x}, {"quant_scales": {"a": 1.0}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _port_engine((64, 72), **kw)
    eng = _port_engine((64, 72))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.save("x")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PoseEngine.load_executable("x")
