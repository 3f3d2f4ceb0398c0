"""The port's `.tflite` exports (`utils/export.py` `export_tflite`, float and
full uint8) and the flagship's `.pb` at full width on its trained weights.

Tolerances: the float `.tflite` within 1e-4 x max(1, max |ref|) of the
port's and the JAX package's forward (the JAX test's 1e-4,
tests/test_export_interchange.py:92); the uint8 `.tflite`'s mean absolute
error against the float maps at most twice that of the JAX package's uint8
artifact of the same network on the same input and representative set (two
quantizers of one float graph: their errors are of one size, not equal);
the full-width `.pb` decoded by the port finds JAX's 2 people, scores within
1e-3 of 17.0187 and 8.584 (tests/test_torch_engine.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_export_tf import assert_close, jax_forward, port_forward, read_graph, run_graph
from test_torch_isolation import PORT_FILES, _imports, _parse
from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest, synth_frame_rgb
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models.pifpaf import Pifpaf as JaxPifpaf
from hyperpose_tpu.models.pose_proposal import PoseProposal as JaxPoseProposal
from hyperpose_tpu.utils.export import export_tflite as jax_export_tflite
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.models.pose_proposal import PoseProposal
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.export import export_pb, export_tflite
from hyperpose_torch.utils.human import SkeletonBatch
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

tf = pytest.importorskip("tensorflow")

HW = (64, 64)
TFLITE_RTOL = 1e-4
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _flagship():
    return (lambda: JO.LightWeightOpenPose(backbone=JB.VggTiny),
            lambda: PO.LightWeightOpenPose(backbone=PB.VggTiny), flagship_flat)


# name -> (JAX model, port model, flat weights)
MODELS = {
    "flagship": _flagship(),
    "pifpaf": (lambda: JaxPifpaf(hin=HW[0], win=HW[1], dtype=jnp.float32),
               lambda: Pifpaf(hin=HW[0], win=HW[1]),
               lambda: random_flax_weights(Pifpaf(), seed=8)),
    "pose_proposal": (lambda: JaxPoseProposal(hin=HW[0], win=HW[1]),
                      lambda: PoseProposal(hin=HW[0], win=HW[1]),
                      lambda: random_flax_weights(PoseProposal(), seed=9)),
}


def _interpreter(path: str):
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    return interp


def _output_index(name: str) -> int:
    return 0 if name == "Identity" else int(name.rsplit("_", 1)[1])


@pytest.mark.parametrize("name", list(MODELS))
def test_tflite_float_equals_port_and_jax(name, tmp_path):
    """Outputs `Identity`, `Identity_1`, ... are the forward's keys in sorted
    order, as in the `.pb`."""
    jax_model, port_model, weights = MODELS[name]
    flat = weights()
    x = np.random.default_rng(10).random((1, *HW, 3), dtype=np.float32)
    model = load_flax_weights(port_model(), flat).eval()
    path = export_tflite(model, x, os.path.join(tmp_path, f"{name}.tflite"))
    interp = _interpreter(path)
    (inp,) = interp.get_input_details()
    assert inp["dtype"] == np.float32 and tuple(inp["shape"]) == x.shape
    interp.set_tensor(inp["index"], x)
    interp.invoke()
    ours, theirs = port_forward(model, x), jax_forward(jax_model(), nest(flat), x)
    keys = sorted(ours)
    outs = interp.get_output_details()
    assert len(outs) == len(keys) == len(theirs)
    for d in outs:
        k = keys[_output_index(d["name"])]
        got = interp.get_tensor(d["index"])
        assert_close(got, ours[k], TFLITE_RTOL, f"{k} vs the port")
        assert_close(got, theirs[k], TFLITE_RTOL, f"{k} vs JAX")


def _uint8_maps(path: str, x: np.ndarray) -> dict:
    """The uint8 model's outputs on float `x` (quantized with its input's
    scale and zero point), dequantized, keyed by channel count (the flagship's
    19 conf and 38 PAF maps)."""
    interp = _interpreter(path)
    (inp,) = interp.get_input_details()
    assert inp["dtype"] == np.uint8
    scale, zero = inp["quantization"]
    q = np.clip(np.round(x / scale + zero), 0, 255).astype(np.uint8)
    interp.set_tensor(inp["index"], q)
    interp.invoke()
    out = {}
    for d in interp.get_output_details():
        assert d["dtype"] == np.uint8
        scale, zero = d["quantization"]
        out[int(d["shape"][-1])] = (interp.get_tensor(d["index"]).astype(np.float32)
                                    - zero) * scale
    return out


def test_tflite_uint8_error_at_most_twice_jax(tmp_path):
    """The flagship's trained weights at 64x64, the JAX test's input and
    representative set (tests/test_export_interchange.py:99-107)."""
    flat = flagship_flat()
    x = np.random.default_rng(0).random((1, *HW, 3)).astype(np.float32)
    rng = np.random.default_rng(1)
    rep = [rng.random((1, *HW, 3)).astype(np.float32) for _ in range(4)]
    model = load_flax_weights(PO.LightWeightOpenPose(backbone=PB.VggTiny), flat).eval()
    ref = port_forward(model, x)
    ours = _uint8_maps(export_tflite(model, x, os.path.join(tmp_path, "port_q.tflite"),
                                     representative_inputs=rep, quantize_uint8=True), x)
    jm, variables = JO.LightWeightOpenPose(backbone=JB.VggTiny, dtype=jnp.float32), nest(flat)

    def fwd(im):
        out = jm.apply(variables, im, train=False)
        return {"conf_map": out["conf_map"], "paf_map": out["paf_map"]}

    jax_path = jax_export_tflite(fwd, x, os.path.join(tmp_path, "jax_q.tflite"),
                                 representative_inputs=rep, quantize_uint8=True)
    theirs = _uint8_maps(jax_path, x)
    want = {v.shape[-1]: v for v in ref.values()}
    assert sorted(ours) == sorted(theirs) == sorted(want) == [19, 38]
    err_ours = np.mean([np.abs(ours[c] - want[c]).mean() for c in want])
    err_jax = np.mean([np.abs(theirs[c] - want[c]).mean() for c in want])
    assert 0 < err_ours <= 2 * err_jax, (err_ours, err_jax)


def test_full_width_flagship_pb_finds_jax_two_people(tmp_path):
    """368x432, `weights/flagship_tinyvgg.npz`: the reloaded `.pb`'s maps,
    decoded by the port's PAF decoder, give JAX's two people."""
    hw = (368, 432)
    engine = PoseEngine(PO.LightWeightOpenPose(backbone=PB.VggTiny), FLAGSHIP_NPZ,
                        input_hw=hw, max_batch_size=1, device="cpu")
    x = resize_bilinear(synth_frame_rgb(), hw)[None].astype(np.float32) / 255.0
    path = export_pb(engine.model, x.shape, os.path.join(tmp_path, "frozen_flagship.pb"))
    conf, paf = run_graph(read_graph(path), x, 2)
    maps = port_forward(engine.model, x)
    assert_close(conf, maps["conf_map"], 2e-5, "conf_map")
    assert_close(paf, maps["paf_map"], 2e-5, "paf_map")
    d = engine.decode_outputs({"conf_map": torch.from_numpy(conf),
                               "paf_map": torch.from_numpy(paf)})
    humans = SkeletonBatch(*(getattr(d, f).numpy() for f in FIELDS)).to_humans(0)
    assert len(humans) == 2
    np.testing.assert_allclose(sorted((h.score for h in humans), reverse=True),
                               [17.0187, 8.584], rtol=0, atol=1e-3)


def test_lowering_imports_tensorflow_only_inside_functions():
    """The isolation scan covers the new module (no JAX, nothing of the JAX
    package); TensorFlow is imported by the functions that emit, never when
    a module of the port is imported."""
    for rel in ("hyperpose_torch/utils/tf_lower.py", "hyperpose_torch/utils/export.py"):
        assert rel in PORT_FILES
        tree = _parse(rel)
        assert not [m for m in _imports(tree, True) if m.split(".")[0] == "tensorflow"]
        assert "tensorflow" in {m.split(".")[0] for m in _imports(tree, False)}


@pytest.mark.parametrize("tensorflow", [True, False])
def test_chip_smoke_export_tool_check(tensorflow, tmp_path, monkeypatch):
    """`chip_smoke.tf_export_tool`, run here on the CPU: with TensorFlow the
    round trip finds the flagship's two people; without it (the card's
    machine) the refusal is what it checks."""
    import sys

    import chip_smoke

    if not tensorflow:
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = chip_smoke.tf_export_tool(str(tmp_path / "export_tf"), "cpu")
    assert out["tensorflow"] is tensorflow
    assert not os.path.exists(tmp_path / "export_tf")
    if tensorflow:
        np.testing.assert_allclose(out["people"], [17.0187, 8.584], rtol=0, atol=1e-3)
