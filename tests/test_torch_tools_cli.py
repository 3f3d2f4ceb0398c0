"""The port's export, FLOP-count and weight-conversion command lines
(`hyperpose_torch/tools/{export_model,measure_flops,convert_reference_npz}.py`)
against the JAX package's scripts (`export_model.py`, `measure_flops.py`,
`scripts/convert_reference_npz.py`), on the CPU.

- Each tool takes exactly its JAX script's flags, with the same defaults,
  plus `--device` (default cuda; without a GPU it raises).
- `export_model`: the npz it writes is read back by JAX's `load_weights_npz`
  bit for bit; its `.pt2` (`--with_decode`) loads and equals the eager
  engine step bit for bit; `--format pb / tflite / tflite_uint8` write the
  JAX script's files, which reload in TensorFlow.
- `measure_flops`: the parameter count equals the flax module's for every
  model type (counted on the meta device, from the shapes).
- `convert_reference_npz` on a TensorLayer npz written by
  `tests/torch_tl_layout.py` (the flagship's weights): the same alignment
  report and the same npz, array for array, as the JAX script; `--report`
  writes nothing.
"""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, REPO, flagship_flat
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.tools import convert_reference_npz, export_model, measure_flops

TOOLS = {  # tool -> (the JAX script, argv both need)
    "export_model": (export_model, "export_model.py", []),
    "measure_flops": (measure_flops, "measure_flops.py", []),
    "convert_reference_npz": (convert_reference_npz, "scripts/convert_reference_npz.py",
                              ["--src", "x.npz"]),
}
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _script(rel: str):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _jax_flags(rel: str, argv, monkeypatch) -> dict:
    """The namespace the JAX script's own parser makes of `argv` (its
    `main` stopped right after parsing)."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["ns"] = parse(self, args, namespace)
        raise _Parsed

    mod = _script(rel)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        m.setattr(sys, "argv", [rel] + list(argv))
        with pytest.raises(_Parsed):
            mod.main()
    return vars(seen["ns"])


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_flags_are_the_jax_script_flags(tool, monkeypatch):
    mod, rel, argv = TOOLS[tool]
    want = _jax_flags(rel, argv, monkeypatch)
    got = vars(mod.parse_args(argv))
    assert sorted(got) == sorted(list(want) + ["device"])
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] == "cuda"


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_refuses_cuda_without_a_gpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    mod, _, argv = TOOLS[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(argv + ["--output_dir", str(tmp_path)] if tool == "export_model" else argv)


def _run_quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


def test_export_model_npz_reads_back_in_jax_and_program_equals_the_step(tmp_path):
    from hyperpose_tpu.models.backbones import VggTiny as JaxVggTiny
    from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLw
    from hyperpose_tpu.train.checkpoint import load_weights_npz

    res, text = _run_quiet(export_model.run, [
        "--model_backbone", "Vggtiny", "--weights", FLAGSHIP_NPZ, "--with_decode",
        "--batch_size", "2", "--output_dir", str(tmp_path), "--model_name", "flagship",
        "--device", "cpu"])
    assert res["loaded"] == FLAGSHIP_NPZ and "GFLOP / batch" in text and res["flops"] > 0
    assert res["weights"] == str(tmp_path / "flagship.npz")
    assert res["executable"] == str(tmp_path / "flagship.pt2")
    flat = flagship_flat()
    jvars = jax.eval_shape(lambda: JaxLw(backbone=JaxVggTiny).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jvars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jvars)
    back = load_weights_npz(jvars, res["weights"])
    got = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 368, 432, 3), dtype=np.uint8))
    engine = res["engine"]
    want = engine._step(frames)
    loaded = PoseEngine.load_executable(res["executable"])(frames)
    for f, t in zip(FIELDS, loaded):
        assert torch.equal(t, getattr(want, f)), f


@pytest.mark.parametrize("fmt", ["pb", "tflite", "tflite_uint8"])
def test_export_model_tf_formats_write_files_that_reload(fmt, tmp_path):
    """`--format pb / tflite / tflite_uint8` write the JAX script's files
    (`frozen_<name>.pb`, `<name>.tflite`) from a float32 copy of the
    config's (bf16) model holding the trained flagship weights at 368x432;
    each reloads in TensorFlow, and the float ones give the float32
    network's maps on those weights (2e-5 and 1e-4 x max(1, max |ref|), as
    tests/test_torch_export_tf{,lite}.py), the uint8 one takes and gives
    uint8."""
    tf = pytest.importorskip("tensorflow")
    from test_torch_export_tf import assert_close, port_forward, read_graph, run_graph
    from hyperpose_torch.models.backbones import VggTiny
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.utils.weights import load_flax_weights

    res, _ = _run_quiet(export_model.run, [
        "--model_backbone", "Vggtiny", "--weights", FLAGSHIP_NPZ, "--model_name", "tiny",
        "--format", fmt, "--output_dir", str(tmp_path), "--device", "cpu"])
    name = "frozen_tiny.pb" if fmt == "pb" else "tiny.tflite"
    assert sorted(os.listdir(tmp_path)) == sorted([name, "tiny.npz"])
    assert res["pb" if fmt == "pb" else "tflite"] == os.path.join(tmp_path, name)
    x = np.random.default_rng(11).random((1, 368, 432, 3), dtype=np.float32)
    want = port_forward(load_flax_weights(LightWeightOpenPose(backbone=VggTiny),
                                          FLAGSHIP_NPZ).eval(), x)
    if fmt == "pb":
        got = dict(zip(sorted(want), run_graph(read_graph(res["pb"]), x, len(want))))
        for k, v in want.items():
            assert_close(got[k], v, 2e-5, k)
        return
    interp = tf.lite.Interpreter(model_path=res["tflite"])
    interp.allocate_tensors()
    (inp,) = interp.get_input_details()
    outs = interp.get_output_details()
    assert len(outs) == 2 and tuple(inp["shape"]) == x.shape
    if fmt == "tflite_uint8":
        assert inp["dtype"] == np.uint8 and all(d["dtype"] == np.uint8 for d in outs)
        interp.set_tensor(inp["index"], (x * 255).astype(np.uint8))
        interp.invoke()
        return
    interp.set_tensor(inp["index"], x)
    interp.invoke()
    for d in outs:
        k = sorted(want)[0 if d["name"] == "Identity" else int(d["name"].split("_")[1])]
        assert_close(interp.get_tensor(d["index"]), want[k], 1e-4, k)


def test_export_model_forward_program_equals_the_forward(tmp_path):
    """Without `--with_decode` the program is the forward on uint8 images,
    its maps equal the eager model's bit for bit; the weights are the
    trainer's initial draw when no checkpoint is found."""
    res, _ = _run_quiet(export_model.run, [
        "--model_type", "PoseProposal", "--model_name", "ppn", "--output_dir",
        str(tmp_path), "--weights", str(tmp_path / "none.npz"), "--device", "cpu"])
    assert res["loaded"] is None
    engine = res["engine"]
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, 384, 384, 3), dtype=np.uint8))
    with torch.inference_mode():
        want = engine.model(frames.to(engine.dtype) / 255.0)
    got = PoseEngine.load_executable(res["executable"])(frames)
    assert set(got) == {k for k, v in want.items() if not isinstance(v, list)}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def _jax_param_count(model_type: str) -> int:
    from hyperpose_tpu import config as JC
    from hyperpose_tpu import models as JM

    JC.reset()
    JC.set_model_type(JC.MODEL[model_type])
    cfg = JC.get_config(create_dirs=False)
    model = JM.get_model(cfg)
    if hasattr(model, "init_plan"):        # the thin stages hold their plans as lists
        model = model.clone(init_plan=tuple(model.init_plan), ref_plan=tuple(model.ref_plan))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.model.hin, cfg.model.win, 3), model.dtype),
        train=False))
    JC.reset()
    return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("model_type", ["LightweightOpenpose", "Openpose", "PoseProposal",
                                        "MobilenetThinOpenpose", "Pifpaf"])
def test_measure_flops_params_equal_jax(model_type):
    res, text = _run_quiet(measure_flops.run, ["--model_type", model_type, "--device", "meta"])
    assert res["params"] == _jax_param_count(model_type)
    assert res["flops"] > 0 and "GFLOP/frame" in text and "M params" in text


def _tl_flagship(path: str) -> str:
    from tl_fixtures import lw_openpose_entries, save_tl_npz_dict
    from torch_tl_layout import tl_layout
    from hyperpose_torch.utils.tl_orders import ORDER_KEYS

    entries = tl_layout(lw_openpose_entries("vggtiny")[0], flagship_flat(),
                        ORDER_KEYS["LightweightOpenpose"])
    save_tl_npz_dict(entries, path)
    return path


def test_convert_reference_npz_writes_what_jax_writes(tmp_path, monkeypatch):
    src = _tl_flagship(str(tmp_path / "tl.npz"))
    common = ["--model", "LightweightOpenpose", "--backbone", "Vggtiny", "--src", src]
    jax_dst, dst = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    monkeypatch.setattr(sys, "argv", ["convert_reference_npz.py"] + common + ["--dst", jax_dst])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _script("scripts/convert_reference_npz.py").main()
    jax_report = json.loads(out.getvalue()[:out.getvalue().rindex("}") + 1])
    res, text = _run_quiet(convert_reference_npz.run, common + ["--dst", dst, "--device", "cpu"])
    assert res["report"] == jax_report and json.loads(text[:text.rindex("}") + 1]) == jax_report
    assert jax_report and all(r["source"] for r in jax_report.values())
    with np.load(jax_dst) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    flat = flagship_flat()
    with np.load(dst) as b:
        for k, v in flat.items():
            np.testing.assert_array_equal(b[k], v, err_msg=k)
    res, _ = _run_quiet(convert_reference_npz.run, common + ["--report", "--dst",
                                                             str(tmp_path / "no.npz"),
                                                             "--device", "cpu"])
    assert res["dst"] is None and res["report"] == jax_report
    assert not os.path.exists(tmp_path / "no.npz")
