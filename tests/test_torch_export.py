"""Export of the port (`hyperpose_torch/utils/export.py`,
`PoseEngine.save` / `load_executable`, the kernel wrappers as `hyperpose::`
operators) on the CPU, and the port's example programs.

- `export_npz` writes the JAX package's flat npz: its `load_weights_npz`
  reads every array back bit for bit.
- `save` -> `load_executable` runs the traced step: equal bit for bit to the
  eager step on the PAF (float and int8), PoseProposal and PifPaf families,
  and in a fresh process; the program holds the kernels as operators.
- Each operator's fake implementation gives its real output's shapes,
  dtypes and strides (`torch.library.opcheck`).
- `measure_flops` of the flagship equals `torch_measures.conv_operations`.
"""
import os
import py_compile
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_measures import conv_operations
from torch_parity import FLAGSHIP_NPZ, REPO, flagship_flat, synth_frame_rgb
from hyperpose_torch import Config, Model, quant
from hyperpose_torch.models.backbones import Resnet18, VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels import conv1_pool, grow, int8_gemm, line_gather, peak_topk
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.export import export_npz, measure_flops
from hyperpose_torch.utils.weights import random_flax_weights

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def test_export_npz_reads_back_in_jax(tmp_path):
    """From a model (its state dict) and from flat weights: JAX's
    `load_weights_npz` on a flax init of the same network returns the
    arrays bit for bit."""
    import jax
    import jax.numpy as jnp

    from hyperpose_tpu.models.backbones import VggTiny as JaxVggTiny
    from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLw
    from hyperpose_tpu.train.checkpoint import load_weights_npz

    flat = flagship_flat()
    jvars = jax.eval_shape(lambda: JaxLw(backbone=JaxVggTiny).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    jvars = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jvars)
    model = PoseEngine(LightWeightOpenPose(backbone=VggTiny), flat, device="cpu").model
    for src, name in ((model, "model.npz"), (flat, "flat.npz")):
        path = export_npz(src, str(tmp_path / name))
        back = load_weights_npz(jvars, path)
        got = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
               for p, v in jax.tree_util.tree_flatten_with_path(back)[0]}
        assert got.keys() == flat.keys()
        for k in flat:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def _engine(model: str, hw, backbone="Default", batch=2, arch=None):
    """The facade's float32 engine on the CPU, seeded random weights (the
    flagship's for VggTiny); `arch` is the config's `model_arch`."""
    stride = 32 if model == "PoseProposal" else 8
    Config.reset()
    try:
        Config.set_model_type(Config.MODEL[model])
        Config.set_model_backbone(Config.BACKBONE[backbone])
        Config.set_compute_dtype("float32")
        Config.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // stride,
                               wout=hw[1] // stride)
        if arch is not None:
            Config.set_model_arch(arch)
        cfg = Config.get_config(create_dirs=False)
    finally:
        Config.reset()
    m = Model.get_model(cfg)
    weights = FLAGSHIP_NPZ if backbone == "Vggtiny" else random_flax_weights(m, seed=4)
    return PoseEngine(m, weights, input_hw=hw, max_batch_size=batch, device="cpu",
                      topology=Model.get_topology(cfg),
                      fused_decode=Model._fused_decode_for(cfg, m))


def _frames(hw, seed=6, batch=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (batch, *hw, 3), dtype=np.uint8))


def _kernel_ops(fn) -> set:
    return {str(n.target).split(".")[1] for n in fn.module.graph.nodes
            if str(n.target).startswith("hyperpose.")}


@pytest.fixture(scope="module")
def paf_saved(tmp_path_factory):
    """The flagship at 128x152 on the synthetic frame (2 people) and a
    random one."""
    hw = (128, 152)
    eng = _engine("LightweightOpenpose", hw, "Vggtiny")
    frames = _frames(hw)
    frames[0] = torch.from_numpy(resize_bilinear(synth_frame_rgb(), hw))
    prefix = str(tmp_path_factory.mktemp("paf") / "engine")
    paths = eng.save(prefix)
    return eng, frames, paths


def _assert_equal_step(fn, eng, frames):
    got = fn(frames)
    want = eng._step(frames)
    assert len(got) == 5
    for f, g in zip(FIELDS, got):
        assert torch.equal(g, getattr(want, f)), f
    return got


def test_save_load_paf(paf_saved):
    """The flagship network's step: the weights npz and the `.pt2` program,
    which holds the PAF decoder's two kernels as operators and equals the
    eager step bit for bit."""
    eng, frames, paths = paf_saved
    assert paths == {"weights": paths["weights"], "executable": paths["executable"]}
    assert paths["weights"].endswith(".npz") and paths["executable"].endswith(".pt2")
    with np.load(paths["weights"]) as data:
        assert set(data.files) == set(flagship_flat())
    fn = PoseEngine.load_executable(paths["executable"])
    assert _kernel_ops(fn) == {"peak_topk", "limb_scores"}
    got = _assert_equal_step(fn, eng, frames)
    assert int(got[4][0].sum()) == 2


def test_loaded_program_in_a_fresh_process(paf_saved, tmp_path):
    """A process that imports nothing but the loader runs the saved program
    and gets the eager step's outputs."""
    eng, frames, paths = paf_saved
    want = eng._step(frames)
    np.savez(tmp_path / "io.npz", frames=frames.numpy(),
             **{f: getattr(want, f).numpy() for f in FIELDS})
    code = (
        "import sys, numpy as np, torch\n"
        "from hyperpose_torch.runtime.engine import PoseEngine\n"
        "torch.set_num_threads(1)\n"
        "io = np.load(sys.argv[2])\n"
        "out = PoseEngine.load_executable(sys.argv[1])(torch.from_numpy(io['frames']))\n"
        f"for f, g in zip({FIELDS!r}, out):\n"
        "    assert np.array_equal(g.numpy(), io[f]), f\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code, paths["executable"],
                        str(tmp_path / "io.npz")], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


@pytest.mark.parametrize("model,hw,ops", [
    ("PoseProposal", (64, 64), set()),
    ("Pifpaf", (64, 64), {"fused_grow"}),
])
def test_save_load_fused_families(tmp_path, model, hw, ops):
    """PoseProposal (no kernel on its path: its decoder has none) and PifPaf
    (the growth kernel; its network on Resnet18 through `model_arch`, a
    third of the default Resnet50's ops to trace) through
    `_fused_decode_for`'s step."""
    arch = Pifpaf(hin=hw[0], win=hw[1], backbone=Resnet18) if model == "Pifpaf" else None
    eng = _engine(model, hw, arch=arch)
    frames = _frames(hw)
    fn = PoseEngine.load_executable(eng.save(str(tmp_path / "e"))["executable"])
    assert _kernel_ops(fn) == ops
    _assert_equal_step(fn, eng, frames)


def test_save_load_int8(tmp_path):
    """An int8 engine (`quant.quantize_engine`): the program holds the int8
    quantize and conv operators (and the depthwise one: the default
    Lightweight-OpenPose on MobilenetDilated) and equals the eager step."""
    hw = (64, 64)
    eng = _engine("LightweightOpenpose", hw)
    frames = _frames(hw)
    qeng = quant.quantize_engine(eng, [frames.numpy()])
    fn = PoseEngine.load_executable(qeng.save(str(tmp_path / "q"))["executable"])
    assert _kernel_ops(fn) == {"int8_quantize", "int8_conv", "int8_dwconv", "peak_topk",
                               "limb_scores"}
    _assert_equal_step(fn, qeng, frames)


def _opcheck(op, args):
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def test_operators_fake_matches_real():
    """Each operator on CPU tensors: the schema, and the fake
    implementation's shapes, dtypes and strides against the real
    (plain-version) outputs, on views like those the decoders pass."""
    rng = np.random.default_rng(0)
    conf = torch.from_numpy(rng.uniform(0, 1, (2, 12, 14, 19)).astype(np.float32))
    _opcheck(peak_topk._peak_topk_op, (conf[..., :18], 4, 5, 0.75, 0.05, "reflect"))
    _opcheck(peak_topk._peak_candidates_op, (conf[..., :18], 5, 0.75, 0.05, -1e30))
    paf = torch.from_numpy(rng.standard_normal((2, 12, 14, 6)).astype(np.float32))
    xy = torch.from_numpy(rng.uniform(0, 12, (2, 4, 3, 2)).astype(np.float32))
    _opcheck(line_gather._limb_scores_op,
             (paf, xy, torch.ones(2, 4, 3, dtype=torch.bool), [0, 1, 1, 2, 2, 3], 10, 4.0,
              0.05, 8, True))
    x = torch.from_numpy(rng.standard_normal((2, 5, 9, 11)).astype(np.float32))
    fold = [3, 3, 2, 2, 1, 1, 1, 1]
    _opcheck(int8_gemm._int8_quantize_op, (x, 3.0, 64, fold))
    _opcheck(int8_gemm._int8_quantize_op, (x, 3.0, 32, None))
    xq = int8_gemm.int8_quantize(x, 3.0, 32)
    w = torch.from_numpy(rng.integers(-127, 128, (8, 3, 3, 32), dtype=np.int8))
    dq = torch.rand(6)
    _opcheck(int8_gemm._int8_conv_op, (xq, w, dq, None, [2, 2], [1, 1], [1, 1], torch.float32))
    taps = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32), dtype=np.int8))
    _opcheck(int8_gemm._int8_dwconv_op,
             (x.to(torch.bfloat16), 3.0, taps, torch.rand(5), torch.rand(5), [1, 1], [1, 1],
              [1, 1]))
    btp = torch.randn(1, 6, 4, 128)
    _opcheck(conv1_pool._conv1_pool_op, (btp, torch.randn(3, 128, 128), torch.randn(128)))
    tables = [torch.rand(2, 4, 5) for _ in range(12)]
    _opcheck(grow._fused_grow_op,
             (torch.zeros(2, 3, dtype=torch.int32), torch.rand(2, 3, 4), tables[:6], tables[6:],
              [0, 1, 1, 2], [1, 2, 0, 1], 3, 2, True))


def test_eager_calls_skip_the_dispatcher(monkeypatch):
    """An eager call reaches the wrapper's body directly; only a traced one
    goes through the operator (both run the same body)."""
    conf = torch.rand(1, 8, 8, 3)
    called = []
    monkeypatch.setattr(peak_topk, "_peak_topk_op", lambda *a: called.append(a))
    peak_topk.peak_topk(conf, 2)
    assert not called
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    peak_topk.peak_topk(conf, 2)
    assert len(called) == 1


def test_measure_flops_matches_conv_operations():
    """`FlopCounterMode` counts 2 x the multiply-adds of every conv of the
    flagship network, the count `torch_measures` takes on the meta device;
    the byte count has no PyTorch counterpart (NaN)."""
    model = PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ,
                       device="cpu").model
    x = torch.zeros(1, 96, 112, 3)
    got = measure_flops(model, x)
    assert got["flops"] == conv_operations(model, tuple(x.shape)) > 0
    assert np.isnan(got["bytes_accessed"])


EXAMPLES = ("gen_serialized_engine", "operator_image_batch", "operator_imshow",
            "operator_video", "stream_video", "tutorial_minimum", "tutorial_stream",
            "python_demo")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_parses(name, capsys):
    """Each counterpart of `examples/*.py` and `python_demo.py` compiles,
    exists under the JAX file's name and takes `--device`."""
    path = os.path.join(REPO, "hyperpose_torch", "examples", f"{name}.py")
    jax_path = os.path.join(REPO, "python_demo.py" if name == "python_demo"
                            else os.path.join("examples", f"{name}.py"))
    assert os.path.exists(jax_path)
    py_compile.compile(path, doraise=True)
    module = __import__(f"hyperpose_torch.examples.{name}", fromlist=["main"])
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out



@pytest.mark.parametrize("tool", ["export_pb", "export_tflite", "export_model"])
def test_tf_exports_without_tensorflow_raise_and_write_nothing(tool, tmp_path, monkeypatch):
    """Where `import tensorflow` fails (the GPU machine has none), the TF
    exports and `export_model --format pb` raise an ImportError naming
    tensorflow before they write anything, and the model is never traced."""
    from hyperpose_torch.tools import export_model
    from hyperpose_torch.utils import export, tf_lower

    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setattr(tf_lower, "plan_forward", None)     # reached: a TypeError
    model = LightWeightOpenPose(backbone=VggTiny).eval()
    calls = {
        "export_pb": lambda: export.export_pb(model, (1, 64, 64, 3),
                                              str(tmp_path / "frozen.pb")),
        "export_tflite": lambda: export.export_tflite(
            model, np.zeros((1, 64, 64, 3), np.float32), str(tmp_path / "m.tflite"),
            representative_inputs=[np.zeros((1, 64, 64, 3), np.float32)],
            quantize_uint8=True),
        "export_model": lambda: export_model.run([
            "--format", "stablehlo", "pb", "--output_dir", str(tmp_path / "out"),
            "--device", "cpu"]),
    }
    with pytest.raises(ImportError, match="tensorflow"):
        calls[tool]()
    assert not os.listdir(tmp_path)
