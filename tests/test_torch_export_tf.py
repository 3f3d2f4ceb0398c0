"""The port's frozen TensorFlow graphs (`utils/export.py` `export_pb`, lowered
by `utils/tf_lower.py` from the port's own graph) for the Lightweight-OpenPose
forms: every backbone `Model.get_model` serves it on, and the flagship's two
serving stems. Each `.pb` is reloaded in TensorFlow as the JAX package's test
reloads its own (tests/test_export_interchange.py:44-61) and held against the
port's forward and the JAX package's forward on the same seeded flax weights.

Tolerance: every output within 2e-5 x max(1, max |ref|) of each reference,
the JAX test's own 2e-5 (tests/test_export_interchange.py:70) scaled by the
maps' range; float32 sums in TF's order against torch's and XLA's.

The fused stem's JAX forward reaches `pallas_call`, which jax2tf cannot put
into a `.pb`; its reference is the JAX fused-stem module in interpret mode on
the JAX remap of the same weights (the S2D stem's likewise, without Pallas).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nest
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.utils.export import export_pb
from hyperpose_torch.utils.tf_lower import ExportForward
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

tf = pytest.importorskip("tensorflow")

PB_RTOL = 2e-5
FORBIDDEN_OPS = {"VarHandleOp", "ReadVariableOp", "XlaCallModule", "PyFunc",
                 "PyFuncStateless", "EagerPyFunc"}


def read_graph(path: str):
    graph_def = tf.compat.v1.GraphDef()
    with open(path, "rb") as f:
        graph_def.ParseFromString(f.read())
    return graph_def


def run_graph(graph_def, x: np.ndarray, n: int) -> list:
    """The reloaded graph's outputs `Identity`, `Identity_1`, ... on `x`."""
    names = ["Identity:0"] + [f"Identity_{i}:0" for i in range(1, n)]

    @tf.function
    def run(inp):
        return tf.graph_util.import_graph_def(graph_def, input_map={"input:0": inp},
                                              return_elements=names)

    return [t.numpy() for t in run(tf.constant(x))]


def assert_frozen(graph_def) -> None:
    """One Placeholder named `input`, TF ops and constants only."""
    ops = {n.op for n in graph_def.node}
    assert [n.name for n in graph_def.node if n.op == "Placeholder"] == ["input"]
    assert not ops & FORBIDDEN_OPS, ops & FORBIDDEN_OPS


def assert_close(got, want, rtol: float, what: str) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max |d| {err} vs {rtol} x {scale}"


def jax_forward(module, variables, x) -> dict:
    """The JAX script's `fwd_f32` (export_model.py:101-104), jitted."""
    out = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))
    return {k: np.asarray(v, np.float32) for k, v in out.items()
            if not isinstance(v, (list, tuple))}


def port_forward(model, x) -> dict:
    with torch.no_grad():
        return {k: v.numpy() for k, v in ExportForward(model)(torch.from_numpy(x)).items()}


def check_pb(model, jax_out: dict, x: np.ndarray, path: str) -> dict:
    """Export `model` to `path`, reload it, and hold each output (keys in
    sorted order, as the JAX package's `.pb`) to the port's forward and to
    `jax_out`. Returns the reloaded outputs by key."""
    export_pb(model, x.shape, path)
    graph_def = read_graph(path)
    assert_frozen(graph_def)
    ours = port_forward(model, x)
    keys = sorted(jax_out)
    assert sorted(ours) == keys
    got = dict(zip(keys, run_graph(graph_def, x, len(keys))))
    for k in keys:
        assert_close(got[k], ours[k], PB_RTOL, f"{k} vs the port")
        assert_close(got[k], jax_out[k], PB_RTOL, f"{k} vs JAX")
    return got


def _stem(port_stem, jax_stem, port_remap, jax_remap):
    """A serving stem of VggTiny: the same VggTiny weights remapped by each
    package."""
    return (lambda: PO.LightWeightOpenPose(backbone=PB.VggTiny),
            lambda: PO.LightWeightOpenPose(backbone=port_stem),
            lambda: JO.LightWeightOpenPose(backbone=jax_stem),
            port_remap, lambda flat: jax_remap(nest(flat)))


def _plain(port_backbone, jax_backbone):
    return (lambda: PO.LightWeightOpenPose(backbone=port_backbone), None,
            lambda: JO.LightWeightOpenPose(backbone=jax_backbone), None, None)


# name -> (port model the weights are drawn for, port model exported (None:
# the same), JAX model, port remap, JAX remap of the drawn flat weights)
LW_FORMS = {
    "vggtiny": _plain(PB.VggTiny, JB.VggTiny),
    "vggtiny_s2d": _plain(PB.VggTinyS2D, JB.VggTinyS2D),
    "vggtiny_s2d_stem": _stem(PB.VggTinyS2DStem, JB.VggTinyS2DStem,
                              PB.remap_vggtiny_to_s2d, JB.remap_vggtiny_to_s2d),
    "vggtiny_fused_stem": _stem(PB.VggTinyFusedStem,
                                lambda **kw: JB.VggTinyFusedStem(interpret=True, **kw),
                                PB.remap_vggtiny_to_fused, JB.remap_vggtiny_to_fused),
    "mobilenet_dilated": _plain(PB.MobilenetDilated, JB.MobilenetDilated),
    "mobilenetv1": _plain(PB.MobilenetV1, JB.MobilenetV1),
    "mobilenetv2": _plain(PB.MobilenetV2, JB.MobilenetV2),
    "vgg16": _plain(PB.Vgg16, JB.Vgg16),
    "vgg19": _plain(PB.Vgg19, JB.Vgg19),
    "resnet18": _plain(PB.Resnet18, JB.Resnet18),
}


@pytest.mark.parametrize("form", list(LW_FORMS))
def test_lightweight_openpose_pb_equals_port_and_jax(form, tmp_path):
    """64x64, batch 1: the OpenPose family's smallest valid size."""
    drawn, exported, jax_model, port_remap, jax_remap = LW_FORMS[form]
    torch.manual_seed(0)
    flat = random_flax_weights(drawn(), seed=3)
    x = np.random.default_rng(4).random((1, 64, 64, 3), dtype=np.float32)
    variables = jax_remap(flat) if jax_remap else nest(flat)
    jax_out = jax_forward(jax_model(), variables, x)
    model = (exported or drawn)()
    model = load_flax_weights(model, port_remap(flat) if port_remap else flat).eval()
    got = check_pb(model, jax_out, x, os.path.join(tmp_path, f"frozen_{form}.pb"))
    assert sorted(got) == ["conf_map", "paf_map"]
    assert got["paf_map"].shape == (1, 8, 8, 38)
