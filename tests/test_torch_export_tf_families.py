"""The port's frozen TensorFlow graphs for the other families `Model.get_model`
serves: CMU OpenPose (Vgg19, PReLU), MobileNet-Thin and -Small OpenPose,
PoseProposal and PifPaf, each `.pb` reloaded and held against the port's and
the JAX package's forward on the same seeded flax weights
(`test_torch_export_tf.check_pb`, 2e-5 x max(1, max |ref|)); what a frozen
graph holds, beside the JAX package's own `.pb` of the same network; and the
refusal of an op that has no lowering.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_export_tf import (
    assert_close, assert_frozen, check_pb, jax_forward, read_graph, run_graph,
)
from test_torch_openpose_family import _hashable
from torch_parity import flagship_flat, nest
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models.pifpaf import Pifpaf as JaxPifpaf
from hyperpose_tpu.models.pose_proposal import PoseProposal as JaxPoseProposal
from hyperpose_tpu.utils.export import export_pb as jax_export_pb
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.models.pose_proposal import PoseProposal
from hyperpose_torch.utils import tf_lower
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights

tf = pytest.importorskip("tensorflow")

HW = (64, 64)   # the OpenPose family's smallest valid size; 16 | 64 (PifPaf), 32 | 64 (PPN)

# name -> (JAX model, port model, its output keys)
FAMILIES = {
    "openpose_vgg19": (lambda: JO.OpenPose(), lambda: PO.OpenPose(),
                       ["conf_map", "paf_map"]),
    "mobilenet_thin": (lambda: _hashable(JO.MobilenetThinOpenpose()),
                       lambda: PO.MobilenetThinOpenpose(), ["conf_map", "paf_map"]),
    "mobilenet_small": (lambda: _hashable(JO.MobilenetSmallOpenpose()),
                        lambda: PO.MobilenetSmallOpenpose(), ["conf_map", "paf_map"]),
    "pose_proposal": (lambda: JaxPoseProposal(hin=HW[0], win=HW[1]),
                      lambda: PoseProposal(hin=HW[0], win=HW[1]),
                      ["c", "e", "h", "i", "w", "x", "y"]),
    "pifpaf": (lambda: JaxPifpaf(hin=HW[0], win=HW[1], dtype=jnp.float32),
               lambda: Pifpaf(hin=HW[0], win=HW[1]),
               ["paf_conf", "paf_dst_bmin", "paf_dst_scale", "paf_dst_vec", "paf_src_bmin",
                "paf_src_scale", "paf_src_vec", "pif_bmin", "pif_conf", "pif_scale",
                "pif_vec"]),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_pb_equals_port_and_jax(family, tmp_path):
    jax_model, port_model, keys = FAMILIES[family]
    model = port_model()
    flat = random_flax_weights(model, seed=5)
    x = np.random.default_rng(6).random((1, *HW, 3), dtype=np.float32)
    jax_out = jax_forward(jax_model(), nest(flat), x)
    model = load_flax_weights(model, flat).eval()
    got = check_pb(model, jax_out, x, os.path.join(tmp_path, f"frozen_{family}.pb"))
    assert sorted(got) == keys


def test_frozen_graph_holds_tf_ops_where_jax_holds_stablehlo(tmp_path):
    """The flagship at 64x64: the port's `.pb` has one Placeholder `input`,
    no variables, no XlaCallModule and no Python op, where the JAX
    package's `.pb` of the same network embeds StableHLO in an
    XlaCallModule (hyperpose_tpu/utils/export.py:69-71); both reload
    through the same loader and agree."""
    flat = flagship_flat()
    x = np.random.default_rng(7).random((1, *HW, 3), dtype=np.float32)
    model = load_flax_weights(PO.LightWeightOpenPose(backbone=PB.VggTiny), flat).eval()
    ours = os.path.join(tmp_path, "frozen_port.pb")
    tf_lower_free = check_pb(model, jax_forward(JO.LightWeightOpenPose(backbone=JB.VggTiny),
                                                nest(flat), x), x, ours)
    graph = read_graph(ours)
    ops = {n.op for n in graph.node}
    assert ops <= {"Placeholder", "Const", "Identity", "Conv2D", "BiasAdd", "Relu",
                   "MaxPool", "AddV2", "ConcatV2"}, ops

    jm = JO.LightWeightOpenPose(backbone=JB.VggTiny, dtype=jnp.float32)
    variables = nest(flat)
    theirs = os.path.join(tmp_path, "frozen_jax.pb")
    jax_export_pb(lambda im: {k: v for k, v in jm.apply(variables, im, train=False).items()
                              if not isinstance(v, (list, tuple))}, x.shape, theirs)
    jax_graph = read_graph(theirs)
    assert "XlaCallModule" in {n.op for n in jax_graph.node}
    for a, b in zip(run_graph(jax_graph, x, 2), (tf_lower_free[k] for k in ("conf_map",
                                                                          "paf_map"))):
        assert_close(b, a, 2e-5, "port .pb vs JAX .pb")
    assert_frozen(graph)


class _Gelu(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)

    def forward(self, x):
        return {"y": F.gelu(self.conv(x.permute(0, 3, 1, 2)))}


def test_unknown_op_raises_naming_it(tmp_path):
    """GELU has no lowering: the plan raises NotImplementedError naming the
    op and the module, the export writes nothing, and a non-strict plan
    lists it."""
    with pytest.raises(NotImplementedError, match=r"aten\.gelu\.default.*_Gelu"):
        tf_lower.plan_forward(_Gelu(), (1, 8, 8, 3))
    from hyperpose_torch.utils.export import export_pb

    with pytest.raises(NotImplementedError, match="gelu"):
        export_pb(_Gelu(), (1, 8, 8, 3), os.path.join(tmp_path, "frozen.pb"))
    assert not os.listdir(tmp_path)
    plan = tf_lower.plan_forward(_Gelu(), (1, 8, 8, 3), strict=False)
    assert len(plan.unlowered) == 1 and "gelu" in plan.unlowered[0]
    assert plan.histogram() == {"Conv2D": 1, "BiasAdd": 1}
    with pytest.raises(NotImplementedError, match="gelu"):
        tf_lower.tf_function(plan)
