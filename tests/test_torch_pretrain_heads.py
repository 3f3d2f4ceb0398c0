"""The backbones' `pretraining` variants in the port
(`hyperpose_torch/models/backbones.py`) against the JAX package's on the CPU:
every backbone that JAX gives one, on the same seeded random weights
(carried across through the weight bridge) at 32x32, batch 2: the logits
within 1e-5 of their max |value| in eval mode (float32) and in train mode
(float64), and every new BatchNorm statistic within 1e-5 x max(1, |v|).
MobilenetDilated has no head (its features are compared); MobilenetThin and
MobilenetSmall cannot build one in either package; VggTinyFusedStem refuses
it in both. The pretraining loop: tests/test_torch_pretrain.py.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pifpaf import _flax_shapes
from test_torch_pretrain import _as64, _close, _flat_tree
from torch_parity import nest
from hyperpose_tpu.models import backbones as JB
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

HW = (32, 32)
LOGIT_RTOL = 1e-5      # of the max |logit|
STATS_RTOL = 1e-5      # x max(1, |v|)

# name -> (flax module of a dtype, port module), both with pretraining=True
HEADS = {
    "VggTiny": (JB.VggTiny, lambda: PB.VggTiny(pretraining=True, image_size=HW)),
    "VggTinyS2DStem": (JB.VggTinyS2DStem,
                       lambda: PB.VggTinyS2DStem(pretraining=True, image_size=HW)),
    "VggTinyS2D": (JB.VggTinyS2D, lambda: PB.VggTinyS2D(pretraining=True, image_size=HW)),
    "Vgg16": (JB.Vgg16, lambda: PB.Vgg16(pretraining=True, image_size=HW)),
    "Vgg19": (JB.Vgg19, lambda: PB.Vgg19(pretraining=True, image_size=HW)),
    "MobilenetV1": (JB.MobilenetV1, lambda: PB.MobilenetV1(pretraining=True)),
    "MobilenetV2": (JB.MobilenetV2, lambda: PB.MobilenetV2(pretraining=True)),
    "MobilenetDilated": (JB.MobilenetDilated, lambda: PB.MobilenetDilated(pretraining=True)),
    "Resnet18": (JB.Resnet18, lambda: PB.Resnet18(pretraining=True)),
    "Resnet50": (JB.Resnet50, lambda: PB.Resnet50(pretraining=True)),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_pretraining_head_matches_jax(name):
    """Eval mode in float32. Train mode in float64 in both packages (flax
    under `jax.enable_x64`): at 32x32 the stride-32 features are 1x1, so a
    train-mode BatchNorm there normalises 2 values a channel, where float32
    rounding of a near-zero variance moves the logits by 1e-4 of their max
    in either package."""
    jcls, pmf = HEADS[name]
    pm = pmf()
    flat = random_flax_weights(_flax_shapes(jcls(pretraining=True), HW), seed=3)
    load_flax_weights(pm, flat)
    x = np.random.default_rng(4).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    v = nest(flat)
    variables = {"params": v["params"], "batch_stats": v.get("batch_stats", {})}
    jm = jcls(pretraining=True)
    want_eval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    jm64 = jcls(pretraining=True, dtype=jnp.float64)
    with jax.enable_x64(True):
        want_train, upd = jax.jit(lambda v, x: jm64.apply(
            v, x, train=True, mutable=["batch_stats"]))(_as64(variables),
                                                        jnp.asarray(x, jnp.float64))
        want_train = np.asarray(want_train)
        want_stats = _flat_tree(upd["batch_stats"], "batch_stats")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    pm64 = copy.deepcopy(pm).to(torch.float64)
    with torch.no_grad():
        got_eval = pm.eval()(xt)
        got_train = pm64.train()(xt.to(torch.float64))
    if got_eval.ndim == 4:      # MobilenetDilated: no head, NHWC features in JAX
        got_eval, got_train = got_eval.permute(0, 2, 3, 1), got_train.permute(0, 2, 3, 1)
    else:
        assert got_eval.shape == (2, 1000)
    _close(got_eval.numpy(), want_eval, f"{name} eval logits", LOGIT_RTOL)
    _close(got_train.numpy(), want_train, f"{name} train logits", LOGIT_RTOL)
    got_stats = {k: v for k, v in state_dict_to_flax(pm64.state_dict()).items()
                 if k.startswith("batch_stats/")}
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        err = np.abs(got_stats[k] - w)
        assert (err <= STATS_RTOL * np.maximum(1.0, np.abs(w))).all(), f"{k}: {err.max()}"


@pytest.mark.parametrize("name", ["MobilenetThin", "MobilenetSmall"])
def test_concat_backbones_cannot_pretrain_in_either_package(name):
    """Their concats join features of different strides once pretraining
    strides the late blocks, in both packages (ROADMAP Queue 3)."""
    x = np.zeros((1, *HW, 3), np.float32)
    with pytest.raises(Exception):
        jax.eval_shape(lambda: getattr(JB, name)(pretraining=True).init(
            jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    with pytest.raises(RuntimeError):
        getattr(PB, name)(pretraining=True)(torch.zeros(1, 3, *HW))


def test_fused_stem_refuses_pretraining():
    with pytest.raises(NotImplementedError):
        JB.VggTinyFusedStem(pretraining=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)), train=False)
    with pytest.raises(NotImplementedError):
        PB.VggTinyFusedStem(pretraining=True)
