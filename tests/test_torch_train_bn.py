"""The port's train-mode BatchNorm (`FlaxBatchNorm2d`,
`hyperpose_torch/models/backbones.py`) against flax's, on the CPU.

- One layer against flax `nn.BatchNorm(use_fast_variance=False)` at each
  momentum (0.9, 0.99, 0.999) on float32 and bfloat16 inputs: output and
  running statistics within 1e-6 x max(1, |v|) (bfloat16 outputs within one
  bfloat16 ulp).
- One train-mode forward of each family against flax
  `apply(train=True, mutable=["batch_stats"])` from the same seeded
  weights, with each layer's own momentum:
  - in float64 (`jax.enable_x64`, both networks' parameters, statistics
    and compute in float64; MobileNet-Thin at 24x32 and MobileNet-Small at
    16x24, `X64_HW`): every output within 1e-6 x its max |value| and every
    running mean and variance within 1e-6 x max(1, |v|);
  - in float32: every output within 5e-4 x its max |value| and every
    statistic within 3e-5 x max(1, |v|). Those are float32's bounds, not
    the port's: each package's float32 forward lands up to 1.7e-4 x the
    outputs' max (MobileNet-Thin) and 1.1e-5 in the statistics (ResNet50's
    deepest layers) from the float64 forward that the two packages share
    to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_openpose_family import _hashable
from test_torch_pifpaf import _flax_shapes
from test_torch_train import X64_RTOL, _flat_tree, _rel_close, _stats_close, as64
from torch_parity import nest
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models import pifpaf as JPF
from hyperpose_tpu.models import pose_proposal as JPP
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models import pifpaf as PPF
from hyperpose_torch.models import pose_proposal as PPP
from hyperpose_torch.train.trainer import as_master
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

FAMILIES = {  # name -> (flax module of a dtype, port module, input size, BN momenta it holds)
    "lw_vggtiny": (lambda dt: JO.LightWeightOpenPose(backbone=JB.VggTiny, num_channels=32,
                                                     dtype=dt),
                   lambda: PO.LightWeightOpenPose(backbone=PB.VggTiny, num_channels=32),
                   (64, 80), {0.9, 0.99}),
    "lw_mobilenet": (lambda dt: JO.LightWeightOpenPose(num_channels=32, dtype=dt),
                     lambda: PO.LightWeightOpenPose(num_channels=32), (64, 80),
                     {0.999, 0.99}),
    "lw_mobilenetv2": (lambda dt: JO.LightWeightOpenPose(backbone=JB.MobilenetV2,
                                                         num_channels=32, dtype=dt),
                       lambda: PO.LightWeightOpenPose(backbone=PB.MobilenetV2, num_channels=32),
                       (64, 80), {0.9, 0.99}),
    "mbthin": (lambda dt: _hashable(JO.MobilenetThinOpenpose(dtype=dt)),
               PO.MobilenetThinOpenpose, (64, 80), {0.9, 0.99}),
    "mbsmall": (lambda dt: _hashable(JO.MobilenetSmallOpenpose(dtype=dt)),
                PO.MobilenetSmallOpenpose, (64, 80), {0.9, 0.99, 0.999}),
    "ppn": (lambda dt: JPP.PoseProposal(hin=128, win=128, dtype=dt),
            lambda: PPP.PoseProposal(hin=128, win=128), (128, 128), {0.9}),
    "pifpaf": (lambda dt: JPF.Pifpaf(hin=64, win=64, dtype=dt),
               lambda: PPF.Pifpaf(hin=64, win=64), (64, 64), {0.9}),
}
# XLA on the CPU runs float64 depthwise convs slowly (MobileNet-Small's 7x7
# refinement took 270 s at 64x80): the float64 forward of these two is smaller.
X64_HW = {"mbthin": (24, 32), "mbsmall": (16, 24)}


def _forwards(name, dtype):
    """(flax outputs, flax batch_stats, port outputs, port flat state) of one
    train-mode forward of the family in `dtype` from seed-3 weights."""
    jmf, pmf, hw, momenta = FAMILIES[name]
    x64 = dtype == "float64"
    if x64:
        hw = X64_HW.get(name, hw)
    flat = random_flax_weights(_flax_shapes(jmf(jnp.float32), hw), seed=3)
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    jm = jmf(jnp.float64 if x64 else jnp.float32)
    with jax.enable_x64(x64):
        v = as64(nest(flat)) if x64 else nest(flat)
        want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x, jnp.float64 if x64 else jnp.float32))
        want = {k: np.asarray(w) for k, w in want.items()}
        stats = _flat_tree(upd["batch_stats"], "batch_stats")
    model = load_flax_weights(pmf(), flat)
    if x64:
        as_master(model, torch.float64)
    model.train()
    assert {m.decay for m in model.modules() if isinstance(m, PB.FlaxBatchNorm2d)} == momenta
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.float64 if x64 else torch.float32))
    return want, stats, got, state_dict_to_flax(model.state_dict())


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_mode_batchnorm_matches_flax(name):
    want, stats, got, flat = _forwards(name, "float32")
    keys = [k for k in want if k not in ("stage_confs", "stage_pafs")]
    for k in keys:
        _rel_close(got[k].numpy(), want[k], k, 5e-4)
    _stats_close(flat, stats)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_mode_batchnorm_float64_matches_flax_float64(name):
    want, stats, got, flat = _forwards(name, "float64")
    keys = [k for k in want if k not in ("stage_confs", "stage_pafs")]
    for k in keys:
        _rel_close(got[k].numpy(), want[k], k, X64_RTOL)
    _stats_close(flat, stats, X64_RTOL)


@pytest.mark.parametrize("momentum", [0.9, 0.99, 0.999])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_layer_matches_flax(momentum, dtype):
    from flax import linen as fnn

    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 6, 7, 16)) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.standard_normal(16) * 0.1
    mean, var = rng.standard_normal(16) * 0.1, rng.uniform(0.5, 1.5, 16)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    bn = fnn.BatchNorm(use_running_average=False, use_fast_variance=False, momentum=momentum,
                       epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": jnp.asarray(scale, jnp.float32), "bias": jnp.asarray(bias, jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(mean, jnp.float32),
                         "var": jnp.asarray(var, jnp.float32)}}
    want, upd = jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"]))(
        v, jnp.asarray(x, jdt))
    layer = PB.FlaxBatchNorm2d(16, momentum).train()
    with torch.no_grad():
        for t, a in ((layer.weight, scale), (layer.bias, bias), (layer.running_mean, mean),
                     (layer.running_var, var)):
            t.copy_(torch.from_numpy(a))
        got = layer(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    w = np.asarray(want.astype(jnp.float32))
    tol = 1e-6 * np.maximum(1, np.abs(w)) if dtype == "float32" else np.abs(w) * 2 ** -7
    assert (np.abs(got.float().numpy() - w) <= tol).all()
    for t, k in ((layer.running_mean, "mean"), (layer.running_var, "var")):
        np.testing.assert_allclose(t.numpy(), np.asarray(upd["batch_stats"][k]), rtol=1e-6,
                                   atol=1e-7)


def test_batchnorm_keeps_the_biased_variance():
    bn = PB.FlaxBatchNorm2d(3, momentum=0.9).train()
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bn(x)
    batch_var = x.permute(1, 0, 2, 3).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * batch_var, rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm2d(3, momentum=0.1).train()
    ref(x)
    assert not torch.allclose(bn.running_var, ref.running_var)   # torch keeps it unbiased
