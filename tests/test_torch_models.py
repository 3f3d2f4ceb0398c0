"""The port's flagship forward (LightWeightOpenPose on VggTiny) against the
JAX package's `model.apply`, in float32 on the CPU.

Tolerance: atol 1e-4 on conf/paf maps of order 1, for about 20 conv layers
whose float32 sums are taken in another order by the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import flagship_flat, nest, random_flat
from hyperpose_tpu.models.backbones import VggTiny as JaxVggTiny
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.utils.weights import load_flax_weights

ATOL = 1e-4

_jax_model = JaxLwOpenPose(backbone=JaxVggTiny, dtype=jnp.float32)
_jax_apply = jax.jit(lambda v, x: _jax_model.apply(v, x, train=False))


@pytest.mark.parametrize("weights,hw", [
    ("flagship", (96, 112)),
    ("random", (96, 112)),
    ("flagship", (100, 116)),   # odd sizes: ceil-mode pools (50->25->13)
])
def test_forward_matches_jax(weights, hw):
    flat = flagship_flat() if weights == "flagship" else random_flat(1)
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 1.0, (2, *hw, 3)).astype(np.float32)
    ref = _jax_apply(nest(flat), jnp.asarray(x))
    model = load_flax_weights(LightWeightOpenPose(), flat).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    feat = (-(-hw[0] // 8), -(-hw[1] // 8))
    assert tuple(out["conf_map"].shape) == (2, *feat, 19)
    assert tuple(out["paf_map"].shape) == (2, *feat, 38)
    for key in ("conf_map", "paf_map"):
        want = np.asarray(ref[key])
        got = out[key].numpy()
        assert np.abs(want).max() > 1e-3, f"{key}: degenerate reference"
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=key)
    for stage in range(2):
        np.testing.assert_allclose(
            out["stage_pafs"][stage].numpy(), np.asarray(ref["stage_pafs"][stage]),
            rtol=0, atol=ATOL)


def test_nhwc_in_nhwc_out_and_channels_last():
    """The network takes NHWC images and gives NHWC maps, also when its
    weights are in channels-last memory, as the engine keeps them on the
    card."""
    flat = flagship_flat()
    x = torch.from_numpy(
        np.random.default_rng(3).uniform(0, 1, (1, 64, 72, 3)).astype(np.float32))
    model = load_flax_weights(LightWeightOpenPose(), flat).eval()
    with torch.inference_mode():
        a = model(x)["paf_map"]
        b = model.to(memory_format=torch.channels_last)(x)["paf_map"]
    assert tuple(a.shape) == (1, 8, 9, 38)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=ATOL)


def test_bf16_forward_tracks_f32():
    """The serving dtype: bf16 weights and activations stay near f32
    (bf16 keeps ~3 significant digits, so the bound is loose)."""
    flat = flagship_flat()
    x = torch.from_numpy(
        np.random.default_rng(4).uniform(0, 1, (1, 64, 72, 3)).astype(np.float32))
    f32 = load_flax_weights(LightWeightOpenPose(), flat).eval()
    bf16 = load_flax_weights(LightWeightOpenPose(dtype=torch.bfloat16), flat).eval()
    with torch.inference_mode():
        a = f32(x)["conf_map"]
        b = bf16(x)["conf_map"]
    assert b.dtype == torch.bfloat16
    assert float((a - b.float()).abs().max()) < 0.1 * float(a.abs().max())
