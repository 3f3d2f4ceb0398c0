"""The flagship's two exact serving stems in the port against the JAX package:
the checkpoint remaps, the fused stem's conv1+pool plain version, both stem
backbones and the whole LightWeightOpenPose on each.

Tolerances: the remaps are exact (the same numpy arithmetic); conv1_pool
atol and rtol 1e-4 (tests/test_fused_stem.py:41-49); the stem backbones atol
2e-4, rtol 1e-3 (tests/test_fused_stem.py:68-69, BN folded into the weights
changes the rounding); the full model atol 2e-4, rtol 1e-3 on maps of order 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest, random_flat
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_tpu.ops.pallas.stem_kernel import (
    fused_conv1_pool, fused_conv1_pool_reference,
)
from hyperpose_torch.models.backbones import (
    VggTiny, VggTinyFusedStem, VggTinyS2DStem, remap_vggtiny_to_fused,
    remap_vggtiny_to_s2d,
)
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.ops.kernels.conv1_pool import conv1_pool, conv1_pool_plain
from hyperpose_torch.utils.weights import (
    load_flax_weights, read_flax_weights, state_dict_to_flax,
)

REMAPS = {"s2d": (remap_vggtiny_to_s2d, JB.remap_vggtiny_to_s2d),
          "fused": (remap_vggtiny_to_fused, JB.remap_vggtiny_to_fused)}
STEMS = {"s2d": (VggTinyS2DStem, JB.VggTinyS2DStem),
         "fused": (VggTinyFusedStem,
                   lambda **kw: JB.VggTinyFusedStem(interpret=True, **kw))}


def _backbone_only(flat):
    """The backbone's keys of a whole-model flat dict, without `backbone/`."""
    return {k.replace("/backbone/", "/", 1): v for k, v in flat.items()
            if k.split("/")[1] == "backbone"}


# -- remaps ------------------------------------------------------------------

@pytest.mark.parametrize("form", ["s2d", "fused"])
@pytest.mark.parametrize("weights", ["flagship", "random"])
def test_remap_matches_jax_key_for_key(form, weights):
    flat = flagship_flat() if weights == "flagship" else random_flat(5)
    port, jax_remap = REMAPS[form]
    got = port(flat)
    want = read_flax_weights(jax_remap(nest(flat)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_remaps_leave_the_source_and_other_keys_alone():
    flat = flagship_flat()
    keep = {k: v.copy() for k, v in flat.items()}
    s2d = remap_vggtiny_to_s2d(FLAGSHIP_NPZ)
    fused = remap_vggtiny_to_fused(flat)
    assert sorted(flat) == sorted(keep)
    assert all(np.array_equal(flat[k], keep[k]) for k in keep)
    assert "params/backbone/s2d_1/conv/kernel" in s2d
    assert not any("/block_0/" in k or "/block_1/" in k for k in s2d)
    assert {"params/backbone/w1p", "params/backbone/b1p",
            "params/backbone/conv0p/kernel"} <= set(fused)
    assert not any("backbone/block_0/" in k or "backbone/block_1/" in k
                   for k in fused)
    np.testing.assert_array_equal(fused["params/cpm/init/kernel"],
                                  flat["params/cpm/init/kernel"])
    assert len(fused) == len(flat) - 10 + 4 and len(s2d) == len(flat)


# -- weights bridge: the fused stem's bare parameters ---------------------------

def test_fused_weights_round_trip_exactly():
    flat = remap_vggtiny_to_fused(flagship_flat())
    model = load_flax_weights(LightWeightOpenPose(backbone=VggTinyFusedStem), flat)
    assert model.backbone.w1p.shape == (3, 128, 128)
    np.testing.assert_array_equal(model.backbone.w1p.detach().numpy(),
                                  flat["params/backbone/w1p"])
    back = state_dict_to_flax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_bf16_fused_stem_keeps_its_bias_in_float32():
    flat = remap_vggtiny_to_fused(flagship_flat())
    model = load_flax_weights(
        LightWeightOpenPose(backbone=VggTinyFusedStem, dtype=torch.bfloat16), flat)
    assert model.backbone.w1p.dtype == torch.bfloat16
    assert model.backbone.b1p.dtype == torch.float32
    assert torch.equal(model.backbone.w1p,
                       torch.from_numpy(flat["params/backbone/w1p"]).bfloat16())


# -- conv1_pool's plain version ------------------------------------------------

def _conv1_inputs(shape=(2, 24, 16, 128), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape).astype(np.float32),
            rng.normal(0, 0.1, (3, 128, 128)).astype(np.float32),
            rng.normal(0, 0.1, (128,)).astype(np.float32))


@pytest.mark.parametrize("oracle", ["pallas", "reference"])
def test_conv1_pool_plain_matches_jax(oracle):
    a, w, b = _conv1_inputs()
    args = (jnp.asarray(a), jnp.asarray(w), jnp.asarray(b))
    want = (fused_conv1_pool(*args, interpret=True) if oracle == "pallas"
            else fused_conv1_pool_reference(*args))
    got = conv1_pool_plain(*(torch.from_numpy(t) for t in (a, w, b)))
    assert tuple(got.shape) == (2, 12, 16, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_conv1_pool_plain_bf16_matches_jax_reference():
    """bf16 in, f32 sums and bias, bf16 out: within one bf16 ulp."""
    a, w, b = _conv1_inputs((1, 8, 6, 128), seed=1)
    a16 = jnp.asarray(a, jnp.bfloat16)
    w16 = jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(fused_conv1_pool_reference(a16, w16, jnp.asarray(b)),
                      np.float32)
    got = conv1_pool_plain(torch.from_numpy(a).bfloat16(),
                           torch.from_numpy(w).bfloat16(), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2, rtol=1e-2)


def test_conv1_pool_reads_strided_channels_last_input():
    """The stem hands over the permuted channels-last conv0p output."""
    a, w, b = _conv1_inputs((1, 6, 5, 128), seed=2)
    nchw = torch.from_numpy(a).permute(0, 3, 1, 2)          # channels-last NCHW
    got = conv1_pool(nchw.permute(0, 2, 3, 1), torch.from_numpy(w),
                     torch.from_numpy(b))
    want = conv1_pool_plain(torch.from_numpy(a), torch.from_numpy(w),
                            torch.from_numpy(b))
    assert torch.equal(got, want)


def test_conv1_pool_cpu_counts_no_launch_and_meta_raises():
    a, w, b = (torch.from_numpy(t) for t in _conv1_inputs((1, 4, 3, 128)))
    before = conv1_pool.launches
    assert torch.equal(conv1_pool(a, w, b), conv1_pool_plain(a, w, b))
    assert conv1_pool.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        conv1_pool(a.to("meta"), w.to("meta"), b.to("meta"))


# -- stem backbones and the whole model -----------------------------------------

@pytest.mark.parametrize("form", ["s2d", "fused"])
def test_stem_backbone_matches_jax(form):
    """Each stem against its JAX counterpart on remapped random-BN weights."""
    flat = random_flat(3)
    port_remap, jax_remap = REMAPS[form]
    port_cls, jax_cls = STEMS[form]
    tree = jax_remap(nest(flat))
    jax_vars = {c: tree[c]["backbone"] for c in tree if "backbone" in tree[c]}
    x = np.random.default_rng(4).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jax_cls(dtype=jnp.float32).apply(jax_vars, jnp.asarray(x)))
    model = load_flax_weights(port_cls(), _backbone_only(port_remap(flat))).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 6, 8, 384)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("form", ["s2d", "fused"])
def test_stem_backbone_matches_port_vggtiny(form):
    full = random_flat(6)
    plain = load_flax_weights(VggTiny(), _backbone_only(full)).eval()
    stem = load_flax_weights(STEMS[form][0](),
                             _backbone_only(REMAPS[form][0](full))).eval()
    x = torch.from_numpy(
        np.random.default_rng(8).uniform(0, 1, (1, 3, 40, 56)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(stem(x), plain(x), atol=2e-4, rtol=1e-3)


_jax_plain = JaxLwOpenPose(backbone=JB.VggTiny, dtype=jnp.float32)
_jax_apply = jax.jit(lambda v, x: _jax_plain.apply(v, x, train=False))


@pytest.mark.parametrize("form", ["s2d", "fused"])
def test_flagship_on_each_stem_matches_jax_plain_model(form):
    flat = flagship_flat()
    x = np.random.default_rng(9).uniform(0, 1, (2, 96, 112, 3)).astype(np.float32)
    ref = _jax_apply(nest(flat), jnp.asarray(x))
    model = load_flax_weights(
        LightWeightOpenPose(backbone=STEMS[form][0]), REMAPS[form][0](flat)).eval()
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    for key in ("conf_map", "paf_map"):
        want = np.asarray(ref[key])
        assert out[key].shape == want.shape == (2, 12, 14, want.shape[-1])
        np.testing.assert_allclose(out[key].numpy(), want, atol=2e-4, rtol=1e-3,
                                   err_msg=key)


@pytest.mark.parametrize("cls", [VggTinyS2DStem, VggTinyFusedStem])
def test_stems_refuse_odd_sizes(cls):
    model = cls().eval()
    with pytest.raises(ValueError, match="even"):
        model(torch.zeros(1, 3, 16, 17))


def test_fused_stem_refuses_training():
    with pytest.raises(NotImplementedError, match="serving-only"):
        VggTinyFusedStem().train()(torch.zeros(1, 3, 16, 16))
