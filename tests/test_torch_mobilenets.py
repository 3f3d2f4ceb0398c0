"""The port's VGG and MobileNet backbones (`Vgg16`, `Vgg19`, `MobilenetV1`,
`InvertedResidual`, `MobilenetV2`, `MobilenetThin`, `MobilenetSmall`) and
`jax_resize_nearest` against the JAX package's flax modules, in float32 on
the CPU, on the same seeded random weights (the keys and shapes of a flax
`init`, filled by `random_flax_weights`), and MobilenetV1 in int8 against
JAX's own depthwise-int8 test.

Tolerances: every output's max |delta| <= 1e-4 x its max |value| (float32
sums taken in other orders; measured below 1e-5); the nearest resize and
Vgg19's bf16 means exactly; each int8 conv bit for bit on the input JAX gave
it; the int8 MobilenetV1 against JAX's float output within JAX's own bounds
(tests/test_quant.py:69-83: relative error < 0.2, correlation > 0.98).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pifpaf import _assert_close, _flax_shapes
from test_torch_quant import assert_convs_exact_on_jax_inputs, jax_int8_convs
from torch_parity import nest
from hyperpose_tpu import quant as jquant
from hyperpose_tpu.models import backbones as JB
from hyperpose_torch import quant
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights, state_dict_to_flax

NAMES = ("Vgg16", "Vgg19", "MobilenetV1", "MobilenetV2", "MobilenetThin", "MobilenetSmall")


def _port_shapes(model):
    return {k: tuple(v.shape) for k, v in state_dict_to_flax(model.state_dict()).items()}


def _run_both(name, hw, seed, scale_size=8):
    jm = getattr(JB, name)(scale_size=scale_size)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=seed)
    x = np.random.default_rng(seed + 1).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x), train=False))
    model = load_flax_weights(getattr(PB, name)(scale_size=scale_size), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return model, got, want


# MobilenetThin and MobilenetSmall build only at scale 8 in flax: at 32 their
# concats join features of different strides.
@pytest.mark.parametrize("name,scale_size", [(n, 8) for n in NAMES] + [
    (n, 32) for n in ("Vgg16", "Vgg19", "MobilenetV1", "MobilenetV2")])
def test_weight_keys_match_jax_init(name, scale_size):
    """The flat flax keys and shapes of each backbone are those of a flax
    `init` of the JAX module (`conv_<b>/kernel|bias`, `sep_<i>/dw/dwconv`,
    `ir_<i>/expand|dw|project` with `bn0..2`, ...); `out_channels` is the
    width of its output."""
    jm = getattr(JB, name)(scale_size=scale_size)
    want = _flax_shapes(jm, (64, 64))
    port = getattr(PB, name)(scale_size=scale_size)
    assert _port_shapes(port) == want
    assert port.out_channels == jm.out_channels


@pytest.mark.parametrize("name,hw", [
    ("Vgg16", (64, 80)), ("Vgg19", (64, 80)), ("Vgg19", (57, 75)),
    ("MobilenetV1", (64, 80)), ("MobilenetV1", (57, 75)), ("MobilenetV2", (64, 80)),
    ("MobilenetV2", (57, 75)), ("MobilenetThin", (64, 80)), ("MobilenetSmall", (64, 80))])
def test_backbone_matches_jax(name, hw):
    """57x75 gives odd sizes, so the pools pad at the end and the stride-2
    convs pad asymmetrically."""
    _, got, want = _run_both(name, hw, seed=len(name) + hw[0])
    assert got.shape == want.shape
    _assert_close(got, want, f"{name} {hw}")


@pytest.mark.parametrize("name", ["Vgg16", "MobilenetV1", "MobilenetV2"])
def test_scale32_backbone_matches_jax(name):
    _, got, want = _run_both(name, (64, 64), seed=40, scale_size=32)
    assert got.shape == want.shape and got.shape[1:3] == (2, 2)
    _assert_close(got, want, f"{name} s32")


def test_mobilenet_shapes_and_identity_blocks():
    """MobilenetThin: stride 8, 1152 channels; MobilenetSmall: stride 4,
    704 channels; MobilenetV2 adds the identity only where the stride is 1
    and the widths are equal (ir_2, ir_4, ir_5, ir_7..9)."""
    thin, small, v2 = PB.MobilenetThin(), PB.MobilenetSmall(), PB.MobilenetV2()
    x = torch.zeros(1, 3, 64, 80)
    with torch.inference_mode():
        assert tuple(thin.eval()(x).shape) == (1, 1152, 8, 10)
        assert tuple(small.eval()(x).shape) == (1, 704, 16, 20)
    ids = [i for i in range(10) if getattr(v2, f"ir_{i}").identity]
    assert ids == [2, 4, 5, 7, 8, 9]
    assert v2.ir_0.expand is None and v2.ir_1.expand is not None


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (10, 14)), ((3, 9), (6, 18)),
                                          ((23, 27), (46, 54)), ((5, 7), (7, 9)),
                                          ((6, 6), (9, 4))])
def test_jax_resize_nearest_matches_jax(in_hw, out_hw):
    """Equal to `jax.image.resize(..., "nearest")` at factor 2 on odd and
    even sizes and at ratios that are not whole numbers, where torch's
    "nearest" would differ."""
    x = np.random.default_rng(3).standard_normal((2, *in_hw, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out_hw, 5), "nearest"))
    got = PB.jax_resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_vgg19_subtracts_the_means_in_the_compute_dtype():
    """The BGR means / 255, cast to the compute dtype as flax casts them,
    and subtracted in it: bf16 first-conv inputs equal JAX's bit for bit."""
    x = np.random.default_rng(4).uniform(0, 1, (1, 6, 8, 3)).astype(np.float32)
    mean = jnp.asarray(np.array([103.939, 116.779, 123.68], np.float32) / 255.0, jnp.bfloat16)
    want = np.asarray((jnp.asarray(x, jnp.bfloat16) - mean).astype(jnp.float32))
    model = PB.Vgg19(dtype=torch.bfloat16)
    assert "mean" not in model.state_dict()
    got = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16) - model.mean
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), want)


# -- MobilenetV1 in int8: JAX's depthwise-int8 test ----------------------------------------

def test_mobilenet_v1_int8_meets_jax_bounds():
    """JAX's `test_depthwise_grouped_conv` (tests/test_quant.py:69-83) on the
    port: MobilenetV1 at 64x64 on the weights of JAX's own `init`
    (PRNGKey(0)), calibrated by JAX on the same image; the port's int8
    network against JAX's float output: relative error < 0.2, correlation
    > 0.98. Each of its 19 int8 convs (the stem, 9 depthwise, 9 pointwise)
    equals JAX's `_quantized_conv` bit for bit on the input JAX gave it."""
    jm = JB.MobilenetV1(dtype=jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    x = np.asarray(np.random.default_rng(2).random((1, 64, 64, 3), np.float32))
    scales = jquant.calibrate(jm, variables, [jnp.asarray(x)], train=False)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False), np.float32)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]}
    model = load_flax_weights(PB.MobilenetV1(), flat).eval()
    quant.quantize_model(model, scales, weights=flat)
    convs = [m for m in model.modules() if isinstance(m, quant.Int8Conv2d)]
    assert len(convs) == len(scales) == 19 and sum(c.depthwise for c in convs) == 9
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    scale = max(np.abs(ref).max(), 1e-6)
    assert np.abs(ref - got).max() / scale < 0.2
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.98
    assert_convs_exact_on_jax_inputs(model, jax_int8_convs(jm, variables, x, scales))
