"""The port's OpenPose family (`OpenPose` with `PRelu` on `Vgg19`,
`MobilenetThinOpenpose`, `MobilenetSmallOpenpose` with its `SeparableConv`,
and `LightWeightOpenPose` on its default `MobilenetDilated` with its knobs)
against the JAX package's flax modules, in float32 on the CPU, on the same
seeded random weights (the keys and shapes of a flax `init`, filled by
`random_flax_weights`), in float and int8, through each package's
`PoseEngine`.

The flax Thin and Small models hold their stage plans as lists, which
`jax.eval_shape` cannot hash; the tests build them with the same plans as
tuples (`_hashable`), the same network.

Tolerances: every output's max |delta| <= 1e-4 x its max |value| (float32
sums of up to 30 layers taken in other orders); PReLU, each int8 conv and
the calibrated convs' keys exactly; abs-max scales within 1e-5 relative;
the decoded people of the two engines equal as sets of humans within 1e-4
(coords and scores); the int8 Lightweight-OpenPose's maps within 0.15 of
their range of the float network's (JAX's own int8-vs-float bound,
tests/test_quant.py:53).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pifpaf import _assert_close, _flax_shapes
from test_torch_pifpaf_decode import assert_same_humans
from test_torch_quant import assert_convs_exact_on_jax_inputs, jax_int8_convs
from torch_parity import nest, synth_frame_rgb
from hyperpose_tpu import quant as jquant
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_torch import quant
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")
KNOBS = dict(n_confmaps=15, n_pafmaps=28)


def _hashable(jm):
    return jm.clone(init_plan=tuple(jm.init_plan), ref_plan=tuple(jm.ref_plan))


# name -> (JAX module, port module factory (dtype), input size, heads' last bias
# leaves, int8 convs, of which depthwise, the engines' tolerance on coords and
# scores)
MODELS = {
    "openpose": (lambda: JO.OpenPose(), lambda dt: PO.OpenPose(dtype=dt), (32, 40),
                 ("ref4_conf/out/conv/bias", "ref4_paf/out/conv/bias"), 92, 0, 1e-4),
    "mbthin": (lambda: _hashable(JO.MobilenetThinOpenpose()),
               lambda dt: PO.MobilenetThinOpenpose(dtype=dt), (64, 80),
               ("ref4_conf/out/bn2/bias", "ref4_paf/out/bn2/bias"), 143, 71, 1e-3),
    "mbsmall": (lambda: _hashable(JO.MobilenetSmallOpenpose()),
                lambda dt: PO.MobilenetSmallOpenpose(dtype=dt), (64, 80),
                ("ref3_conf/out/bn/bias", "ref3_paf/out/bn/bias"), 15, 7, 1e-4),
    "lw_mobilenet": (lambda: JO.LightWeightOpenPose(),
                     lambda dt: PO.LightWeightOpenPose(dtype=dt), (64, 80),
                     ("ref_heads/conf2/bias", "ref_heads/paf2/bias"), 54, 11, 1e-4),
}


def _port_shapes(model):
    return {k: tuple(v.shape) for k, v in state_dict_to_flax(model.state_dict()).items()}


def _frames(hw, seed):
    """The synthetic frame and a uniform-random one, uint8 [2, H, W, 3]."""
    rng = np.random.default_rng(seed)
    return np.stack([resize_bilinear(synth_frame_rgb(), hw),
                     rng.integers(0, 256, (*hw, 3), dtype=np.uint8)])


def _flat(name, seed):
    jm, _, hw, *_ = MODELS[name]
    return random_flax_weights(_flax_shapes(jm(), hw), seed=seed)


@pytest.mark.parametrize("name", list(MODELS))
def test_weight_keys_match_jax_init(name):
    """The flat flax keys and shapes of each model are those of a flax
    `init` of the JAX model: PReLU slopes `.../prelu/alpha`, the bare
    `sep/{dw_kernel,pw_kernel,bias}` of SeparableConv, `dw/dwconv/kernel`
    [3, 3, 1, C] of the depthwise convs."""
    jm, pm, hw, *_ = MODELS[name]
    want = _flax_shapes(jm(), hw)
    assert _port_shapes(pm(torch.float32)) == want
    probe = {"openpose": ("params/ref0_conf/l0/prelu/alpha", (128,)),
             "mbsmall": ("params/ref0_paf/l0/sep/dw_kernel", (7, 7, 1, 761)),
             "mbthin": ("params/ref0_conf/out/dw/dwconv/kernel", (1, 1, 1, 128)),
             "lw_mobilenet": ("params/backbone/sep_6/dw/dwconv/kernel", (3, 3, 1, 512))}
    key, shape = probe[name]
    assert want[key] == shape


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    """Every output of the flax model's dict: the maps, each stage's maps.
    OpenPose runs at 32x40 with its full 5 refinements (4x5 maps);
    MobileNet-Small gives stride-4 maps (16x20 at 64x80)."""
    jm, pm, hw, *_ = MODELS[name]
    flat = _flat(name, seed=1)
    x = np.random.default_rng(2).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jm().apply(nest(flat), jnp.asarray(x), train=False)
    model = load_flax_weights(pm(torch.float32), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    stride = 4 if name == "mbsmall" else 8
    assert tuple(got["paf_map"].shape) == (2, hw[0] // stride, hw[1] // stride, 38)
    assert sorted(got) == sorted(want)
    for key in ("conf_map", "paf_map"):
        _assert_close(got[key].numpy(), np.asarray(want[key]), key)
    for key in ("stage_confs", "stage_pafs"):
        assert len(got[key]) == len(want[key]) == {"openpose": 6, "mbthin": 6,
                                                     "mbsmall": 5}.get(name, 2)
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            _assert_close(g.numpy(), np.asarray(w), f"{key}[{i}]")


@pytest.mark.parametrize("name", ["lw", "openpose", "mbthin", "mbsmall"])
def test_knobs_and_backbone_features_match_jax(name):
    """The knobs: 15 conf and 28 PAF maps; Lightweight-OpenPose 64 channels
    wide; OpenPose with 2 refinements on another backbone (VggTiny), whose
    `num_channels` changes nothing, as in flax; Thin and Small on another
    backbone. `ret_backbone` adds `backbone_features` (the backbone's
    output; OpenPose's cpm features) when the model is built with it, and
    nothing without it."""
    hw = (32, 40)
    if name == "lw":
        jm = JO.LightWeightOpenPose(num_channels=64, **KNOBS)
        pm = PO.LightWeightOpenPose(num_channels=64, ret_backbone=True, **KNOBS)
    elif name == "openpose":
        jm = JO.OpenPose(num_channels=64, backbone=JB.VggTiny, n_refinements=2, **KNOBS)
        pm = PO.OpenPose(num_channels=64, backbone=PB.VggTiny, n_refinements=2,
                         ret_backbone=True, **KNOBS)
    else:
        maker = "MobilenetThinOpenpose" if name == "mbthin" else "MobilenetSmallOpenpose"
        jm = _hashable(getattr(JO, maker)(backbone=JB.MobilenetV1, **KNOBS))
        pm = getattr(PO, maker)(backbone=PB.MobilenetV1, ret_backbone=True, **KNOBS)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=3)
    assert _port_shapes(pm) == _flax_shapes(jm, hw)
    x = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jm.apply(nest(flat), jnp.asarray(x), train=False, ret_backbone=True)
    load_flax_weights(pm, flat).eval()
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
        pm.ret_backbone = False
        plain = pm(torch.from_numpy(x))
    assert "backbone_features" not in plain
    assert got["conf_map"].shape[-1] == 15 and got["paf_map"].shape[-1] == 28
    for key in ("conf_map", "paf_map", "backbone_features"):
        _assert_close(got[key].numpy(), np.asarray(want[key]), key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prelu_matches_jax(dtype):
    """`where(x >= 0, x, alpha * x)` with alpha cast to x's dtype: exact,
    zeros and negative zeros included."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, -0.0, -1e-30]
    alpha = rng.uniform(0.05, 0.5, 6).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = JO.PRelu(dtype=jdt).apply({"params": {"alpha": alpha}}, jnp.asarray(x, jdt))
    m = PO.PRelu(6, getattr(torch, dtype))
    m.alpha.data.copy_(torch.from_numpy(alpha))
    xt = torch.from_numpy(np.array(jnp.asarray(x, jdt).astype(jnp.float32)))
    with torch.inference_mode():
        got = m(xt.to(getattr(torch, dtype)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert np.signbit(got.float().numpy()[0, 0, 0, 1]) == np.signbit(
        np.asarray(want.astype(jnp.float32))[0, 0, 0, 1])


@pytest.mark.parametrize("block,k,act", [("sepconv", 3, True), ("sepconv", 7, False),
                                         ("small", 7, True), ("small", 1, False),
                                         ("thin", 3, True), ("thin", 1, False)])
def test_separable_blocks_match_jax(block, k, act):
    """SeparableConv (the depthwise and 1x1 convs of bare parameters, the
    bias added after them), `_SepSmallBlock` (its act inside the separable
    conv and again after BN) and `_SepBNBlock` (act after both BNs; None on
    an output block, whose depthwise conv is 1x1)."""
    from flax import linen as fnn

    cin, f, hw = 24, 20, (9, 11)
    a = fnn.relu if act else None
    pa = torch.relu if act else None
    if block == "sepconv":
        jm, pm = JO.SeparableConv(f, (k, k), act=a), PO.SeparableConv(cin, f, k, pa)
    elif block == "small":
        jm, pm = JO._SepSmallBlock(f, (k, k), act=a), PO._SepSmallBlock(cin, f, k, pa)
    else:
        jm, pm = JO._SepBNBlock(f, (k, k), act=a), PO._SepBNBlock(cin, f, k, pa)
    x = np.random.default_rng(6).standard_normal((2, *hw, cin)).astype(np.float32)
    import jax
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = random_flax_weights(
        {"/".join(str(getattr(p, "key", p)) for p in path): tuple(v.shape)
         for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}, seed=7)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x)))
    holder = torch.nn.Module()   # the flax module's leaves sit at the top level
    holder.blk = pm
    load_flax_weights(holder, {k.replace("/", "/blk/", 1): v for k, v in flat.items()})
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _assert_close(got, want, block)
    assert (want < 0).any() != act
    holds_conv = any(isinstance(m, torch.nn.Conv2d) for m in pm.modules())
    assert holds_conv == (block == "thin")


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_matches_jax(name):
    """Each model on the two packages' PAF engines (`device="cpu"` for the
    port) decodes the same people from the same two frames. The last
    stage's output biases are raised by 1, so that the maps hold peaks and
    limbs above the decoder's thresholds: on the seeded weights alone
    neither package finds a human. MobileNet-Thin runs 61 layers in a row
    (its backbone and six stages of five separable blocks), and its people
    agree within 1e-3 (measured 1.2e-4 px and 7.8e-4 on scores of 5.8 to
    8.3, 1e-4 of them); the others within 1e-4 (measured below 4.2e-5)."""
    jm, pm, hw, heads, _, _, atol = MODELS[name]
    flat = _flat(name, seed=8)
    for leaf in heads:
        flat[f"params/{leaf}"] += np.float32(1.0)
    frames = _frames(hw, seed=9)
    jeng = JaxPoseEngine(jm(), nest(flat), input_hw=hw, max_batch_size=2)
    teng = PoseEngine(pm(torch.float32), flat, input_hw=hw, max_batch_size=2, device="cpu")
    w = jeng.infer_batch_device(jnp.asarray(frames))
    g = teng.infer_batch_device(frames)
    w = {f: np.asarray(getattr(w, f)) for f in FIELDS}
    g = {f: getattr(g, f).numpy() for f in FIELDS}
    assert int(g["valid"].sum()) > 0, "degenerate decode"
    assert_same_humans(g, w, atol)


# -- int8 ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_calibrate_records_the_convs_jax_records(name):
    """The port's calibration (hooks on every `nn.Conv2d`) records the
    convs JAX's (an interceptor on every `nn.Conv`) records, in its order:
    92 in OpenPose, 143 in MobileNet-Thin (71 depthwise), 54 in
    Lightweight-OpenPose (11 depthwise), and in MobileNet-Small only its
    backbone's 15 (7 depthwise): its stages' SeparableConvs are no
    `nn.Conv` in flax and hold no `nn.Conv2d` here, so int8 leaves them
    float in both packages."""
    jm, pm, hw, _, n, n_dw, _ = MODELS[name]
    flat = _flat(name, seed=10)
    x = np.random.default_rng(11).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = jquant.calibrate(jm(), nest(flat), [jnp.asarray(x)], train=False)
    model = load_flax_weights(pm(torch.float32), flat).eval()
    got = quant.calibrate(model, [torch.from_numpy(x)])
    assert list(got) == list(want) and len(got) == n
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-5, atol=0)
    quant.quantize_model(model, got, weights=flat)
    convs = [m for m in model.modules() if isinstance(m, quant.Int8Conv2d)]
    assert len(convs) == n and sum(c.depthwise for c in convs) == n_dw
    assert not any(type(m) is torch.nn.Conv2d for m in model.modules())
    if name == "mbsmall":
        seps = [m for m in model.modules() if isinstance(m, PO.SeparableConv)]
        assert len(seps) == 2 * 5 * 5 and all(k.startswith("backbone/") for k in got)


# name -> (JAX module, port module factory (dtype), input size, int8 convs, of
# which depthwise) of the captured-input test: every conv keeps its kernel,
# channels, stride and dilation at these sizes; OpenPose keeps one of its
# five identical refinement stages, MobilenetV2 is the backbone alone.
CAPTURED = {name: (MODELS[name][0], MODELS[name][1], MODELS[name][2], *MODELS[name][4:6])
            for name in ("lw_mobilenet", "mbthin", "mbsmall")}
CAPTURED["openpose"] = (lambda: JO.OpenPose(n_refinements=1),
                        lambda dt: PO.OpenPose(dtype=dt, n_refinements=1), (32, 40), 36, 0)
CAPTURED["mobilenet_v2"] = (lambda: JB.MobilenetV2(), lambda dt: PB.MobilenetV2(dtype=dt),
                            (64, 80), 30, 10)


@pytest.mark.parametrize("name", list(CAPTURED))
def test_int8_convs_exact_on_jax_captured_inputs(name):
    """Every int8 conv of each model, on the very input JAX's
    `quantized_apply` gave the conv of the same path (the synthetic frame,
    JAX's scale table), equals JAX's `_quantized_conv` bit for bit: the
    depthwise convs, whose forward is the fused `int8_dwconv`'s plain
    version, of MobilenetDilated (dilation 2 in sep_6, stride 2),
    MobileNet-Thin's stages (1209-channel 3x3 and 1x1) and MobilenetV2's
    inverted residuals (32 to 384 channels, strides 1 and 2, after their
    expansion convs); OpenPose's 7x7 convs on 185 channels (Cp 192) and
    its PReLU stages."""
    jm, pm, hw, n, n_dw = CAPTURED[name]
    flat = random_flax_weights(_flax_shapes(jm(), hw), seed=12)
    x = resize_bilinear(synth_frame_rgb(), hw)[None].astype(np.float32) / 255.0
    scales = jquant.calibrate(jm(), nest(flat), [jnp.asarray(x)], train=False)
    seen = jax_int8_convs(jm(), nest(flat), x, scales)
    assert len(seen) == n
    model = load_flax_weights(pm(torch.float32), flat).eval()
    quant.quantize_model(model, scales, weights=flat)
    assert sum(m.depthwise for m in model.modules() if isinstance(m, quant.Int8Conv2d)) == n_dw
    assert_convs_exact_on_jax_inputs(model, seen)


def test_quantize_engine_on_the_default_lightweight_openpose():
    """`quantize_engine` builds the int8 `LightWeightOpenPose()` (it raised
    on its depthwise convs before they were ported): 54 int8 convs, 11 of
    them depthwise, no launch on the CPU; its maps within 0.15 of their
    range of the float engine's."""
    _, pm, hw, *_ = MODELS["lw_mobilenet"]
    flat = _flat("lw_mobilenet", seed=13)
    frames = _frames(hw, seed=14)
    eng = PoseEngine(pm(torch.float32), flat, input_hw=hw, max_batch_size=2, device="cpu")
    qeng = quant.quantize_engine(eng, [frames])
    convs = [m for m in qeng.model.modules() if isinstance(m, quant.Int8Conv2d)]
    assert len(convs) == len(qeng.quant_scales) == 54
    assert sum(c.depthwise for c in convs) == 11
    from hyperpose_torch.ops.kernels.int8_gemm import int8_dwconv

    before = int8_dwconv.launches
    qeng.infer_batch_device(frames)
    assert int8_dwconv.launches == before
    x = torch.from_numpy(frames).to(torch.float32) / 255.0
    with torch.inference_mode():
        ref, got = eng.model(x), qeng.model(x)
    for key in ("conf_map", "paf_map"):
        r, g = ref[key].numpy(), got[key].numpy()
        assert np.abs(g - r).max() / np.abs(r).max() < 0.15, key


def test_conv_operations_counts_separable_convs():
    """`torch_measures.conv_operations` counts SeparableConv's two convs on
    bare parameters (no `nn.Conv2d` to hook): 2 * H * W * cin * k * k for
    the depthwise one and 2 * H * W * cin * f for the 1x1 one, per image."""
    from torch_measures import conv_operations

    class _Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.sep = PO.SeparableConv(24, 20, 7)

        def forward(self, x):
            return self.sep(x.permute(0, 3, 1, 2))

    assert conv_operations(_Net(), (2, 9, 11, 24)) == 2 * 2 * 9 * 11 * 24 * (49 + 20)
