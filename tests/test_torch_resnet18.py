"""The port's Resnet18 trunk, its ConvBN options and Lightweight-OpenPose on
Resnet18 against the JAX package's flax modules, in float32 on the CPU, on
the same seeded random weights (the keys and shapes of a flax `init` of the
JAX module, filled by `random_flax_weights`).

Tolerances: every output's max |delta| <= 1e-4 x its max |value| (18 to 49
conv layers whose float32 sums the two frameworks take in other orders;
measured about 1.3e-6); the decoded people of the two Lightweight-OpenPose
engines equal as sets of humans within 1e-4 (coords and scores); a ConvBN
at its defaults equals conv -> BatchNorm -> ReLU written out, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_pifpaf import _assert_close, _flax_shapes
from test_torch_pifpaf_decode import assert_same_humans
from torch_measures import conv_operations
from torch_parity import nest, synth_frame_rgb
from hyperpose_tpu.models.backbones import Resnet18 as JaxResnet18
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_tpu.models.pose_proposal import PoseProposal as JaxPoseProposal
from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
from hyperpose_torch.models.backbones import (
    ConvBN, MobilenetDilated, Resnet18, Resnet50, VggTiny, same_pads,
)
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.models.pose_proposal import PoseProposal
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _port_shapes(model):
    return {k: tuple(v.shape) for k, v in state_dict_to_flax(model.state_dict()).items()}


@pytest.mark.parametrize("name", ["resnet18_s8", "resnet18_s32", "ppn", "lw_resnet18"])
def test_weight_keys_match_jax_init(name):
    """The flat flax keys and shapes of the port's modules are those of a
    flax `init` of the JAX modules: `backbone/stem/conv/kernel`,
    `backbone/b3_1/ds/bn/mean`, `add1/conv/bias`, `head/kernel` ..."""
    port, jax_module = {
        "resnet18_s8": (Resnet18(), JaxResnet18()),
        "resnet18_s32": (Resnet18(scale_size=32), JaxResnet18(scale_size=32)),
        "ppn": (PoseProposal(), JaxPoseProposal()),
        "lw_resnet18": (LightWeightOpenPose(backbone=Resnet18),
                        JaxLwOpenPose(backbone=JaxResnet18)),
    }[name]
    want = _flax_shapes(jax_module, (64, 64))
    assert _port_shapes(port) == want
    if name == "ppn":
        for key in ("params/backbone/stem/conv/kernel", "batch_stats/backbone/b3_1/ds/bn/mean",
                    "params/add1/conv/bias", "params/head/kernel", "params/head/bias"):
            assert key in want, key
        assert want["params/head/kernel"] == (1, 1, 512, 6 * 18 + 81 * 17)


@pytest.mark.parametrize("scale_size,hw", [(8, (64, 80)), (32, (64, 80)), (32, (72, 88))])
def test_resnet18_trunk_matches_jax(scale_size, hw):
    """At scale 32, 72x88 gives odd sizes (36x44 -> 18x22 -> 9x11 -> 5x6 ->
    3x3), so stride-2 convs and the max pool pad asymmetrically."""
    jm = JaxResnet18(scale_size=scale_size)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x), train=False))
    model = load_flax_weights(Resnet18(scale_size=scale_size), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    _assert_close(got.numpy(), want, f"resnet18 s{scale_size} {hw}")


@pytest.mark.parametrize("backbone", [VggTiny, MobilenetDilated, Resnet50])
def test_convbn_defaults_keep_existing_call_sites(backbone):
    """Every ConvBN of the backbones that existed before `bias` and a
    callable `act` came has no conv bias and computes exactly the
    conv -> BatchNorm -> ReLU (or no activation) it computed before."""
    model = backbone().eval()
    flat = random_flax_weights(model, seed=5)
    load_flax_weights(model, flat)
    blocks = [m for m in model.modules() if isinstance(m, ConvBN)]
    assert blocks and all(m.conv.bias is None and m.act in (torch.relu, None)
                          for m in blocks)
    assert not any(k.endswith("conv/bias") for k in flat)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0], out)))
             for m in blocks]
    with torch.inference_mode():
        model(torch.from_numpy(
            np.random.default_rng(6).uniform(0, 1, (1, 3, 48, 64)).astype(np.float32)))
    for h in hooks:
        h.remove()
    assert len(seen) == len(blocks)
    for mod, x, out in seen:
        if mod.stride > 1:
            x = F.pad(x, same_pads(x.shape[-2:], mod.kernel, mod.stride))
        c, bn = mod.conv, mod.bn
        with torch.inference_mode():
            want = F.batch_norm(F.conv2d(x, c.weight, None, c.stride, c.padding),
                                bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                False, 0.0, bn.eps)
        assert torch.equal(out, want if mod.act is None else torch.relu(want))


def test_convbn_bias_and_leaky_relu_match_jax():
    """PoseProposal's add1: a 3x3 ConvBN with a conv bias and leaky ReLU
    (slope 0.1), against flax's ConvBN(use_bias=True, act=leaky_relu)."""
    from flax import linen as fnn
    from hyperpose_tpu.models.backbones import ConvBN as JaxConvBN

    jm = JaxConvBN(24, use_bias=True, act=lambda v: fnn.leaky_relu(v, 0.1))
    x = np.random.default_rng(7).standard_normal((2, 9, 11, 16)).astype(np.float32)
    import jax
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = random_flax_weights(
        {"/".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
         for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}, seed=8)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x)))
    model = ConvBN(16, 24, act=lambda v: F.leaky_relu(v, 0.1), bias=True)
    load_flax_weights(model, flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert (want < 0).any()
    _assert_close(got, want, "ConvBN(bias, leaky_relu)")


LW_HW = (64, 80)


def test_lw_resnet18_matches_jax():
    """`LightWeightOpenPose(backbone=Resnet18)` (stride 8) on seeded random
    weights: the maps within 1e-4 of their largest value, and the two
    packages' PAF engines (`device="cpu"`) decode the same people from the
    same frames. The refinement heads' biases are raised by 1, so that the
    maps hold peaks and limbs above the decoder's thresholds: on the seeded
    weights alone neither package finds a human in these frames."""
    jm = JaxLwOpenPose(backbone=JaxResnet18)
    flat = random_flax_weights(_flax_shapes(jm, LW_HW), seed=3)
    for head in ("conf2", "paf2"):
        flat[f"params/ref_heads/{head}/bias"] += np.float32(1.0)
    rng = np.random.default_rng(4)
    frames = np.stack([resize_bilinear(synth_frame_rgb(), LW_HW),
                       rng.integers(0, 256, (*LW_HW, 3), dtype=np.uint8)])
    x = frames.astype(np.float32) / 255.0
    want = jm.apply(nest(flat), jnp.asarray(x), train=False)
    model = load_flax_weights(LightWeightOpenPose(backbone=Resnet18), flat).eval()
    assert model.backbone.out_channels == 512
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    for key in ("conf_map", "paf_map"):
        w = np.asarray(want[key])
        assert w.shape == (2, LW_HW[0] // 8, LW_HW[1] // 8, 19 if key == "conf_map" else 38)
        _assert_close(got[key].numpy(), w, key)
    jeng = JaxPoseEngine(jm, nest(flat), input_hw=LW_HW, max_batch_size=2)
    teng = PoseEngine(LightWeightOpenPose(backbone=Resnet18), flat, input_hw=LW_HW,
                      max_batch_size=2, device="cpu")
    w = jeng.infer_batch_device(jnp.asarray(frames))
    g = teng.infer_batch_device(frames)
    w = {f: np.asarray(getattr(w, f)) for f in FIELDS}
    g = {f: getattr(g, f).numpy() for f in FIELDS}
    assert int(g["valid"].sum()) > 0, "degenerate decode"
    assert_same_humans(g, w)


class _TwoConvs(torch.nn.Module):
    """NHWC in: a 7x7 stride-2 conv (the Resnet18 stem's shape), then a
    grouped 3x3 conv."""

    def __init__(self):
        super().__init__()
        self.stem = torch.nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.grouped = torch.nn.Conv2d(64, 64, 3, padding=1, groups=4)

    def forward(self, x):
        return self.grouped(self.stem(x.permute(0, 3, 1, 2)))


def test_conv_operations_counts_each_conv():
    """2 * output elements * cin / groups * kh * kw a conv, summed: on 64x80
    images, batch 2, the stem gives [2, 64, 32, 40]."""
    out = 2 * 64 * 32 * 40
    assert conv_operations(_TwoConvs(), (2, 64, 80, 3)) == 2 * out * (3 * 49 + 16 * 9)
