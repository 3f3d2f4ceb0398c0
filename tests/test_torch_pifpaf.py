"""The port's PifPaf network (Resnet50 trunk + composite-field heads)
against the JAX package's flax modules, in float32 on the CPU, on the same
seeded random weights: the keys and shapes of a flax `init` of the JAX
model, filled by `random_flax_weights` (numpy) and carried by the weight
bridge into both.

Tolerance: every field's max |delta| <= 1e-4 x that field's max |value| (53
conv layers whose float32 sums the two frameworks take in other orders).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nest
from hyperpose_tpu.models.backbones import Resnet50 as JaxResnet50
from hyperpose_tpu.models.pifpaf import Pifpaf as JaxPifpaf
from hyperpose_tpu.models.pifpaf import pixel_shuffle_nhwc as jax_shuffle
from hyperpose_torch.models.backbones import Resnet50, same_pads
from hyperpose_torch.models.pifpaf import Pifpaf, pixel_shuffle_nhwc
from hyperpose_torch.utils.weights import (
    flax_to_state_dict, load_flax_weights, random_flax_weights,
    state_dict_to_flax,
)

RTOL_OF_MAX = 1e-4


@functools.lru_cache(maxsize=None)
def _flax_shapes(module, hw):
    """{flax key: shape} of a flax init of `module` at input size hw."""
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _assert_close(got: np.ndarray, want: np.ndarray, name: str):
    scale = float(np.abs(want).max())
    assert scale > 1e-3, f"{name}: degenerate reference"
    err = float(np.abs(got - want).max())
    assert err <= RTOL_OF_MAX * scale, f"{name}: max |d| {err} vs max |v| {scale}"


def test_pixel_shuffle_matches_jax_exactly():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4 * 7)).astype(np.float32)
    want = np.asarray(jax_shuffle(jnp.asarray(x), 2))
    got = pixel_shuffle_nhwc(torch.from_numpy(x), 2).numpy()
    assert got.shape == (2, 6, 10, 7)
    np.testing.assert_array_equal(got, want)
    # Not nn.PixelShuffle's channel order.
    nchw = torch.nn.PixelShuffle(2)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("hw,pads", [
    ((368, 432), {7: (2, 3), 3: (0, 1), 1: (0, 0)}),
    ((23, 27), {7: (3, 3), 3: (1, 1), 1: (0, 0)}),
])
def test_same_pads_follow_xla(hw, pads):
    """XLA SAME at stride 2: total//2 before, the rest after, per side."""
    for k, (before, after) in pads.items():
        left, right, top, bottom = same_pads(hw, k, 2)
        assert (top, bottom) == (before, after)
        if hw[1] % 2 == hw[0] % 2:
            assert (left, right) == (before, after)


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_resnet50_trunk_matches_jax(hw):
    """The stride-16 trunk alone; 72x88 gives odd sizes (36x44 -> 18x22 ->
    9x11 -> 5x6), so every stride-2 conv pads asymmetrically somewhere."""
    jm = JaxResnet50(scale_size=32, use_pool=False, dtype=jnp.float32)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x), train=False))
    model = load_flax_weights(Resnet50(scale_size=32, use_pool=False), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, -(-hw[0] // 16), -(-hw[1] // 16), 2048)
    _assert_close(got.numpy(), want, "trunk")


def test_resnet50_with_pool_matches_jax():
    """The stride-8 trunk with the stem max pool (-inf SAME padding)."""
    jm = JaxResnet50(dtype=jnp.float32)
    flat = random_flax_weights(_flax_shapes(jm, (40, 56)), seed=4)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 40, 56, 3)).astype(np.float32)
    want = np.asarray(jm.apply(nest(flat), jnp.asarray(x), train=False))
    model = load_flax_weights(Resnet50(), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 5, 7, 2048)
    _assert_close(got.numpy(), want, "trunk")


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_pifpaf_forward_matches_jax(hw):
    jm = JaxPifpaf(hin=hw[0], win=hw[1], dtype=jnp.float32)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=3)
    x = np.random.default_rng(6).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = jm.apply(nest(flat), jnp.asarray(x), train=False)
    model = load_flax_weights(Pifpaf(), flat).eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    feat = (2 * -(-hw[0] // 16), 2 * -(-hw[1] // 16))
    assert got["pif_conf"].shape == (1, *feat, 17)
    assert got["paf_src_vec"].shape == (1, *feat, 19, 2)
    for k in want:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape, k
        _assert_close(got[k].numpy(), np.asarray(want[k]), k)


def test_weight_bridge_round_trips_every_pifpaf_key():
    """Every key of a flax init of the JAX Pifpaf maps to the port's
    state_dict and back, bit for bit."""
    shapes = _flax_shapes(JaxPifpaf(hin=64, win=64), (64, 64))
    assert len(shapes) == 5 * 53 + 4     # 53 conv+BN blocks, 2 heads with bias
    assert random_flax_weights(Pifpaf(), 0).keys() == shapes.keys()
    flat = random_flax_weights(shapes, seed=9)
    sd = flax_to_state_dict(flat)
    assert sd["backbone.stem.conv.weight"].shape == (64, 3, 7, 7)
    assert sd["pif_head.bias"].shape == (340,)
    model = load_flax_weights(Pifpaf(), flat)
    back = state_dict_to_flax(model.state_dict())
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_random_flax_weights_is_seeded():
    shapes = {"params/a/kernel": (3, 3, 4, 8), "params/a/bias": (8,),
              "batch_stats/b/var": (8,)}
    a, b = random_flax_weights(shapes, 7), random_flax_weights(shapes, 7)
    assert all(np.array_equal(a[k], b[k]) for k in shapes)
    assert not np.array_equal(a["params/a/kernel"],
                              random_flax_weights(shapes, 8)["params/a/kernel"])
    assert a["batch_stats/b/var"].min() >= 0.5
    assert abs(float(a["params/a/kernel"].std()) - 1 / 6) < 0.05
