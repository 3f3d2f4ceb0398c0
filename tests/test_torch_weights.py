"""The weight bridge between the JAX package's flat flax npz and the port."""
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest
from hyperpose_torch.models.backbones import VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.utils.weights import (
    flax_to_state_dict, load_flax_weights, save_flax_npz, state_dict_to_flax,
)


def _trainable_keys(model):
    return {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}


def test_every_flagship_key_is_consumed():
    flat = flagship_flat()
    assert len(flat) == 146
    sd = flax_to_state_dict(FLAGSHIP_NPZ)
    model = LightWeightOpenPose(backbone=VggTiny)
    assert len(sd) == 146
    assert set(sd) == _trainable_keys(model)
    load_flax_weights(model, FLAGSHIP_NPZ)
    own = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(own[k], v), k


def test_layout_conversion():
    """HWIO kernels become OIHW; BN scale/bias/mean/var land on
    weight/bias/running_mean/running_var with the flax eps."""
    flat = flagship_flat()
    model = load_flax_weights(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ)
    conv = model.backbone.block_1.conv.weight.detach().numpy()
    np.testing.assert_array_equal(
        conv, flat["params/backbone/block_1/conv/kernel"].transpose(3, 2, 0, 1))
    bn = model.cpm.m0.cb.bn
    assert bn.eps == 1e-5
    np.testing.assert_array_equal(bn.weight.detach().numpy(),
                                  flat["params/cpm/m0/cb/bn/scale"])
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  flat["batch_stats/cpm/m0/cb/bn/var"])
    np.testing.assert_array_equal(model.init_heads.paf2.bias.detach().numpy(),
                                  flat["params/init_heads/paf2/bias"])


@pytest.mark.parametrize("source", ["path", "flat", "nested"])
def test_round_trip_is_bit_exact(source, tmp_path):
    flat = flagship_flat()
    src = {"path": FLAGSHIP_NPZ, "flat": flat, "nested": nest(flat)}[source]
    model = load_flax_weights(LightWeightOpenPose(backbone=VggTiny), src)
    back = state_dict_to_flax(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    path = tmp_path / "w.npz"
    save_flax_npz(model, path)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(flat)
        for k in data.files:
            assert np.array_equal(data[k], flat[k]), k


def test_jax_reads_port_weights(tmp_path):
    """The JAX package's own loader takes the port's npz."""
    from hyperpose_tpu.train.checkpoint import load_npz_tree

    path = tmp_path / "w.npz"
    save_flax_npz(load_flax_weights(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ), path)
    tree = load_npz_tree(str(path))
    ref = nest(flagship_flat())
    assert tree.keys() == ref.keys()
    np.testing.assert_array_equal(
        tree["params"]["ref_b0"]["init"]["kernel"],
        ref["params"]["ref_b0"]["init"]["kernel"])


def test_missing_key_raises():
    flat = flagship_flat()
    del flat["batch_stats/backbone/block_3/bn/var"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_weights(LightWeightOpenPose(backbone=VggTiny), flat)


def test_unexpected_key_raises():
    flat = flagship_flat()
    flat["params/backbone/block_9/conv/kernel"] = np.zeros((3, 3, 4, 4), np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_weights(LightWeightOpenPose(backbone=VggTiny), flat)


def test_unmappable_key_raises():
    flat = flagship_flat()
    flat["opt_state/mu/x"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unexpected flax weight"):
        flax_to_state_dict(flat)


def test_shape_mismatch_raises():
    flat = flagship_flat()
    flat["params/cpm/init/bias"] = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_weights(LightWeightOpenPose(backbone=VggTiny), flat)


def test_bf16_model_takes_f32_weights():
    model = load_flax_weights(LightWeightOpenPose(backbone=VggTiny, dtype=torch.bfloat16), FLAGSHIP_NPZ)
    w = model.backbone.block_0.conv.weight
    assert w.dtype == torch.bfloat16
    ref = torch.from_numpy(
        flagship_flat()["params/backbone/block_0/conv/kernel"].transpose(3, 2, 0, 1))
    assert torch.equal(w, ref.to(torch.bfloat16))


# -- the leaves of the OpenPose family: PReLU slopes, SeparableConv's bare kernels -----

def _family_models():
    from hyperpose_torch.models.openpose import MobilenetSmallOpenpose, OpenPose

    return {"openpose": OpenPose(n_refinements=1), "mbsmall": MobilenetSmallOpenpose()}


@pytest.mark.parametrize("name", ["openpose", "mbsmall"])
def test_family_leaves_round_trip_bit_exact(name, tmp_path):
    """`params/<p>/prelu/alpha` lands on `<p>.prelu.alpha` as it is;
    `params/<p>/sep/dw_kernel` [kh, kw, 1, cin] and `pw_kernel` [1, 1, cin,
    f] land on OIHW `<p>.sep.dw_kernel` [cin, 1, kh, kw] and `pw_kernel`
    [f, cin, 1, 1], `sep/bias` on `<p>.sep.bias`; back to flax and through
    an npz bit for bit."""
    from hyperpose_torch.utils.weights import random_flax_weights

    model = _family_models()[name]
    flat = random_flax_weights(model, seed=3)
    load_flax_weights(model, flat)
    if name == "openpose":
        key = "params/ref0_conf/l0/prelu/alpha"
        assert flat[key].shape == (128,)
        assert torch.equal(model.ref0_conf.l0.prelu.alpha, torch.from_numpy(flat[key]))
    else:
        dw = flat["params/ref0_conf/l0/sep/dw_kernel"]
        pw = flat["params/ref0_conf/l0/sep/pw_kernel"]
        assert dw.shape == (7, 7, 1, 761) and pw.shape == (1, 1, 761, 128)
        sep = model.ref0_conf.l0.sep
        assert torch.equal(sep.dw_kernel, torch.from_numpy(dw.transpose(3, 2, 0, 1)))
        assert torch.equal(sep.pw_kernel, torch.from_numpy(pw.transpose(3, 2, 0, 1)))
        assert torch.equal(sep.bias, torch.from_numpy(flat["params/ref0_conf/l0/sep/bias"]))
    back = state_dict_to_flax(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(back[k], v), k
    path = tmp_path / "w.npz"
    save_flax_npz(model, path)
    again = _family_models()[name]
    load_flax_weights(again, str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_random_weights_rules_for_the_family_leaves():
    """PReLU slopes are drawn uniform in [0.05, 0.5] (never 0, so the
    negative branch runs); `dw_kernel` and `pw_kernel` normal with std
    sqrt(1 / fan_in), fan_in = kh * kw * 1 and cin."""
    from hyperpose_torch.utils.weights import random_flax_weights

    shapes = {"params/a/prelu/alpha": (4096,), "params/s/dw_kernel": (7, 7, 1, 4096),
              "params/s/pw_kernel": (1, 1, 256, 4096)}
    w = random_flax_weights(shapes, seed=0)
    a = w["params/a/prelu/alpha"]
    assert a.dtype == np.float32 and a.min() >= 0.05 and a.max() <= 0.5
    assert abs(float(w["params/s/dw_kernel"].std()) * 7 - 1) < 0.02
    assert abs(float(w["params/s/pw_kernel"].std()) * 16 - 1) < 0.02


def test_random_weights_of_existing_models_are_unchanged():
    """The draws of the models that existed before the family leaves came
    (whose times PERF.md quotes) stay as they were: the first values of
    the flagship-shaped and default Lightweight-OpenPose draws at seed 0."""
    from hyperpose_torch.utils.weights import random_flax_weights

    w = random_flax_weights(LightWeightOpenPose(), seed=0)
    assert not any(k.endswith(("alpha", "dw_kernel", "pw_kernel")) for k in w)
    rng = np.random.default_rng(0)
    first = next(iter(w))
    shape = w[first].shape
    want = (rng.standard_normal(shape) * np.sqrt(1.0 / np.prod(shape[:-1]))).astype(np.float32)
    assert first.endswith("/kernel") and np.array_equal(w[first], want)
