"""The weight bridge between the JAX package's flat flax npz and the port."""
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest
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
    model = LightWeightOpenPose()
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
    model = load_flax_weights(LightWeightOpenPose(), FLAGSHIP_NPZ)
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
    model = load_flax_weights(LightWeightOpenPose(), src)
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
    save_flax_npz(load_flax_weights(LightWeightOpenPose(), FLAGSHIP_NPZ), path)
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
        load_flax_weights(LightWeightOpenPose(), flat)


def test_unexpected_key_raises():
    flat = flagship_flat()
    flat["params/backbone/block_9/conv/kernel"] = np.zeros((3, 3, 4, 4), np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_weights(LightWeightOpenPose(), flat)


def test_unmappable_key_raises():
    flat = flagship_flat()
    flat["opt_state/mu/x"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="unexpected flax weight"):
        flax_to_state_dict(flat)


def test_shape_mismatch_raises():
    flat = flagship_flat()
    flat["params/cpm/init/bias"] = np.zeros(64, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_flax_weights(LightWeightOpenPose(), flat)


def test_bf16_model_takes_f32_weights():
    model = load_flax_weights(LightWeightOpenPose(dtype=torch.bfloat16), FLAGSHIP_NPZ)
    w = model.backbone.block_0.conv.weight
    assert w.dtype == torch.bfloat16
    ref = torch.from_numpy(
        flagship_flat()["params/backbone/block_0/conv/kernel"].transpose(3, 2, 0, 1))
    assert torch.equal(w, ref.to(torch.bfloat16))
