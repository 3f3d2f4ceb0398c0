"""The port's training-target generators (`hyperpose_torch/data/targets.py`)
against the JAX package's (`hyperpose_tpu/data/targets.py`, jitted) on the
same seeded keypoints (tests/torch_train_cases.py `random_people`: invalid
and MISSING keypoints, a person with none, two people in the same cells,
keypoints on and just past the image's edges), in float32 on the CPU.

Tolerances: the OpenPose maps max |d| <= 1e-6 (values in [-1, 1]). The
PoseProposal and PifPaf scatters: every count, the confidences and the
edge tensors exactly, the NaN (don't-care) pattern exactly, and the summed
regression targets within 1e-6 x max(1, |v|) (a sum over the people of one
cell may round in another order).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_cases import bbxs_of, crowd_mask, random_people
from hyperpose_tpu.data import targets as JT
from hyperpose_torch.data import targets as PT
from hyperpose_torch.utils.topology import COCO_TOPOLOGY, PIFPAF_TOPOLOGY, PPN_TOPOLOGY

import torch_parity  # noqa: F401  (one thread)


def _close(got, want, name, atol=1e-6, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}"
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=f"{name}: NaN pattern")
    tol = atol * np.maximum(1.0, np.abs(want[~nan])) if rel else atol
    err = np.abs(got[~nan] - want[~nan])
    assert (err <= tol).all(), f"{name}: max |d| {err.max()}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("hw,out_hw", [((64, 80), (8, 10)), ((96, 112), (12, 14))])
def test_openpose_targets_match_jax(hw, out_hw):
    kpts, valid = random_people(0, 3, 5, 18, hw)
    limbs = COCO_TOPOLOGY.limbs
    fn = jax.jit(partial(JT.openpose_targets, limbs=limbs, in_hw=hw, out_hw=out_hw))
    want = fn(jnp.asarray(kpts), jnp.asarray(valid))
    got = PT.openpose_targets(_t(kpts), _t(valid), limbs, hw, out_hw)
    assert got["conf_map"].shape == (3, *out_hw, 19)
    assert got["paf_map"].shape == (3, *out_hw, 38)
    for key in ("conf_map", "paf_map"):
        assert np.abs(np.asarray(want[key])).max() > 0.5, key
        _close(got[key].numpy(), want[key], key)


def test_openpose_targets_keep_jax_cutoff_and_background():
    """A keypoint exactly on a grid point gives 1 there and the background
    channel 0; beyond the exponent cutoff the map is exactly 0."""
    hw, out_hw = (64, 64), (8, 8)
    kpts = np.full((1, 1, 18, 2), -1000.0, np.float32)
    valid = np.zeros((1, 1, 18), bool)
    kpts[0, 0, 0] = (3.5, 3.5)     # grid point (0, 0): 8 * 0 + 4 - 0.5
    valid[0, 0, 0] = True
    got = PT.openpose_conf_map(_t(kpts), _t(valid), hw, out_hw).numpy()
    want = np.asarray(JT.openpose_conf_map(jnp.asarray(kpts), jnp.asarray(valid), hw, out_hw))
    np.testing.assert_array_equal(got[0, 0, 0, [0, 18]], [1.0, 0.0])
    assert got[0, 7, 7, 0] == 0.0
    _close(got, want, "conf_map")


@pytest.mark.parametrize("seed", [0, 1])
def test_ppn_targets_match_jax(seed):
    hw, out_hw = (128, 128), (4, 4)
    kpts, valid = random_people(seed, 3, 6, 18, hw)
    bbxs = bbxs_of(kpts, valid)
    limbs = PPN_TOPOLOGY.limbs
    fn = jax.jit(partial(JT.ppn_targets, limbs=limbs, in_hw=hw, out_hw=out_hw,
                         nei=(9, 9), instance_idx=1))
    want = fn(jnp.asarray(kpts), jnp.asarray(valid), jnp.asarray(bbxs))
    got = PT.ppn_targets(_t(kpts), _t(valid), _t(bbxs), limbs, hw, out_hw, (9, 9), 1)
    assert sorted(got) == sorted(want)
    # More people than fit one cell: some (image, part) cells hold several.
    cell = np.floor(kpts[..., 1] / 32) * 4 + np.floor(kpts[..., 0] / 32)
    inb = valid & (kpts >= 0).all(-1) & (kpts[..., 0] < 128) & (kpts[..., 1] < 128)
    shared = [len(c) - len(set(c)) for c in
              (cell[i, :, j][inb[i, :, j]] for i in range(3) for j in range(18))]
    assert max(shared) >= 1
    for key in ("c", "e", "e_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert np.asarray(want["e"]).sum() > 0
    for key in ("x", "y", "w", "h"):
        _close(got[key].numpy(), want[key], key, rel=True)


@pytest.mark.parametrize("masked", [False, True])
def test_pifpaf_targets_match_jax(masked):
    hw, out_hw = (96, 112), (12, 14)
    kpts, valid = random_people(2, 2, 6, 17, hw)
    limbs = PIFPAF_TOPOLOGY.limbs
    mask = crowd_mask(2, out_hw) if masked else None
    fn = jax.jit(partial(JT.pifpaf_targets, limbs=limbs, in_hw=hw, out_hw=out_hw))
    want = fn(jnp.asarray(kpts), jnp.asarray(valid),
              mask=None if mask is None else jnp.asarray(mask))
    got = PT.pifpaf_targets(_t(kpts), _t(valid), limbs, hw, out_hw,
                            mask=None if mask is None else _t(mask))
    assert sorted(got) == sorted(want)
    for key in want:
        w = np.asarray(want[key])
        if key.endswith("conf"):
            np.testing.assert_array_equal(np.nan_to_num(got[key].numpy(), nan=-1),
                                          np.nan_to_num(w, nan=-1), err_msg=key)
        else:
            _close(got[key].numpy(), w, key, rel=True)
    assert np.isfinite(np.asarray(want["pif_vec"])).any()
    if masked:
        assert np.isnan(got["pif_conf"].numpy()[0, 0:2, 1:3]).all()
