"""The port's TensorLayer checkpoint importer (`hyperpose_torch/utils/
weights_import.py`, `utils/tl_orders.py`) against the JAX package's, on the
same npz_dict files.

Every case of tests/test_tl_import.py (the reference models' weight
sequences from tests/tl_fixtures.py: LW-OpenPose on VggTiny and on
MobilenetDilated, OpenPose-VGG19, PoseProposal-Resnet18, PifPaf-Resnet50,
the Thin and Small OpenPose variants) is imported by both packages: the
port's imported tensors equal JAX's, bit for bit (the same assignment, the
fixtures' index-coded values, whose forward is not meaningful). The
kind-stream matcher, with the same starting weights in both, assigns the
same (rotated) values; broken files fail loudly in both. The round trips of
tests/test_tl_roundtrip.py (the trained flagship, seeded PifPaf weights,
written in the TensorLayer layout and imported back): the port's imported
weights equal the originals, and its forward equals JAX's on them within
1e-5 of the maps' max |value|; the JAX-free writer that `chip_smoke.py`
uses (tests/torch_tl_layout.py) writes the same file as the JAX test's.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_tl_roundtrip import retarget_entries
from torch_tl_layout import tl_layout
from test_torch_openpose_family import _hashable
from test_torch_pifpaf import _flax_shapes
from tl_fixtures import (
    lw_openpose_entries, openpose_entries, pifpaf_entries, ppn_entries,
    save_tl_npz_dict, small_openpose_entries, thin_openpose_entries,
)
from torch_parity import flagship_flat, nest
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models.pifpaf import Pifpaf as JPifpaf
from hyperpose_tpu.models.pose_proposal import PoseProposal as JPPN
from hyperpose_tpu.utils import weights_import as JW
from hyperpose_tpu.utils.tl_orders import ORDER_KEYS as JORDER
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.models.pose_proposal import PoseProposal
from hyperpose_torch.utils import weights_import as PW
from hyperpose_torch.utils.tl_orders import ORDER_KEYS
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights, state_dict_to_flax

# name -> (fixture entries, flax module, port module, model type, init size)
CASES = {
    "lw_vggtiny": (lambda: lw_openpose_entries("vggtiny"),
                   lambda: JO.LightWeightOpenPose(backbone=JB.VggTiny),
                   lambda: PO.LightWeightOpenPose(backbone=PB.VggTiny), "LightweightOpenpose"),
    "lw_mobilenet_dilated": (lambda: lw_openpose_entries("mobilenet_dilated"),
                             lambda: JO.LightWeightOpenPose(backbone=JB.MobilenetDilated),
                             lambda: PO.LightWeightOpenPose(backbone=PB.MobilenetDilated),
                             "LightweightOpenpose"),
    "openpose_vgg19": (openpose_entries, lambda: JO.OpenPose(backbone=JB.Vgg19),
                       lambda: PO.OpenPose(backbone=PB.Vgg19), "Openpose"),
    "ppn_resnet18": (ppn_entries, JPPN, PoseProposal, "PoseProposal"),
    "pifpaf_resnet50": (pifpaf_entries, JPifpaf, Pifpaf, "Pifpaf"),
    "thin_openpose": (thin_openpose_entries, lambda: _hashable(JO.MobilenetThinOpenpose()),
                      PO.MobilenetThinOpenpose, "MobilenetThinOpenpose"),
    "small_openpose": (small_openpose_entries, lambda: _hashable(JO.MobilenetSmallOpenpose()),
                       PO.MobilenetSmallOpenpose, "MobilenetSmallOpenpose"),
}


def _zeros(jm):
    """Zero flax variables of `jm`'s shapes (the structural import assigns
    every leaf, so the starting values do not matter)."""
    return nest({k: np.zeros(s, np.float32) for k, s in _flax_shapes(jm, (64, 64)).items()})


def _flat(tree, pre):
    return {f"{pre}/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_flat(variables):
    return {**_flat(variables["params"], "params"),
            **(_flat(variables["batch_stats"], "batch_stats")
               if variables.get("batch_stats") else {})}


@pytest.mark.parametrize("name", sorted(CASES))
def test_structural_import_matches_jax(name, tmp_path):
    entries_fn, jmf, pmf, mtype = CASES[name]
    entries, _ = entries_fn()
    path = str(tmp_path / f"{name}.npz")
    save_tl_npz_dict(entries, path)
    want = _jax_flat(JW.import_tl_checkpoint(_zeros(jmf()), path, JORDER[mtype]))
    model = PW.import_tl_checkpoint(pmf(), path, ORDER_KEYS[mtype])
    got = state_dict_to_flax(model.state_dict())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert PW.compare_report(model, path) == JW.compare_report(_zeros(jmf()), path)
    shutil.rmtree(tmp_path, ignore_errors=True)   # full-size fixture checkpoints


def test_kind_stream_matcher_matches_jax(tmp_path):
    """The legacy per-kind matcher from the same starting weights: the same
    assignment in both, the cpm rotation of tests/test_tl_import.py
    included."""
    entries, marks = lw_openpose_entries("vggtiny")
    path = str(tmp_path / "lw.npz")
    save_tl_npz_dict(entries, path)
    pm = PO.LightWeightOpenPose(backbone=PB.VggTiny)
    start = random_flax_weights(pm, 2)
    load_flax_weights(pm, start)
    want = _jax_flat(JW.import_npz_dict(nest(start), path, strict=False))
    got = state_dict_to_flax(PW.import_npz_dict(pm, path, strict=False).state_dict())
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["params/cpm/end/kernel"].flat[0] == marks["cpm_m0"]


def test_structural_import_fails_loudly_in_both(tmp_path):
    entries, _ = lw_openpose_entries("vggtiny")
    truncated = [e for e in entries if not e[0].startswith("model/ref_paf2")]
    names = [e[0] for e in entries]
    i, j = names.index("model/conv2d_20/filters:0"), names.index("model/conv2d_24/filters:0")
    swapped = list(entries)
    swapped[i], swapped[j] = (entries[i][0], entries[j][1]), (entries[j][0], entries[i][1])
    jv = _zeros(JO.LightWeightOpenPose(backbone=JB.VggTiny))
    for bad, match in ((truncated, "TL checkpoint import failed"), (swapped, "does not fit")):
        path = str(tmp_path / f"bad_{match[:4]}.npz")
        save_tl_npz_dict(bad, path)
        with pytest.raises(ValueError, match=match):
            JW.import_tl_checkpoint(jv, path, JORDER["LightweightOpenpose"])
        with pytest.raises(ValueError, match=match):
            PW.import_tl_checkpoint(PO.LightWeightOpenPose(backbone=PB.VggTiny), path,
                                    ORDER_KEYS["LightweightOpenpose"])


def _forward_close(got, want, name):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{name}: max |d| {err} vs max |v| {scale}"


@pytest.mark.parametrize("name", ["flagship", "pifpaf"])
def test_roundtrip_imports_the_weights_and_matches_jax(name, tmp_path):
    """A checkpoint written in the TensorLayer layout carrying real weights
    (the trained flagship; PifPaf's seeded ones), imported by the port:
    the weights come back bit for bit, and its forward equals JAX's."""
    if name == "flagship":
        flat, mtype, entries = flagship_flat(), "LightweightOpenpose", lw_openpose_entries(
            backbone="vggtiny")[0]
        jm, pm, hw = (JO.LightWeightOpenPose(backbone=JB.VggTiny, dtype=jnp.float32),
                      PO.LightWeightOpenPose(backbone=PB.VggTiny), (96, 112))
    else:
        jm, pm, hw = JPifpaf(dtype=jnp.float32), Pifpaf(hin=64, win=64), (64, 64)
        flat, mtype, entries = random_flax_weights(pm, 4), "Pifpaf", pifpaf_entries()[0]
    variables = nest(flat)
    path = str(tmp_path / "tl.npz")
    written = retarget_entries(entries, variables, JORDER[mtype])
    mine = tl_layout(entries, flat, ORDER_KEYS[mtype])   # chip_smoke's writer
    assert [n for n, _ in mine] == [n for n, _ in written]
    for (n, a), (_, b) in zip(mine, written):
        np.testing.assert_array_equal(a, b, err_msg=n)
    save_tl_npz_dict(written, path)
    model = PW.import_tl_checkpoint(pm, path, ORDER_KEYS[mtype]).eval()
    got = state_dict_to_flax(model.state_dict())
    assert sorted(got) == sorted(flat)
    for k, w in flat.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    x = np.random.default_rng(0).random((1, *hw, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    compared = 0
    for k in want:
        pairs = (zip(out[k], want[k]) if isinstance(out.get(k), (list, tuple))
                 else [(out[k], want[k])] if k in out else [])
        for i, (g, w) in enumerate(pairs):
            _forward_close(g.numpy(), np.asarray(w), f"{k}[{i}]")
            compared += 1
    assert compared >= 2
    shutil.rmtree(tmp_path, ignore_errors=True)
