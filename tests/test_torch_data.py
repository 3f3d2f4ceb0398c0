"""The port's dataset readers (`hyperpose_torch/data/`) against the JAX
package's (`hyperpose_tpu/data/`): the synthetic generator writes the same
files from the same seed, and the COCO / MPII readers, `get_dataset`
(USERDEF, MULTIPLE, user-added data) and the keypoint converters give the
same records, field by field. Everything here is numpy and OpenCV on the
host; the comparisons are exact.
"""
import dataclasses
import filecmp
import hashlib
import json
import os

import numpy as np
import pytest

from hyperpose_torch import config as PC
from hyperpose_torch.data import base as p_base
from hyperpose_torch.data import mscoco as p_coco
from hyperpose_torch.data import multi as p_multi
from hyperpose_torch.data import synthetic as p_synth
from hyperpose_tpu import config as JC
from hyperpose_tpu.data import base as j_base
from hyperpose_tpu.data import mscoco as j_coco
from hyperpose_tpu.data import multi as j_multi
from hyperpose_tpu.data import synthetic as j_synth

from test_datasets import make_coco, make_mpii, rle_compress, rle_encode
from torch_parity import REPO

EVAL_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_eval_flagship_synth_val100.json")


@pytest.fixture(autouse=True)
def reset_configs():
    JC.reset()
    PC.reset()
    yield
    JC.reset()
    PC.reset()


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_tree(a, b):
    files = _tree_files(a)
    assert files == _tree_files(b) and files
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, mismatch + errors


@pytest.mark.parametrize("kind", ["coco", "imagenet"])
def test_synthetic_generators_write_the_same_files(tmp_path, kind):
    """JSON byte for byte, and the JPEGs byte for byte with this machine's
    OpenCV (the COCO set with its MPII twin, train and val splits)."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "coco":
        kw = dict(n_train=2, n_val=3, seed=7, emit_mpii=True, train_start=5)
        j_synth.generate_synthetic_coco(a, **kw)
        p_synth.generate_synthetic_coco(b, **kw)
    else:
        kw = dict(n_classes=3, n_train_per_class=2, n_val_per_class=1, size=48, seed=3)
        j_synth.generate_synthetic_imagenet(a, **kw)
        p_synth.generate_synthetic_imagenet(b, **kw)
    _same_tree(a, b)


def test_ensure_synthetic_dataset_matches(tmp_path):
    """`ensure_synthetic_dataset` writes the same tree and marker, and each
    package accepts the other's set as it is."""
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_synth.ensure_synthetic_dataset(a, seed=2, n_train=1, n_val=2) == a
    assert p_synth.ensure_synthetic_dataset(b, seed=2, n_train=1, n_val=2) == b
    _same_tree(a, b)
    stamp = os.path.getmtime(os.path.join(a, "annotations", "person_keypoints_val2017.json"))
    p_synth.ensure_synthetic_dataset(a, seed=2, n_train=1, n_val=2)
    assert stamp == os.path.getmtime(
        os.path.join(a, "annotations", "person_keypoints_val2017.json"))


def test_val_annotations_match_the_jax_eval_fixture(tmp_path):
    """The port regenerates the val annotation file that the JAX evaluation
    fixture (tests/make_jax_eval_fixture.py) was scored on, byte for byte,
    so the fixture cannot go stale unseen."""
    with open(EVAL_FIXTURE) as f:
        fixture = json.load(f)
    root = str(tmp_path / "synth")
    p_synth.generate_synthetic_coco(root, n_train=0, n_val=fixture["n_val"],
                                    seed=fixture["seed"], emit_mpii=False)
    with open(os.path.join(root, "annotations", "person_keypoints_val2017.json"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == fixture["annotation_sha256"]
    assert sorted(os.listdir(os.path.join(root, "val2017"))) == sorted(fixture["jpeg_sha256"])


def metrics_equal(a: dict, b: dict) -> bool:
    """Metric dicts equal, NaN (a metric with no ground truth) equal to NaN."""
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])) for k in a)


def _value_equal(a, b, name):
    if callable(a) or callable(b):
        assert callable(a) and callable(b), name
        np.testing.assert_array_equal(a(), b(), err_msg=name)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, name


def records_equal(a, b):
    """Two record lists equal field by field (a mask is compared by what it
    rasterises)."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert type(ra).__name__ == type(rb).__name__
        for f in dataclasses.fields(ra):
            _value_equal(getattr(ra, f.name), getattr(rb, f.name), f.name)


def _configure(model_type, dataset_type="MSCOCO", path=None, **setters):
    """The same configuration in both packages; returns (jax cfg, port cfg)."""
    cfgs = []
    for C in (JC, PC):
        C.set_model_type(C.MODEL[model_type])
        for name, args in setters.items():   # set_userdef_dataset sets USERDEF
            getattr(C, name)(*args(C))
        C.set_dataset_type(C.DATA[dataset_type])
        if path is not None:
            C.set_dataset_path(path)
        cfgs.append(C.get_config(create_dirs=False))
    return cfgs


def _datasets_equal(jcfg, pcfg, splits=("train", "eval", "test")):
    jd, pd = j_base.get_dataset(jcfg), p_base.get_dataset(pcfg)
    assert type(jd).__name__ == type(pd).__name__
    for split in splits:
        records_equal(getattr(jd, f"get_{split}_records")(),
                      getattr(pd, f"get_{split}_records")())
    return jd, pd


@pytest.mark.parametrize("model_type", ["LightweightOpenpose", "PoseProposal", "Pifpaf"])
def test_coco_dataset_records_match(tmp_path, model_type):
    """Train records (keypoints in each family's layout, validity, crowd
    masks, boxes), eval and test records, and the output converter."""
    root, _ = make_coco(tmp_path)
    jcfg, pcfg = _configure(model_type, path=root)
    jd, pd = _datasets_equal(jcfg, pcfg)
    kp = np.random.default_rng(1).uniform(-5, 150, (jcfg.model.n_pos, 2))
    kp[::4] = -1000.0
    assert jd.output_converter(kp) == pd.output_converter(kp)


def test_coco_official_eval_matches(tmp_path):
    root, anns = make_coco(tmp_path)
    jcfg, pcfg = _configure("LightweightOpenpose", path=root)
    jd, pd = _datasets_equal(jcfg, pcfg, splits=())
    rng = np.random.default_rng(4)
    preds = [{"image_id": a["image_id"], "category_id": 1, "score": float(rng.uniform()),
              "keypoints": list(np.asarray(a["keypoints"]) + rng.normal(0, 2, 51))}
             for a in anns if not a["iscrowd"]]
    want = jd.official_eval(preds, str(tmp_path / "j"))
    got = pd.official_eval(preds, str(tmp_path / "p"))
    assert metrics_equal(got, want)


@pytest.mark.parametrize("model_type", ["LightweightOpenpose", "PoseProposal"])
def test_mpii_dataset_records_match(tmp_path, model_type):
    root, entries = make_mpii(tmp_path)
    jcfg, pcfg = _configure(model_type, "MPII", path=root)
    jd, pd = _datasets_equal(jcfg, pcfg)
    rng = np.random.default_rng(2)
    preds = [{"image_id": i, "score": float(rng.uniform()),
              "keypoints": (np.asarray(e["people"][0]["joints"]) + rng.normal(0, 3, (16, 3)))
              .ravel().tolist()}
             for i, e in enumerate(x for x in entries if x["img_train"] == 0)]
    assert metrics_equal(pd.official_eval(preds, str(tmp_path / "p")),
                         jd.official_eval(preds, str(tmp_path / "j")))
    kp = rng.uniform(0, 150, (jcfg.model.n_pos, 2))
    assert jd.output_converter(kp) == pd.output_converter(kp)


def _user_targets(n, n_pos=19):
    rng = np.random.default_rng(n)
    return [(rng.uniform(0, 100, (2, n_pos, 2)).astype(np.float32),
             rng.uniform(size=(2, n_pos)) > 0.3) for _ in range(n)]


@pytest.mark.parametrize("case", ["userdef_list", "userdef_dataset", "multiple",
                                  "useradd", "useradd_only"])
def test_get_dataset_dispatch_matches(tmp_path, case):
    """USERDEF (a record list and a dataset object), MULTIPLE, and user-added
    data mixed into COCO (and alone, with official_flag off)."""
    root, _ = make_coco(tmp_path)
    targets = _user_targets(3)
    items = [(f"u{i}.jpg", k, v) for i, (k, v) in enumerate(targets)]
    mods = {JC: j_multi, PC: p_multi}
    if case == "userdef_list":
        cfgs = _configure("LightweightOpenpose", "USERDEF",
                          set_userdef_dataset=lambda C: (items,))
    elif case == "userdef_dataset":
        cfgs = _configure("LightweightOpenpose", "USERDEF",
                          set_userdef_dataset=lambda C: (mods[C].UserPoseDataset(items),))
    elif case == "multiple":
        cfgs = _configure("LightweightOpenpose", "MULTIPLE", set_userdef_dataset=lambda C: ([
            mods[C].UserPoseDataset(items[:1]), mods[C].UserPoseDataset(items[1:])],))
    else:
        dict_targets = [{"kpt": k} if i == 0 else (k, v) for i, (k, v) in enumerate(targets)]
        setters = {"set_useradd_data": lambda C: (
            [p for p, _, _ in items], dict_targets, 2)}
        if case == "useradd_only":
            setters["set_official_dataset"] = lambda C: (False,)
        cfgs = _configure("LightweightOpenpose", path=root, **setters)
    splits = ("train",) if case.startswith("useradd") else ("train", "eval")
    _datasets_equal(*cfgs, splits=splits)


def test_keypoint_converters_and_rle_match():
    rng = np.random.default_rng(9)
    k17 = rng.uniform(0, 300, (17, 2)).astype(np.float32)
    vis = rng.uniform(size=17) > 0.3
    bbox = np.array([10.0, 20.0, 120.0, 200.0], np.float32)
    for layout, n_pos, kw in ((j_coco.OPPS_FROM_COCO17, 19, {}),
                              (j_coco.PPN_FROM_COCO17, 18, {"bbox": bbox})):
        want = j_coco.coco17_to_model(k17, vis, layout, n_pos, **kw)
        got = p_coco.coco17_to_model(k17, vis, layout, n_pos, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        assert p_coco.model_to_coco17(want[0], layout) == j_coco.model_to_coco17(
            want[0], layout)
    mask = rng.uniform(size=(23, 31)) > 0.6
    rle = rle_encode(mask)
    compressed = {"counts": rle_compress(rle["counts"]), "size": rle["size"]}
    for r in (rle, compressed):
        np.testing.assert_array_equal(p_coco.rle_to_mask(r), j_coco.rle_to_mask(r))
    poly = [[2.0, 3.0, 25.0, 4.0, 20.0, 18.0, 3.0, 15.0]]
    np.testing.assert_array_equal(p_coco.segmentation_to_mask(poly, 23, 31),
                                  j_coco.segmentation_to_mask(poly, 23, 31))
    bbxs = (p_base.derive_bbxs(want[0][None], want[1][None]),
            j_base.derive_bbxs(want[0][None], want[1][None]))
    np.testing.assert_array_equal(*bbxs)
