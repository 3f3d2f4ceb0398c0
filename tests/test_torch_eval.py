"""The port's evaluation path (`hyperpose_torch/eval/`, `ops/image.py`
`jax_resize_cubic`, `models.get_evaluate` / `get_test`, `tools/eval.py`,
`tools/official_test.py`) against the JAX package's on the CPU.

- The scorers: `CocoKeypointEval` and `pckh_eval` give exactly the JAX
  package's metrics on every case of tests/test_coco_eval_adversarial.py and
  tests/test_mpii_eval.py (each case run with both packages' scorers).
- `jax_resize_cubic` within 1e-6 x max |x| of `jax.image.resize(...,
  "cubic")`; torch's bicubic is not (the trap it replaces).
- The gt-painted loops (COCO, MPII, PoseProposal, PifPaf): the same painted
  targets (JAX's target generators) through JAX's evaluator and the port's,
  each with its own decode; AP / PCKh within 1e-3, detections person by
  person within 1e-3 px.
- The committed flagship on the first 8 val scenes of the seed-0 synthetic
  set in f32: persons within 0.05 px, AP within 0.01; multiscale maps of
  seeded weights within 1e-5 of JAX's.
- `python -m hyperpose_torch.tools.eval` prints JAX `eval.py`'s metrics with
  the same flags; `get_evaluate` / `get_test` through `Model`; the tools
  raise without a GPU unless `--device cpu` is given.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_coco_eval_adversarial as coco_cases
import test_mpii_eval as mpii_cases
from chip_smoke import same_people
from gt_painted import paint_batches
from test_accuracy_loop_pifpaf import GtPaintedPifPafEvaluator, paint_raw_predict
from test_torch_data import metrics_equal
from torch_parity import FLAGSHIP_NPZ, REPO, nest, random_flat
from hyperpose_torch import Config as PC
from hyperpose_torch import Model as PM
from hyperpose_torch.data.base import get_dataset as p_get_dataset
from hyperpose_torch.data.mscoco import OPPS_FROM_COCO17, PPN_FROM_COCO17, coco17_to_model
from hyperpose_torch.data.synthetic import generate_synthetic_coco
from hyperpose_torch.eval import coco_eval as p_coco_eval
from hyperpose_torch.eval import mpii_eval as p_mpii_eval
from hyperpose_torch.eval.evaluate import EVAL_UPSAMPLE, Evaluator, to_host
from hyperpose_torch.models.pose_proposal import PoseProposal as PPoseProposal
from hyperpose_torch.ops.image import jax_resize_cubic
from hyperpose_torch.ops.pifpaf_decode import PifPafDecoderConfig as PPifCfg
from hyperpose_torch.ops.pifpaf_decode import pifpaf_decode_batch as p_pifpaf_decode
from hyperpose_torch.ops.ppn_decode import PpnDecoderConfig as PPpnCfg
from hyperpose_torch.ops.ppn_decode import ppn_decode_batch as p_ppn_decode
from hyperpose_torch.utils.topology import instance_part_idx
from hyperpose_torch.utils.weights import load_flax_weights
from hyperpose_tpu import config as JC
from hyperpose_tpu import models as JM
from hyperpose_tpu.data.base import get_dataset as j_get_dataset
from hyperpose_tpu.data.targets import ppn_targets
from hyperpose_tpu.eval import coco_eval as j_coco_eval
from hyperpose_tpu.eval import mpii_eval as j_mpii_eval
from hyperpose_tpu.eval.evaluate import Evaluator as JEvaluator
from hyperpose_tpu.models.pose_proposal import PoseProposal as JPoseProposal
from hyperpose_tpu.ops.ppn_decode import PpnDecoderConfig as JPpnCfg
from hyperpose_tpu.ops.ppn_decode import ppn_decode_batch as j_ppn_decode
from hyperpose_tpu.train.checkpoint import load_weights_npz
from hyperpose_tpu.utils.human import SkeletonBatch as JSkeletonBatch


@pytest.fixture(autouse=True)
def reset_configs():
    JC.reset()
    PC.reset()
    yield
    JC.reset()
    PC.reset()


# -- the scorers -----------------------------------------------------------------

class _BothCoco:
    """A `CocoKeypointEval` that scores with both packages, checks that the
    metrics are equal and returns the JAX package's."""
    calls = 0

    def __init__(self, path):
        self.jax = j_coco_eval.CocoKeypointEval(path)
        self.port = p_coco_eval.CocoKeypointEval(path)

    def evaluate(self, *args, **kw):
        want = self.jax.evaluate(*args, **kw)
        got = self.port.evaluate(*args, **kw)
        assert metrics_equal(got, want), (got, want)
        _BothCoco.calls += 1
        return want


def _both_oks(*args, **kw):
    want = j_coco_eval.compute_oks(*args, **kw)
    assert p_coco_eval.compute_oks(*args, **kw) == want
    _BothCoco.calls += 1
    return want


def _both_pckh(*args, **kw):
    want = j_mpii_eval.pckh_eval(*args, **kw)
    got = p_mpii_eval.pckh_eval(*args, **kw)
    assert metrics_equal(got, want), (got, want)
    _BothCoco.calls += 1
    return want


COCO_CASES = sorted(n for n in dir(coco_cases) if n.startswith("test_"))
MPII_CASES = sorted(n for n in dir(mpii_cases) if n.startswith("test_"))


@pytest.mark.parametrize("case", [("coco", n) for n in COCO_CASES]
                         + [("mpii", n) for n in MPII_CASES], ids=lambda c: c[1])
def test_scorers_match_on_adversarial_cases(tmp_path, monkeypatch, case):
    kind, name = case
    fn = getattr(coco_cases if kind == "coco" else mpii_cases, name)
    if kind == "coco":
        monkeypatch.setattr(coco_cases, "CocoKeypointEval", _BothCoco)
        monkeypatch.setattr(coco_cases, "compute_oks", _both_oks)
    else:
        monkeypatch.setattr(mpii_cases, "pckh_eval", _both_pckh)
    before = _BothCoco.calls
    params = getattr(fn, "pytestmark", [])
    seeds = [p.args[1] for p in params if p.name == "parametrize"]
    args = {"tmp_path": tmp_path}
    for values in (seeds[0] if seeds else [None]):
        kw = {k: args[k] for k in fn.__code__.co_varnames[:fn.__code__.co_argcount]
              if k in args}
        if values is not None:
            kw["seed"] = values
        fn(**kw)
    assert _BothCoco.calls > before


# -- the cubic map upsample ------------------------------------------------------------

@pytest.mark.parametrize("shape,out_hw", [
    ((2, 46, 54, 19), (92, 108)),   # the evaluator's 2x upsample
    ((1, 5, 5, 3), (10, 10)),
    ((2, 7, 3, 4), (3, 11)),        # down and up, odd sizes
    ((1, 13, 17, 2), (5, 6)),       # down: the kernel widened by in / out
    ((2, 1, 1, 3), (4, 5)),         # a 1-pixel input
    ((1, 9, 2, 3), (1, 1)),
    ((1, 12, 16, 5), (12, 32)),     # one axis unchanged
])
def test_jax_resize_cubic_matches_jax(shape, out_hw):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *out_hw, shape[3]), "cubic"))
    got = jax_resize_cubic(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(x).max()


def test_torch_bicubic_is_not_jax_cubic():
    """`F.interpolate(mode="bicubic")` (Keys a = -0.75, edge clamped) misses
    JAX's cubic by far more than the bound `jax_resize_cubic` keeps."""
    x = np.random.default_rng(0).standard_normal((1, 5, 5, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 10, 10, 1), "cubic"))
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(10, 10), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(bicubic - want).max() > 1e-2 * np.abs(x).max()


# -- the gt-painted loops -----------------------------------------------------------------

class _Replay(Evaluator):
    """The port's evaluator whose step decodes prepared inputs, batch by
    batch in record order, with `decode`."""

    def set_batches(self, batches, decode):
        self._batches, self._decode_fn = list(batches), decode

    def infer_batch(self, images_u8):
        return self._decode_fn(self._batches.pop(0))


class _JaxReplay(JEvaluator):
    def set_batches(self, batches, decode):
        self._batches, self._decode_fn = list(batches), decode

    def infer_batch(self, images_u8):
        return self._decode_fn(self._batches.pop(0))


def _capture(dataset) -> list:
    """The COCO results `dataset.official_eval` is handed, as a list."""
    results, official_eval = [], dataset.official_eval

    def capture(pd_annotations, eval_dir):
        results.extend(pd_annotations)
        return official_eval(pd_annotations, eval_dir)

    dataset.official_eval = capture
    return results


def _setup(tmp_path, model_type, in_hw, n_val, seed, dataset_type="MSCOCO", **extra):
    root = str(tmp_path / "synth")
    generate_synthetic_coco(root, n_train=1, n_val=n_val, seed=seed, sizes=(in_hw,),
                            emit_mpii=dataset_type == "MPII")
    out = []
    for C, get_dataset, M in ((JC, j_get_dataset, JM), (PC, p_get_dataset, PM)):
        C.set_model_type(C.MODEL[model_type])
        if "backbone" in extra:
            C.set_model_backbone(C.BACKBONE[extra["backbone"]])
        C.set_dataset_type(C.DATA[dataset_type])
        C.set_dataset_path(root + ("/mpii" if dataset_type == "MPII" else ""))
        C.set_compute_dtype("float32")
        cfg = C.get_config(create_dirs=False)
        out.append((cfg, get_dataset(cfg), M.get_topology(cfg)))
    return root, out


def _val_people(root):
    with open(os.path.join(root, "annotations", "person_keypoints_val2017.json")) as f:
        val = json.load(f)
    people = {}
    for a in val["annotations"]:
        if not a["iscrowd"]:
            people.setdefault(a["image_id"], []).append(a)
    sizes = {im["id"]: (im["height"], im["width"]) for im in val["images"]}
    return people, sizes


def _run_both(setups, in_hw, batches_j, batches_p, decode_j, decode_p, batch_size,
              metric, tmp_path):
    """Both evaluators over the same records; returns (JAX metrics, port
    metrics, JAX results, port results)."""
    (jcfg, jds, jtopo), (pcfg, pds, ptopo) = setups
    jres = _capture(jds)
    jev = _JaxReplay(None, None, jds, in_hw, jds.output_converter, jtopo,
                     batch_size=batch_size)
    jev.set_batches(batches_j, decode_j)
    pev = _Replay(None, pds, in_hw, pds.output_converter, ptopo, batch_size=batch_size,
                  device="cpu")
    pev.set_batches(batches_p, decode_p)
    want = jev.evaluate(records=jds.get_eval_records(), eval_dir=str(tmp_path / "j"))
    got = pev.evaluate(records=pds.get_eval_records(), eval_dir=str(tmp_path / "p"))
    assert abs(got[metric] - want[metric]) <= 1e-3, (got, want)
    return want, got, jres, pev.results


def _people_px(a, b):
    """Person by person (`chip_smoke.same_people`), in pixels."""
    ids = {r["image_id"] for r in a} | {r["image_id"] for r in b}
    return same_people(a, b, {i: (1, 1) for i in ids})


def _paint(records, kpts_of_record, n_pos, limbs, in_hw, batch_size, max_people):
    feat_hw = (in_hw[0] // 8, in_hw[1] // 8)
    return [tuple(np.asarray(m) for m in b) for b in paint_batches(
        records, kpts_of_record, n_pos, limbs, in_hw, feat_hw, batch_size, max_people)]


def _jax_paf_decode(ev):
    def decode(maps):
        conf, paf = (jnp.asarray(m) for m in maps)
        b, h, w, _ = conf.shape
        dec = (b, h * EVAL_UPSAMPLE, w * EVAL_UPSAMPLE)
        return ev._decode(jax.image.resize(conf, (*dec, conf.shape[-1]), "cubic"),
                          jax.image.resize(paf, (*dec, paf.shape[-1]), "cubic"))
    return decode


def _port_paf_decode(ev):
    def decode(maps):
        conf, paf = (torch.from_numpy(m) for m in maps)
        dec = (conf.shape[1] * EVAL_UPSAMPLE, conf.shape[2] * EVAL_UPSAMPLE)
        return ev._decode(jax_resize_cubic(conf, dec), jax_resize_cubic(paf, dec))
    return decode


def _paf_loop(setups, in_hw, batches, batch_size, metric, tmp_path):
    (jcfg, jds, jtopo), (pcfg, pds, ptopo) = setups

    class J(_JaxReplay):
        def infer_batch(self, images_u8):
            return _jax_paf_decode(self)(self._batches.pop(0))

    class P(_Replay):
        def infer_batch(self, images_u8):
            return _port_paf_decode(self)(self._batches.pop(0))

    jres = _capture(jds)
    jev = J(None, None, jds, in_hw, jds.output_converter, jtopo, batch_size=batch_size)
    jev.set_batches(batches, None)
    pev = P(None, pds, in_hw, pds.output_converter, ptopo, batch_size=batch_size,
            device="cpu")
    pev.set_batches(batches, None)
    want = jev.evaluate(records=jds.get_eval_records(), eval_dir=str(tmp_path / "j"))
    got = pev.evaluate(records=pds.get_eval_records(), eval_dir=str(tmp_path / "p"))
    assert abs(got[metric] - want[metric]) <= 1e-3, (got, want)
    d_xy, d_s = _people_px(jres, pev.results)
    assert d_xy <= 1e-3 and d_s <= 1e-3
    return want


def test_gt_painted_coco_loop_matches(tmp_path):
    in_hw = (368, 432)
    root, setups = _setup(tmp_path, "LightweightOpenpose", in_hw, 4, 5, backbone="Vggtiny")
    (jcfg, jds, jtopo) = setups[0]
    people, _ = _val_people(root)
    records = jds.get_eval_records()

    def kpts_of_record(rec):
        out = []
        for ann in people.get(rec.image_id, []):
            k3 = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
            out.append(coco17_to_model(k3[:, :2], k3[:, 2] > 0, OPPS_FROM_COCO17,
                                       jcfg.model.n_pos))
        return out

    max_people = max(len(v) for v in people.values())
    batches = _paint(records, kpts_of_record, jcfg.model.n_pos, jtopo.limbs, in_hw, 2,
                     max_people)
    want = _paf_loop(setups, in_hw, batches, 2, "AP", tmp_path)
    assert want["AP"] > 0.5


def test_gt_painted_mpii_loop_matches(tmp_path):
    in_hw = (368, 432)
    _, setups = _setup(tmp_path, "LightweightOpenpose", in_hw, 4, 11, "MPII",
                       backbone="Vggtiny")
    (jcfg, jds, jtopo) = setups[0]
    entries = jds._eval_entries()
    records = jds.get_eval_records()

    def kpts_of_record(rec):
        return [jds._native_to_model(np.asarray(p["joints"], np.float32))
                for p in entries[rec.image_id]["people"]]

    max_people = max(len(e["people"]) for e in entries)
    batches = _paint(records, kpts_of_record, jcfg.model.n_pos, jtopo.limbs, in_hw, 2,
                     max_people)
    want = _paf_loop(setups, in_hw, batches, 2, "PCKh", tmp_path)
    assert want["PCKh"] > 0.5


def test_gt_painted_ppn_loop_matches(tmp_path):
    """Painted PoseProposal grid targets (JAX's `ppn_targets`) decoded by
    each package's `restore_coor` and `ppn_decode_batch`."""
    in_hw = (384, 384)
    root, setups = _setup(tmp_path, "PoseProposal", in_hw, 4, 17)
    (jcfg, jds, jtopo), (pcfg, _, ptopo) = setups
    m = jcfg.model
    out_hw = (m.hout, m.wout)
    people, sizes = _val_people(root)
    records = jds.get_eval_records()
    max_people = max(len(v) for v in people.values())
    inst = instance_part_idx(ptopo)
    jmodel = JPoseProposal(K=m.n_pos, L=len(jtopo.limbs), hnei=m.hnei, wnei=m.wnei,
                           hin=m.hin, win=m.win)
    pmodel = PPoseProposal(K=m.n_pos, L=len(ptopo.limbs), hnei=m.hnei, wnei=m.wnei,
                           hin=m.hin, win=m.win)
    batches = []
    for i in range(0, len(records), 2):
        kpts = np.full((2, max_people, m.n_pos, 2), -1000.0, np.float32)
        valid = np.zeros((2, max_people, m.n_pos), bool)
        bbxs = np.zeros((2, max_people, 4), np.float32)
        for j, rec in enumerate(records[i:i + 2]):
            oh, ow = sizes[rec.image_id]
            sx, sy = in_hw[1] / ow, in_hw[0] / oh
            for p, ann in enumerate(people.get(rec.image_id, [])):
                k3 = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
                bb = np.asarray(ann["bbox"], np.float32) * (sx, sy, sx, sy)
                kpts[j, p], valid[j, p] = coco17_to_model(
                    k3[:, :2] * (sx, sy), k3[:, 2] > 0, PPN_FROM_COCO17, m.n_pos, bbox=bb)
                bbxs[j, p] = bb
        t = ppn_targets(jnp.asarray(kpts), jnp.asarray(valid), jnp.asarray(bbxs), jtopo.limbs,
                        in_hw, out_hw, nei=(m.hnei, m.wnei), instance_idx=inst)
        batches.append({k: np.asarray(v) for k, v in t.items()})

    def decode_j(t):
        rx, ry, rw, rh = jmodel.restore_coor(t["x"], t["y"], t["w"], t["h"], *out_hw)
        out = j_ppn_decode({"c": t["c"], "i": t["c"], "x": rx, "y": ry, "w": rw, "h": rh,
                            "e": t["e"]}, JPpnCfg(instance_part=inst), hnei=m.hnei,
                           wnei=m.wnei, in_hw=in_hw, topology=jtopo)
        return JSkeletonBatch(*(np.asarray(v) for v in (
            out.coords, out.part_scores, out.part_valid, out.scores, out.valid)))

    def decode_p(t):
        t = {k: torch.from_numpy(v) for k, v in t.items()}
        rx, ry, rw, rh = pmodel.restore_coor(t["x"], t["y"], t["w"], t["h"], *out_hw)
        return to_host(p_ppn_decode({"c": t["c"], "i": t["c"], "x": rx, "y": ry, "w": rw,
                                     "h": rh, "e": t["e"]}, PPpnCfg(instance_part=inst),
                                    hnei=m.hnei, wnei=m.wnei, in_hw=in_hw, topology=ptopo))

    want, _, jres, pres = _run_both(setups, in_hw, batches, batches, decode_j, decode_p, 2,
                                    "AP", tmp_path)
    assert want["AP"] > 0.2
    d_xy, d_s = _people_px(jres, pres)
    assert d_xy <= 1e-3 and d_s <= 1e-3


def test_gt_painted_pifpaf_loop_matches(tmp_path):
    """Painted CIF / CAF fields fed back as raw outputs, decoded by each
    package's `pifpaf_decode_batch`."""
    in_hw = (368, 432)
    root, setups = _setup(tmp_path, "Pifpaf", in_hw, 4, 13)
    (jcfg, jds, jtopo), (pcfg, _, ptopo) = setups
    people, _ = _val_people(root)
    records = jds.get_eval_records()
    max_people = max(len(v) for v in people.values())
    batches = []
    for i in range(0, len(records), 2):
        kpts = np.full((2, max_people, 17, 2), -1000.0, np.float32)
        valid = np.zeros((2, max_people, 17), bool)
        for j, rec in enumerate(records[i:i + 2]):
            for p, ann in enumerate(people.get(rec.image_id, [])):
                k3 = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
                kpts[j, p], valid[j, p] = k3[:, :2], k3[:, 2] > 0
        batches.append(paint_raw_predict(kpts, valid, jtopo.limbs))

    jev = GtPaintedPifPafEvaluator(None, None, jds, in_hw, jds.output_converter, jtopo,
                                   batch_size=2)
    jev.set_batches(batches, jtopo)

    def decode_p(predict):
        return to_host(p_pifpaf_decode(predict, PPifCfg(), 8, in_hw, ptopo))

    want, _, jres, pres = _run_both(setups, in_hw, batches, batches,
                                    lambda b: jev.infer_batch(None), decode_p, 2, "AP",
                                    tmp_path)
    assert want["AP"] > 0.4
    d_xy, d_s = _people_px(jres, pres)
    assert d_xy <= 1e-3 and d_s <= 1e-3


# -- the trained flagship, multiscale ------------------------------------------------------

def _flagship_pair(root, in_hw=(368, 432)):
    """(JAX evaluator, port evaluator) of the committed flagship in f32 on
    the synthetic set at `root`."""
    out = []
    for C in (JC, PC):
        C.set_model_type(C.MODEL.LightweightOpenpose)
        C.set_model_backbone(C.BACKBONE.Vggtiny)
        C.set_compute_dtype("float32")
        C.set_dataset_path(root)
        out.append(C.get_config(create_dirs=False))
    jcfg, pcfg = out
    jm = JM.get_model(jcfg)
    variables = load_weights_npz(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, *in_hw, 3)),
                                         train=False), FLAGSHIP_NPZ)
    jds, pds = j_get_dataset(jcfg), p_get_dataset(pcfg)
    jev = JEvaluator(jm, variables, jds, in_hw, jds.output_converter, JM.get_topology(jcfg))
    pm = load_flax_weights(PM.get_model(pcfg), FLAGSHIP_NPZ)
    pev = PM.evaluator(pcfg, pm, pds, device="cpu")
    return jev, pev


def test_flagship_evaluation_matches_jax(tmp_path):
    """The first 8 val scenes of the seed-0 synthetic set (the JAX
    fixture's), f32, batch 8: persons within 0.05 px, AP within 0.01."""
    root = str(tmp_path / "synth")
    generate_synthetic_coco(root, n_train=0, n_val=8, seed=0, emit_mpii=False)
    jev, pev = _flagship_pair(root)
    jres = _capture(jev.dataset)
    want = jev.evaluate(eval_dir=str(tmp_path / "j"))
    got = pev.evaluate(eval_dir=str(tmp_path / "p"))
    assert abs(got["AP"] - want["AP"]) <= 0.01
    assert len(pev.results) == len(jres) > 8
    d_xy, _ = _people_px(jres, pev.results)
    assert d_xy <= 0.05
    assert pev.stats.images == 8 and pev.stats.batches == 1


def test_multiscale_maps_match_jax(tmp_path):
    """Multiscale at 96x128 on 2 scenes, seeded weights: the averaged decode
    maps within 1e-5 of JAX's."""
    in_hw = (96, 128)
    root = str(tmp_path / "synth")
    generate_synthetic_coco(root, n_train=0, n_val=2, seed=3, sizes=(in_hw,),
                            emit_mpii=False)
    flat = random_flat(4)
    out = []
    for C in (JC, PC):
        C.set_model_type(C.MODEL.LightweightOpenpose)
        C.set_model_backbone(C.BACKBONE.Vggtiny)
        C.set_compute_dtype("float32")
        C.set_model_inout(hin=96, win=128, hout=12, wout=16)
        C.set_dataset_path(root)
        out.append(C.get_config(create_dirs=False))
    jcfg, pcfg = out
    jm = JM.get_model(jcfg)
    jev = JEvaluator(jm, nest(flat), j_get_dataset(jcfg), in_hw, None, JM.get_topology(jcfg),
                     batch_size=2, multiscale=True)
    pev = Evaluator(load_flax_weights(PM.get_model(pcfg), flat), None, in_hw, None,
                    PM.get_topology(pcfg), batch_size=2, multiscale=True, device="cpu")
    images = np.random.default_rng(6).integers(0, 255, (2, *in_hw, 3), dtype=np.uint8)
    seen = []
    jev._decode = lambda conf, paf: seen.append((np.asarray(conf), np.asarray(paf)))
    jev.infer_batch(images)
    conf, paf = pev.maps(images)
    for got, want in zip((conf.numpy(), paf.numpy()), seen[0]):
        assert got.shape == want.shape == (2, 24, 32, want.shape[-1])
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)
    sk = pev.infer_batch(images)
    assert sk.coords.shape[0] == 2


# -- the entry points ----------------------------------------------------------------------

def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(REPO, name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _last_line(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_tools_eval_prints_jax_eval_metrics(tmp_path, monkeypatch, dtype):
    """`--synthetic --synthetic_train_scenes 2 --eval_num 4` on the committed
    flagship: the port's tool (`--device cpu`) prints the metrics dict JAX's
    `eval.py` prints with the same flags, both in their config's dtype
    (bfloat16), each metric within 0.005 (XLA and torch sum the bf16 convs
    in other orders, and a few keypoints move). The float32 parity of the
    same path is `test_flagship_evaluation_matches_jax`'s."""
    import ast

    from hyperpose_torch.tools import eval as tool

    data = str(tmp_path / "data")
    flags = ["--synthetic", "--synthetic_train_scenes", "2", "--eval_num", "4",
             "--model_type", "LightweightOpenpose", "--model_backbone", "Vggtiny",
             "--weights", FLAGSHIP_NPZ, "--dataset_path", data]
    monkeypatch.chdir(tmp_path)
    jax_eval = _load_script("eval.py")
    monkeypatch.setattr(sys, "argv", ["eval.py"] + flags)
    want = _last_line(jax_eval.main)
    got = _last_line(lambda: tool.main(flags + ["--device", "cpu"]))
    for cfg in (JC.get_config(create_dirs=False), PC.get_config(create_dirs=False)):
        assert cfg.model.compute_dtype == dtype
    got, want = ast.literal_eval(got), ast.literal_eval(want)
    assert got.keys() == want.keys() and "AP" in want
    assert all(abs(got[k] - want[k]) <= 0.005 for k in want), (got, want)


def test_evaluator_step_runs_with_tf32_off():
    """The evaluator, not its callers, keeps a float32 step in float32: the
    network (and a family's fused decode) runs with TF32 off for cuDNN and
    cuBLAS, and the flags are as they were afterwards."""
    from hyperpose_torch.ops.paf_decode import paf_decode_batch
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY

    seen = []

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(flags())
            b, h, w, _ = x.shape
            return {"conf_map": x.new_zeros(b, h // 8, w // 8, 19),
                    "paf_map": x.new_zeros(b, h // 8, w // 8, 38)}

    def fused(x):
        seen.append(flags())
        maps = Probe()(x.to(torch.float32))
        conf = jax_resize_cubic(maps["conf_map"], (16, 16))
        paf = jax_resize_cubic(maps["paf_map"], (16, 16))
        return paf_decode_batch(conf, paf, ev.decoder, None, COCO_TOPOLOGY)

    images = np.zeros((2, 64, 64, 3), np.uint8)
    before = flags()
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        ev = Evaluator(Probe(), None, (64, 64), None, COCO_TOPOLOGY, batch_size=2,
                       device="cpu")
        assert ev.infer_batch(images).coords.shape[0] == 2
        ev._fused_decode = fused
        assert ev.infer_batch(images).coords.shape[0] == 2
        assert flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    assert seen == [(False, False)] * 3


def test_tools_raise_without_a_gpu(tmp_path):
    """The entry points run on the card unless `--device cpu` is given; with
    no GPU they raise instead of carrying on on the CPU."""
    from hyperpose_torch.tools import eval as tool
    from hyperpose_torch.tools import official_test

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.run(["--eval_num", "1", "--dataset_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        official_test.run(["--dataset_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(None, None, (96, 128), None, None)


def test_get_evaluate_get_test_and_official_test(tmp_path, monkeypatch):
    """`Model.get_evaluate` / `get_test` on a small seeded model at 96x128,
    and `tools.official_test` writing the same submission `get_test` does
    (no test split: the val records)."""
    from hyperpose_torch.tools import official_test

    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "synth")
    generate_synthetic_coco(root, n_train=0, n_val=3, seed=1, sizes=((96, 128),),
                            emit_mpii=False)
    PC.set_model_type(PC.MODEL.LightweightOpenpose)
    PC.set_model_backbone(PC.BACKBONE.Vggtiny)
    PC.set_model_inout(hin=96, win=128, hout=12, wout=16)
    PC.set_dataset_path(root)
    cfg = PC.get_config()
    flat = random_flat(1)
    model = load_flax_weights(PM.get_model(cfg), flat)
    metrics = PM.get_evaluate(cfg)(model, p_get_dataset(cfg), limit=2, device="cpu")
    assert "AP" in metrics and "AR" in metrics
    path = PM.get_test(cfg)(model, p_get_dataset(cfg), device="cpu")
    with open(path) as f:
        submitted = json.load(f)
    np.savez(tmp_path / "w.npz", **flat)
    out = official_test.run(["--model_backbone", "Vggtiny", "--dataset_path", root,
                             "--weights", str(tmp_path / "w.npz"), "--device", "cpu"])
    assert out == path and os.path.exists(out)
    assert all(r["image_id"] > 10**6 for r in submitted)
