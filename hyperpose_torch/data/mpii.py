"""MPII human-pose dataset with PCKh@0.5 official evaluation.

(reference: hyperpose/Dataset/mpii_dataset/ — mat->json conversion, meta
classes, converters, dataset.py:102+ in-house PCKh evaluation.)

Annotation format: a single json produced from the official
`mpii_human_pose_v1_u12_1.mat` (see `convert_mpii_mat` below when scipy is
available), of the form
  [{"image": "000001163.jpg", "img_train": 1,
    "people": [{"joints": [[x, y, vis] x 16], "headbox": [x1, y1, x2, y2]}]}]
Joint order is the MPII native order (rankle..headtop, see JOINT_NAMES).
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np

from .augment import MISSING
from .base import BasePoseDataset, EvalRecord, TrainRecord

logger = logging.getLogger("hyperpose_torch.DATA")

# MPII native joint order (reference: mpii_dataset/define.py).
JOINT_NAMES = [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "pelvis",
    "thorax", "upperneck", "headtop", "rwrist", "relbow", "rshoulder",
    "lshoulder", "lelbow", "lwrist",
]

# MpiiPart (model 15-part + bg) row -> MPII native joint index; the Center
# row (-2) is synthesized from the pelvis/thorax midpoint
# (reference: openpose/define.py:86-101 MPII variant with Center part).
# When the model carries 16 rows (PoseProposal: pose_proposal/define.py
# MpiiPart.Instance=15), row 15 is the Instance anchor (-3), synthesized
# as the visible-joint centroid (MPII has no person boxes; the reference's
# COCO PPN anchor is the bbox center, mscoco_dataset/define.py:72-98).
MPII_FROM_NATIVE = np.array(
    [9, 8, 12, 11, 10, 13, 14, 15, 2, 1, 0, 3, 4, 5, -2],
    np.int32,
)
# PoseProposal layout: + Instance anchor at row 15 (openpose-MPII models
# keep row 15 as Background and must NOT get a target there).
MPII_PPN_FROM_NATIVE = np.concatenate([MPII_FROM_NATIVE, [-3]]).astype(np.int32)
_PELVIS, _THORAX = 6, 7


def convert_mpii_mat(mat_path: str, out_json: str) -> str:
    """Convert the official MPII .mat annotations to our json format.
    Requires scipy (gated import; not part of the test path)."""
    import scipy.io  # noqa: PLC0415

    mat = scipy.io.loadmat(mat_path, struct_as_record=False,
                           squeeze_me=True)["RELEASE"]
    entries = []
    annolist = np.atleast_1d(mat.annolist)
    img_train = np.atleast_1d(mat.img_train)
    for i, anno in enumerate(annolist):
        people = []
        rects = np.atleast_1d(getattr(anno, "annorect", []))
        for rect in rects:
            joints = np.full((16, 3), 0.0)
            try:
                points = np.atleast_1d(rect.annopoints.point)
            except AttributeError:
                points = []
            for pt in points:
                jid = int(pt.id)
                vis = getattr(pt, "is_visible", 1)
                try:
                    vis = int(vis)
                except (TypeError, ValueError):
                    vis = 1
                joints[jid] = (float(pt.x), float(pt.y), max(vis, 1))
            headbox = [
                float(getattr(rect, "x1", 0)), float(getattr(rect, "y1", 0)),
                float(getattr(rect, "x2", 0)), float(getattr(rect, "y2", 0)),
            ]
            if joints[:, 2].any() or any(headbox):
                people.append({
                    "joints": joints.tolist(), "headbox": headbox,
                })
        if people:
            entries.append({
                "image": str(anno.image.name),
                "img_train": int(img_train[i]),
                "people": people,
            })
    with open(out_json, "w") as f:
        json.dump(entries, f)
    return out_json


class MpiiPoseDataset(BasePoseDataset):
    """MPII dataset: 15-part model topology, PCKh@0.5 official metric."""

    def __init__(self, config):
        from ..config import MODEL

        self.config = config
        d = config.data
        self.root = d.dataset_path
        self.n_rows = config.model.n_pos
        self.layout = (
            MPII_PPN_FROM_NATIVE
            if config.model.model_type == MODEL.PoseProposal
            else MPII_FROM_NATIVE
        )
        self.ann_json = os.path.join(self.root, "mpii_annotations.json")
        self.image_dir = os.path.join(self.root, "images")
        self._entries = None

    def _load(self):
        if self._entries is None:
            if not os.path.exists(self.ann_json):
                mat = os.path.join(
                    self.root, "mpii_human_pose_v1_u12_1.mat"
                )
                if os.path.exists(mat):
                    convert_mpii_mat(mat, self.ann_json)
                else:
                    raise FileNotFoundError(
                        f"MPII annotations not found: {self.ann_json} (or "
                        f"{mat} for on-the-fly conversion)"
                    )
            with open(self.ann_json) as f:
                self._entries = json.load(f)
        return self._entries

    def _native_to_model(self, joints: np.ndarray):
        kpts = np.full((self.n_rows, 2), MISSING, np.float32)
        valid = np.zeros((self.n_rows,), bool)
        vis = joints[:, 2] > 0
        for row, src in enumerate(self.layout):
            if row >= self.n_rows:
                break
            if src >= 0 and vis[src]:
                kpts[row] = joints[src, :2]
                valid[row] = True
            elif src == -2 and vis[_PELVIS] and vis[_THORAX]:
                kpts[row] = (joints[_PELVIS, :2] + joints[_THORAX, :2]) / 2.0
                valid[row] = True
            elif src == -3 and vis.any():
                kpts[row] = joints[vis, :2].mean(axis=0)
                valid[row] = True
        return kpts, valid

    def get_train_records(self) -> list[TrainRecord]:
        records = []
        for entry in self._load():
            if not entry.get("img_train", 1):
                continue
            path = os.path.join(self.image_dir, entry["image"])
            if not os.path.exists(path):
                continue
            ks, vs = [], []
            for person in entry["people"]:
                k, v = self._native_to_model(
                    np.asarray(person["joints"], np.float32)
                )
                if v.any():
                    ks.append(k)
                    vs.append(v)
            if ks:
                records.append(TrainRecord(path, np.stack(ks), np.stack(vs)))
        logger.info("MPII: %d training images", len(records))
        return records

    def _eval_entries(self):
        return [
            e for e in self._load() if e.get("img_train", 1) == 0
        ] or self._load()

    def get_eval_records(self) -> list[EvalRecord]:
        recs = []
        for i, entry in enumerate(self._eval_entries()):
            path = os.path.join(self.image_dir, entry["image"])
            if os.path.exists(path):
                recs.append(EvalRecord(path, i))
        return recs

    def get_test_records(self) -> list[EvalRecord]:
        return self.get_eval_records()

    def official_eval(self, pd_annotations, eval_dir) -> dict[str, float]:
        """PCKh@0.5 (reference: mpii_dataset/dataset.py:102+)."""
        from ..eval.mpii_eval import pckh_eval

        os.makedirs(eval_dir, exist_ok=True)
        with open(os.path.join(eval_dir, "pd_ann.json"), "w") as f:
            json.dump(pd_annotations, f)
        gt = {}
        for i, entry in enumerate(self._eval_entries()):
            kpts = np.stack([
                np.asarray(p["joints"], np.float32) for p in entry["people"]
            ])
            boxes = np.stack([
                np.asarray(p.get("headbox", (0, 0, 0, 0)), np.float32)
                for p in entry["people"]
            ])
            gt[i] = (kpts, boxes)
        return pckh_eval(pd_annotations, gt)

    def output_converter(self, kpts_xy: np.ndarray) -> list[float]:
        """Model rows -> MPII native 16*3 flat list."""
        out = np.zeros((16, 3), np.float32)
        for row, src in enumerate(self.layout):
            if row >= len(kpts_xy) or src < 0:
                continue
            x, y = kpts_xy[row]
            if x > -100.0 and y > -100.0:
                out[src] = (x, y, 1.0)
        return [float(v) for v in out.reshape(-1)]
