"""MSCOCO keypoint dataset: parsing, masking policy, keypoint converters.

(reference: hyperpose/Dataset/mscoco_dataset/ — format.py:26-144 PoseInfo/
CocoMeta annotation parsing + crowd/unannotated masking policy, define.py:
26-122 keypoint converters COCO<->{openpose 19-pt, ppn 18-pt, pifpaf 17-pt},
dataset.py:110-195 official_eval / official_test.)

Self-contained: COCO json is parsed with the stdlib and crowd RLE masks are
decoded in numpy — no pycocotools dependency (the evaluation protocol lives
in eval.coco_eval).
"""
from __future__ import annotations

import json
import logging
import os

import numpy as np

from .augment import MISSING
from .base import BasePoseDataset, EvalRecord, TrainRecord

logger = logging.getLogger("hyperpose_torch.DATA")

# Standard COCO keypoint order (== PifPafPart; reference: pifpaf/define.py).
COCO17_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

# CocoPart (openpose 18-part) index -> COCO17 index; -1 = synthesized Neck
# (reference: mscoco_dataset/define.py:26-70 opps converter, Neck =
# shoulder midpoint).
OPPS_FROM_COCO17 = np.array(
    [0, -1, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3],
    np.int32,
)
# PpnCocoPart index -> COCO17 index; -2 = Instance anchor (bbox center)
# (reference: define.py:72-98 ppn converter).
PPN_FROM_COCO17 = np.array(
    [0, -2, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3],
    np.int32,
)

_NECK_IDX = 1
_L_SHOULDER, _R_SHOULDER = 5, 6


def coco17_to_model(
    kpts17: np.ndarray, vis17: np.ndarray, layout: np.ndarray,
    n_rows: int, bbox: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """COCO 17-kpt person -> model-native rows.

    kpts17 [17, 2], vis17 [17] bool. layout maps model row -> COCO17 index
    (-1 = Neck midpoint, -2 = Instance anchor). Extra rows beyond the layout
    (e.g. the openpose Background row) stay invalid.
    """
    kpts = np.full((n_rows, 2), MISSING, np.float32)
    valid = np.zeros((n_rows,), bool)
    for row, src in enumerate(layout):
        if row >= n_rows:
            break
        if src >= 0:
            if vis17[src]:
                kpts[row] = kpts17[src]
                valid[row] = True
        elif src == -1:  # Neck = shoulder midpoint if both visible
            if vis17[_L_SHOULDER] and vis17[_R_SHOULDER]:
                kpts[row] = (kpts17[_L_SHOULDER] + kpts17[_R_SHOULDER]) / 2.0
                valid[row] = True
        elif src == -2:  # Instance anchor = person box center
            if bbox is not None and bbox[2] > 0 and bbox[3] > 0:
                kpts[row] = (
                    bbox[0] + bbox[2] / 2.0, bbox[1] + bbox[3] / 2.0
                )
                valid[row] = True
            elif vis17.any():
                kpts[row] = kpts17[vis17].mean(axis=0)
                valid[row] = True
    return kpts, valid


def model_to_coco17(kpts_xy: np.ndarray, layout: np.ndarray) -> list[float]:
    """Model-native [P, 2] (missing < -100) -> flat COCO 51-float keypoints
    (reference: define.py reverse converters used by official_eval)."""
    out = np.zeros((17, 3), np.float32)
    for row, src in enumerate(layout):
        if row >= len(kpts_xy) or src < 0:
            continue
        x, y = kpts_xy[row]
        if x > -100.0 and y > -100.0:
            out[src] = (x, y, 1.0)
    return [float(v) for v in out.reshape(-1)]


# ---------------------------------------------------------------------------
# RLE mask decoding (COCO compressed + uncompressed), numpy only
# ---------------------------------------------------------------------------

def rle_decode_counts(counts_str: str) -> list[int]:
    """Decode the COCO compressed-RLE LEB128-style counts string
    (matches pycocotools rleFrString)."""
    counts: list[int] = []
    i = 0
    n = len(counts_str)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts_str[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(rle: dict) -> np.ndarray:
    """COCO RLE segmentation -> [H, W] uint8 mask (column-major runs)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = rle_decode_counts(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(w, h).T  # column-major


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygon list or RLE dict) -> [H, W] uint8."""
    if isinstance(seg, dict):
        return rle_to_mask(seg)
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float32).reshape(-1, 2).astype(np.int32)
        cv2.fillPoly(mask, [pts], 1)
    return mask


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------

class CocoPoseDataset(BasePoseDataset):
    """COCO person-keypoints dataset for all model families.

    Masking policy (reference: format.py:62-144): crowd annotations and
    persons with zero labeled keypoints become don't-care mask regions;
    persons with >= `min_kpts` labeled keypoints become training people.
    """

    def __init__(self, config, min_kpts: int = 1):
        from ..config import MODEL

        self.config = config
        self.min_kpts = min_kpts
        d = config.data
        self.root = d.dataset_path
        self.version = str(d.dataset_version or "2017")
        mt = config.model.model_type
        if mt == MODEL.PoseProposal:
            self.layout = PPN_FROM_COCO17
        elif mt == MODEL.Pifpaf:
            self.layout = np.arange(17, dtype=np.int32)
        else:
            self.layout = OPPS_FROM_COCO17
        self.n_rows = config.model.n_pos
        self.dataset_filter = d.dataset_filter
        self._train_cache = None
        self._eval_cache = None

    # -- file layout -----------------------------------------------------------

    def _ann_path(self, split: str) -> str:
        return os.path.join(
            self.root, "annotations",
            f"person_keypoints_{split}{self.version}.json",
        )

    def _image_dir(self, split: str) -> str:
        return os.path.join(self.root, f"{split}{self.version}")

    # -- parsing -----------------------------------------------------------------

    def _parse_split(self, split: str):
        path = self._ann_path(split)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"COCO annotations not found: {path} — place the "
                f"person_keypoints_{split}{self.version}.json under "
                f"{self.root}/annotations (no auto-download in this "
                "environment)"
            )
        with open(path) as f:
            data = json.load(f)
        images = {img["id"]: img for img in data["images"]}
        by_img: dict[int, list[dict]] = {}
        for ann in data["annotations"]:
            if ann.get("category_id", 1) != 1:
                continue
            by_img.setdefault(ann["image_id"], []).append(ann)
        return images, by_img

    def _build_records(self, split: str) -> list[TrainRecord]:
        images, by_img = self._parse_split(split)
        img_dir = self._image_dir(split)
        records: list[TrainRecord] = []
        for image_id, anns in by_img.items():
            img = images.get(image_id)
            if img is None:
                continue
            img_path = os.path.join(img_dir, img["file_name"])
            if not os.path.exists(img_path):
                continue
            h, w = img["height"], img["width"]
            people_k, people_v, people_b, masked = [], [], [], []
            for ann in anns:
                flat = np.asarray(ann.get("keypoints", []), np.float32)
                n_labeled = (
                    int((flat.reshape(-1, 3)[:, 2] > 0).sum())
                    if flat.size else 0
                )
                if ann.get("iscrowd", 0) or n_labeled < self.min_kpts:
                    seg = ann.get("segmentation")
                    if seg:
                        masked.append(seg)
                    continue
                k3 = flat.reshape(-1, 3)
                kpts, valid = coco17_to_model(
                    k3[:, :2], k3[:, 2] > 0, self.layout, self.n_rows,
                    bbox=np.asarray(ann.get("bbox", (0, 0, 0, 0)), np.float32),
                )
                people_k.append(kpts)
                people_v.append(valid)
                people_b.append(np.asarray(
                    ann.get("bbox", (0, 0, 0, 0)), np.float32
                ))
            if not people_k:
                continue
            mask_fn = (
                _MaskBuilder(masked, h, w) if masked else None
            )
            records.append(TrainRecord(
                img_path, np.stack(people_k), np.stack(people_v),
                mask_fn=mask_fn, bbxs=np.stack(people_b),
            ))
        if callable(self.dataset_filter):
            records = [r for r in records if self.dataset_filter(r)]
        logger.info("COCO %s%s: %d training images", split, self.version,
                    len(records))
        return records

    # -- BasePoseDataset -----------------------------------------------------------

    def get_train_records(self) -> list[TrainRecord]:
        if self._train_cache is None:
            self._train_cache = self._build_records("train")
        return self._train_cache

    def get_eval_records(self) -> list[EvalRecord]:
        if self._eval_cache is None:
            images, by_img = self._parse_split("val")
            img_dir = self._image_dir("val")
            self._eval_cache = [
                EvalRecord(os.path.join(img_dir, img["file_name"]), iid)
                for iid, img in images.items()
                if iid in by_img
                and os.path.exists(os.path.join(img_dir, img["file_name"]))
            ]
        return self._eval_cache

    def get_test_records(self) -> list[EvalRecord]:
        """test-dev images (reference: base_dataset.py:239-269); falls back
        to val when the test split is absent locally."""
        path = os.path.join(
            self.root, "annotations",
            f"image_info_test-dev{self.version}.json",
        )
        if not os.path.exists(path):
            return self.get_eval_records()
        with open(path) as f:
            data = json.load(f)
        img_dir = os.path.join(self.root, f"test{self.version}")
        return [
            EvalRecord(os.path.join(img_dir, img["file_name"]), img["id"])
            for img in data["images"]
        ]

    def official_eval(self, pd_annotations, eval_dir) -> dict[str, float]:
        """(reference: mscoco_dataset/dataset.py:110-186 official_eval)."""
        from ..eval.coco_eval import CocoKeypointEval

        os.makedirs(eval_dir, exist_ok=True)
        out_path = os.path.join(eval_dir, "pd_ann.json")
        with open(out_path, "w") as f:
            json.dump(pd_annotations, f)
        evaluator = CocoKeypointEval(self._ann_path("val"))
        return evaluator.evaluate(pd_annotations)

    def output_converter(self, kpts_xy: np.ndarray) -> list[float]:
        return model_to_coco17(kpts_xy, self.layout)


class _MaskBuilder:
    """Lazily rasterizes don't-care segmentations into a [H, W] float mask
    (1 = supervise, 0 = ignore). Picklable/callable per TrainRecord."""

    def __init__(self, segmentations, h: int, w: int):
        self.segmentations = segmentations
        self.h = h
        self.w = w

    def __call__(self) -> np.ndarray:
        mask = np.ones((self.h, self.w), np.float32)
        for seg in self.segmentations:
            try:
                bad = segmentation_to_mask(seg, self.h, self.w)
                mask[bad > 0] = 0.0
            except Exception as exc:
                logger.warning("bad segmentation skipped: %s", exc)
        return mask
