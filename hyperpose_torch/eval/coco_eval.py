"""COCO keypoint evaluation (OKS mAP) without pycocotools.

Implements the COCOeval 'keypoints' protocol the reference relies on
(reference: Dataset/mscoco_dataset/dataset.py:110-186 official_eval →
pycocotools COCOeval.summarize): per-image greedy matching by OKS at 10
thresholds 0.50:0.95, 101-point interpolated precision, maxDets=20, area
ranges all/medium/large; ground truth restricted to the predicted image set
(official_eval behavior). Validated against hand-derived cocoapi semantics
in tests/test_coco_eval_adversarial.py (greedy score-order matching,
equal-OKS later-gt-wins, crowd multi-match, num_keypoints==0 ignores,
maxDets truncation, inclusive area boundaries, unmatched out-of-range dt
ignores, stable score-tie ordering, 101-pt interpolation).

Intentional divergences from pycocotools:
  - metrics with no valid ground truth return NaN (cocoapi returns -1)
  - no 'small' area range (cocoapi keypoints summarize also omits it)
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from ..utils.topology import COCO_SIGMAS

OKS_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e10),
}
MAX_DETS = 20


def compute_oks(
    dt_kpts: np.ndarray, gt_kpts: np.ndarray, gt_area: float,
    gt_bbox: np.ndarray | None = None,
) -> float:
    """OKS between one detection and one ground truth.

    dt_kpts/gt_kpts: [17*3] flat triples. Matches cocoapi computeOks.
    """
    sigmas = COCO_SIGMAS.astype(np.float64)  # cocoapi computes OKS in f64
    vars_ = (2 * sigmas) ** 2
    xg, yg, vg = gt_kpts[0::3], gt_kpts[1::3], gt_kpts[2::3]
    xd, yd = dt_kpts[0::3], dt_kpts[1::3]
    k1 = int((vg > 0).sum())
    if k1 > 0:
        dx = xd - xg
        dy = yd - yg
    else:
        if gt_bbox is None:
            return 0.0
        x0, y0 = gt_bbox[0] - gt_bbox[2], gt_bbox[1] - gt_bbox[3]
        x1, y1 = gt_bbox[0] + 2 * gt_bbox[2], gt_bbox[1] + 2 * gt_bbox[3]
        dx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
        dy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
    e = (dx**2 + dy**2) / vars_ / (gt_area + np.spacing(1)) / 2.0
    if k1 > 0:
        e = e[vg > 0]
    return float(np.sum(np.exp(-e)) / e.shape[0])


class CocoKeypointEval:
    def __init__(self, gt_anno_path: str):
        with open(gt_anno_path) as f:
            data = json.load(f)
        self.gts_by_img: dict[int, list[dict]] = defaultdict(list)
        for ann in data.get("annotations", []):
            if ann.get("category_id", 1) != 1:
                continue
            self.gts_by_img[ann["image_id"]].append(ann)
        self.img_ids = {img["id"] for img in data.get("images", [])}

    def evaluate(
        self, pd_annotations: list[dict], verbose: bool = True
    ) -> dict[str, float]:
        """pd_annotations: COCO-format results
        [{image_id, category_id, keypoints (51 floats), score}].

        Evaluates only over images that appear in the predictions
        (reference: official_eval filters gt to the predicted subset).
        """
        dts_by_img: dict[int, list[dict]] = defaultdict(list)
        for dt in pd_annotations:
            dts_by_img[dt["image_id"]].append(dt)
        eval_imgs = sorted(dts_by_img.keys() & self.gts_by_img.keys()
                           | dts_by_img.keys())

        results = {}
        t = OKS_THRESHOLDS
        for area_name, area_rng in AREA_RANGES.items():
            per_img = []
            for img_id in eval_imgs:
                per_img.append(self._eval_img(
                    self.gts_by_img.get(img_id, []),
                    dts_by_img.get(img_id, []), area_rng,
                ))
            ap, ar, ap50, ap75 = self._accumulate(per_img)
            results[f"AP_{area_name}"] = ap
            results[f"AR_{area_name}"] = ar
            if area_name == "all":
                results["AP"] = ap
                results["AP50"] = ap50
                results["AP75"] = ap75
                results["AR"] = ar
        if verbose:
            for k in ["AP", "AP50", "AP75", "AP_medium", "AP_large", "AR"]:
                print(f"  {k:10s} = {results.get(k, float('nan')):.3f}")
        return results

    def _eval_img(self, gts, dts, area_rng):
        """Greedy per-image matching at all OKS thresholds (cocoapi
        evaluateImg)."""
        for g in gts:
            ignore = (
                g.get("iscrowd", 0)
                or g.get("num_keypoints", 0) == 0
                or g.get("area", 0) < area_rng[0]
                or g.get("area", 0) > area_rng[1]
            )
            g["_ignore"] = 1 if ignore else 0
        # Sort gts: non-ignored first (cocoapi sorts by _ignore).
        gts = sorted(gts, key=lambda g: g["_ignore"])
        dts = sorted(dts, key=lambda d: -d["score"])[:MAX_DETS]
        # Detection area = tight bbox over ALL keypoint xy (cocoapi loadRes
        # sets this for keypoint results); used for the unmatched-outside-
        # range ignore below.
        dt_area = np.zeros(len(dts))
        for di, d in enumerate(dts):
            k = np.asarray(d["keypoints"], np.float64)
            xs, ys = k[0::3], k[1::3]
            dt_area[di] = (xs.max() - xs.min()) * (ys.max() - ys.min())

        n_t = len(OKS_THRESHOLDS)
        gtm = np.zeros((n_t, len(gts)), dtype=np.int64) - 1
        dtm = np.zeros((n_t, len(dts)), dtype=np.int64) - 1
        gt_ignore = np.array([g["_ignore"] for g in gts], dtype=bool)
        dt_ignore = np.zeros((n_t, len(dts)), dtype=bool)

        if gts and dts:
            ious = np.zeros((len(dts), len(gts)))
            for di, d in enumerate(dts):
                dk = np.asarray(d["keypoints"], np.float64)
                for gi, g in enumerate(gts):
                    ious[di, gi] = compute_oks(
                        dk, np.asarray(g["keypoints"], np.float64),
                        g.get("area", 0.0),
                        np.asarray(g.get("bbox", [0, 0, 0, 0]), np.float64),
                    )
            for ti, thr in enumerate(OKS_THRESHOLDS):
                for di in range(len(dts)):
                    best_iou = min(thr, 1 - 1e-10)
                    best_gi = -1
                    for gi in range(len(gts)):
                        if gtm[ti, gi] >= 0 and not gts[gi].get("iscrowd", 0):
                            continue
                        # Once into ignored gts, stop if a real match exists.
                        if best_gi >= 0 and not gt_ignore[best_gi] \
                                and gt_ignore[gi]:
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best_gi = gi
                    if best_gi >= 0:
                        dtm[ti, di] = best_gi
                        gtm[ti, best_gi] = di
                        dt_ignore[ti, di] = gt_ignore[best_gi]
        # cocoapi evaluateImg: unmatched detections whose (kpt-bbox) area is
        # outside the range are ignored rather than counted as FPs.
        outside = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
        dt_ignore = dt_ignore | ((dtm < 0) & outside[None, :])
        scores = np.array([d["score"] for d in dts], np.float64)
        return {
            "dtm": dtm, "dt_ignore": dt_ignore, "scores": scores,
            "gt_ignore": gt_ignore,
        }

    @staticmethod
    def _accumulate(per_img):
        """101-point interpolated AP + AR (cocoapi accumulate/summarize)."""
        n_t = len(OKS_THRESHOLDS)
        if not per_img:
            return float("nan"), float("nan"), float("nan"), float("nan")
        scores = np.concatenate([e["scores"] for e in per_img])
        dtm = np.concatenate([e["dtm"] for e in per_img], axis=1)
        dtig = np.concatenate([e["dt_ignore"] for e in per_img], axis=1)
        n_gt = int(sum((~e["gt_ignore"]).sum() for e in per_img))
        if n_gt == 0:
            return float("nan"), float("nan"), float("nan"), float("nan")
        order = np.argsort(-scores, kind="mergesort")
        dtm = dtm[:, order]
        dtig = dtig[:, order]

        aps = np.zeros(n_t)
        ars = np.zeros(n_t)
        for ti in range(n_t):
            keep = ~dtig[ti]
            tps = (dtm[ti] >= 0) & keep
            fps = (dtm[ti] < 0) & keep
            tp_cum = np.cumsum(tps).astype(np.float64)
            fp_cum = np.cumsum(fps).astype(np.float64)
            rc = tp_cum / n_gt
            pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
            # Precision envelope (monotone non-increasing from the right).
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_POINTS, side="left")
            q = np.zeros(len(RECALL_POINTS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            aps[ti] = q.mean()
            ars[ti] = rc[-1] if len(rc) else 0.0
        return float(aps.mean()), float(ars.mean()), float(aps[0]), float(aps[5])
