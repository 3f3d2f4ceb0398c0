"""MPII PCKh evaluation — exact protocol parity with the reference.

Implements the reference's in-house PCKh metric
(reference: hyperpose/Dataset/mpii_dataset/dataset.py:102-236) exactly:

  - predictions are matched to ground truths PER IMAGE, prediction-major in
    descending score order; each prediction greedily takes the unmatched gt
    with the smallest visibility-weighted mean joint distance, where the
    distance masks pelvis/thorax (parts 6:8) and divides by the TOTAL
    visible-joint count (dataset.py:159-180)
  - unmatched gts contribute all-zero predictions (dataset.py:186-191)
  - head size = ||(w, h)|| of the head box — the box DIAGONAL, with NO
    0.6 SC_BIAS factor (dataset.py:202-203)
  - per-joint PCKh = 100 * #(dist <= thresh over ALL matched columns)
    / #visible — prediction visibility is not consulted and hits on
    invisible gt joints still count in the numerator (dataset.py:204-206,
    a quirk preserved for score parity)
  - "Mean" weights joints by their visibility frequency with pelvis/thorax
    masked; "Mean@0.1" averages thresholds 0.1..0.5 (dataset.py:207-229)

Validated against a sequential transcription oracle and analytic fixtures
in tests/test_mpii_eval.py.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

PCKH_THRESH = 0.5
MASKED_PARTS = slice(6, 8)  # pelvis, thorax — excluded from matching + Mean

MPII_PART_NAMES = [
    "rankle", "rknee", "rhip", "lhip", "lknee", "lankle", "pelvis",
    "thorax", "upperneck", "headtop", "rwrist", "relbow", "rshoulder",
    "lshoulder", "lelbow", "lwrist",
]
# reference MpiiPart enum values (mpii_dataset/define.py:4-20)
HEADTOP, UPPERNECK = 9, 8
PAIR_GROUPS = {
    "Shoulder": (12, 13), "Elbow": (11, 14), "Wrist": (10, 15),
    "Hip": (2, 3), "Knee": (1, 4), "Ankle": (0, 5),
}


def _match_image(preds: list[np.ndarray], gt_kpts: np.ndarray) -> np.ndarray:
    """Greedy prediction-major matching (reference dataset.py:159-185).

    preds: list of [16, 3] arrays already sorted by descending score.
    gt_kpts: [M, 16, 3]. Returns match_pd_ids [M] (-1 = unmatched).
    """
    m = gt_kpts.shape[0]
    match_pd_ids = np.full(m, -1, np.int64)
    vis_mask = np.ones(16)
    vis_mask[MASKED_PARTS] = 0
    for pi, pk in enumerate(preds):
        best_gt, best_dist = -1, np.inf
        for gi in range(m):
            if match_pd_ids[gi] != -1:
                continue
            gv = (gt_kpts[gi, :, 2] > 0).astype(np.float64)
            vis_num = gv.sum()
            if vis_num == 0:
                continue
            d = np.linalg.norm(
                (pk[:, :2] - gt_kpts[gi, :, :2])
                * (gv * vis_mask)[:, None], axis=-1,
            ).sum() / vis_num
            if d < best_dist:
                best_dist, best_gt = d, gi
        if best_gt != -1:
            match_pd_ids[best_gt] = pi
    return match_pd_ids


def pckh_eval(
    pd_annotations: list[dict],
    gt: dict[int, tuple[np.ndarray, np.ndarray]],
    thresh: float = PCKH_THRESH,
) -> dict[str, float]:
    """pd_annotations: [{image_id, keypoints (16*3 native order), score}].
    gt: image_id -> (kpts [M, 16, 3], head_boxes [M, 4] x1y1x2y2).

    Returns the reference's result dict (Head/Shoulder/.../Mean/Mean@0.1 on
    a 0-100 scale) plus per-part `PCKh_<name>` and a 0-1 `PCKh` alias of
    Mean for programmatic use.
    """
    preds_by_img: dict[int, list[tuple[float, np.ndarray]]] = defaultdict(list)
    for ann in pd_annotations:
        preds_by_img[ann["image_id"]].append((
            float(ann["score"]),
            np.asarray(ann["keypoints"], np.float64).reshape(16, 3),
        ))

    all_pd, all_gt, all_vis, all_headsize = [], [], [], []
    # evaluate only over predicted images (reference dataset.py:149-158)
    for image_id in preds_by_img:
        if image_id not in gt:
            continue
        gt_kpts, head_boxes = gt[image_id]
        gt_kpts = np.asarray(gt_kpts, np.float64)
        head_boxes = np.asarray(head_boxes, np.float64)
        order = np.argsort([-s for s, _ in preds_by_img[image_id]],
                           kind="stable")
        preds = [preds_by_img[image_id][i][1] for i in order]
        match_pd_ids = _match_image(preds, gt_kpts)
        for gi in range(gt_kpts.shape[0]):
            all_gt.append(gt_kpts[gi, :, :2])
            all_vis.append((gt_kpts[gi, :, 2] > 0).astype(np.float64))
            all_headsize.append(
                np.linalg.norm(head_boxes[gi, 2:4] - head_boxes[gi, 0:2])
            )
            pi = match_pd_ids[gi]
            all_pd.append(preds[pi][:, :2] if pi != -1 else np.zeros((16, 2)))

    nan = float("nan")
    if not all_gt:
        out = {k: nan for k in
               ["Head", "Shoulder", "Elbow", "Wrist", "Hip", "Knee",
                "Ankle", "Mean", "Mean@0.1", "PCKh"]}
        out.update({f"PCKh_{n}": nan for n in MPII_PART_NAMES})
        return out

    pd_k = np.stack(all_pd)          # [N, 16, 2]
    gt_k = np.stack(all_gt)          # [N, 16, 2]
    vis = np.stack(all_vis)          # [N, 16]
    headsize = np.asarray(all_headsize)  # [N]

    with np.errstate(divide="ignore", invalid="ignore"):
        dist = np.linalg.norm(pd_k - gt_k, axis=-1) / headsize[:, None]
    jnt_vis_num = vis.sum(axis=0)    # [16]
    with np.errstate(divide="ignore", invalid="ignore"):
        pckh = 100.0 * np.nansum(
            (dist <= thresh).astype(np.float64), axis=0) / jnt_vis_num
        rng = np.arange(0.0, thresh + 0.1, 0.1)
        pck_all = np.stack([
            100.0 * (dist <= t).sum(axis=0) / jnt_vis_num for t in rng
        ])

    joint_mask = np.ones(16, bool)
    joint_mask[MASKED_PARTS] = False
    counted = jnt_vis_num * joint_mask
    jnt_ratio = counted / max(counted.sum(), np.spacing(1))
    mean = float(np.nansum(pckh * jnt_ratio))
    mean_01 = float(np.mean(np.nansum(pck_all[1:] * jnt_ratio, axis=1)))

    results = {
        "Head": float(pckh[HEADTOP]),
        "Mean": mean,
        "Mean@0.1": mean_01,
        "PCKh": mean / 100.0,
    }
    for name, (a, b) in PAIR_GROUPS.items():
        results[name] = float(0.5 * (pckh[a] + pckh[b]))
    for i, name in enumerate(MPII_PART_NAMES):
        results[f"PCKh_{name}"] = float(pckh[i]) / 100.0
    return results
