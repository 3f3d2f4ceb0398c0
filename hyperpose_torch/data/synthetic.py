"""Synthetic multi-person pose benchmark (offline accuracy loop).

The environment has no network, so the reference's model-zoo mAP protocol
(reference: README.md "Accuracy" table produced via official_eval,
Dataset/mscoco_dataset/dataset.py:110-186) cannot be reproduced on real
COCO. This module generates a procedural multi-person dataset with exact
ground truth in REAL COCO/MPII disk layouts, so the complete data → train →
eval stack (CocoPoseDataset parsing + masking policy, target generation,
Evaluator, validated COCOeval/PCKh scorers) runs unmodified end to end and
produces regression-tested mAP/PCKh numbers (see ACCURACY.md).

Scene model: 2-6 articulated COCO-17 figures per image with randomized
pose, scale (log-uniform), position (may be partially out of frame),
painters-order occlusion tracked in an ownership buffer (visibility v=2
drawn / v=1 occluded / v=0 out of frame), optional crowd clusters emitted
as iscrowd=1 annotations with polygon segmentations (exercising the
crowd-masking policy), plus background distractors. Joints carry fixed
part-specific colors; limbs and torso carry per-person colors so multi-
person grouping still requires PAF assembly.
"""
from __future__ import annotations

import json
import os

import numpy as np

# COCO17 order (data.mscoco.COCO17_NAMES)
NOSE, LEYE, REYE, LEAR, REAR = 0, 1, 2, 3, 4
LSHO, RSHO, LELB, RELB, LWRI, RWRI = 5, 6, 7, 8, 9, 10
LHIP, RHIP, LKNE, RKNE, LANK, RANK = 11, 12, 13, 14, 15, 16

# internal extra joints (for MPII + rendering)
PELVIS, THORAX, UPPERNECK, HEADTOP = 17, 18, 19, 20
N_JOINTS = 21

# MPII native order (eval.mpii_eval.MPII_PART_NAMES) -> internal joint ids
MPII_FROM_INTERNAL = [
    RANK, RKNE, RHIP, LHIP, LKNE, LANK, PELVIS, THORAX, UPPERNECK, HEADTOP,
    RWRI, RELB, RSHO, LSHO, LELB, LWRI,
]

# fixed part-joint colors (RGB) — consistent appearance across the dataset
_PART_COLORS = np.array([
    (255, 64, 64), (255, 160, 64), (255, 255, 64), (160, 255, 64),
    (64, 255, 64), (64, 255, 160), (64, 255, 255), (64, 160, 255),
    (64, 64, 255), (160, 64, 255), (255, 64, 255), (255, 64, 160),
    (200, 120, 40), (40, 200, 120), (120, 40, 200), (220, 220, 120),
    (120, 220, 220),
], np.uint8)

_LIMB_SEGMENTS = [
    (LSHO, LELB), (LELB, LWRI), (RSHO, RELB), (RELB, RWRI),
    (LHIP, LKNE), (LKNE, LANK), (RHIP, RKNE), (RKNE, RANK),
    (THORAX, UPPERNECK),
]


def _dir(theta):
    """Unit vector, theta=0 pointing straight DOWN (image y grows down)."""
    return np.array([np.sin(theta), np.cos(theta)])


def sample_pose(rng: np.random.Generator) -> np.ndarray:
    """Random articulated skeleton, pelvis at origin, units of body height,
    y down. Returns [N_JOINTS, 2]."""
    j = np.zeros((N_JOINTS, 2))
    tilt = rng.uniform(-0.4, 0.4)
    up = -_dir(tilt)                       # torso "up" direction
    perp = np.array([up[1], -up[0]])       # person's left
    j[PELVIS] = (0.0, 0.0)
    j[THORAX] = j[PELVIS] + 0.30 * up
    j[UPPERNECK] = j[THORAX] + 0.05 * up
    j[HEADTOP] = j[UPPERNECK] + 0.14 * up
    facing = rng.choice([-1.0, 1.0])
    head_mid = j[UPPERNECK] + 0.08 * up
    j[NOSE] = head_mid + 0.015 * facing * perp
    j[LEYE] = head_mid + (0.012 + 0.020 * facing) * perp + 0.02 * up
    j[REYE] = head_mid + (-0.012 + 0.020 * facing) * perp + 0.02 * up
    j[LEAR] = head_mid + 0.045 * perp
    j[REAR] = head_mid - 0.045 * perp
    j[LSHO] = j[THORAX] + 0.085 * perp
    j[RSHO] = j[THORAX] - 0.085 * perp
    j[LHIP] = j[PELVIS] + 0.065 * perp
    j[RHIP] = j[PELVIS] - 0.065 * perp
    for sho, elb, wri, side in ((LSHO, LELB, LWRI, 1.0), (RSHO, RELB, RWRI, -1.0)):
        ua = tilt + rng.uniform(-1.6, 1.6)
        j[elb] = j[sho] + 0.16 * _dir(ua)
        fa = ua - side * rng.uniform(0.0, 2.2)
        j[wri] = j[elb] + 0.15 * _dir(fa)
    for hip, kne, ank in ((LHIP, LKNE, LANK), (RHIP, RKNE, RANK)):
        th = tilt + rng.uniform(-0.6, 0.6)
        j[kne] = j[hip] + 0.24 * _dir(th)
        sh = th + rng.uniform(-0.2, 1.1)   # knees bend backward
        j[ank] = j[kne] + 0.24 * _dir(sh)
    return j


def _person_colors(rng):
    hue = rng.uniform(0, 1)
    base = np.array([
        0.5 + 0.5 * np.sin(2 * np.pi * (hue + k / 3.0)) for k in range(3)
    ])
    torso = np.clip(base * 200 + 40, 0, 255).astype(np.uint8)
    limb = np.clip(base * 130 + 90, 0, 255).astype(np.uint8)
    skin = np.array(rng.choice([
        [236, 188, 160], [198, 134, 94], [141, 85, 56],
    ])).astype(np.uint8)
    return torso, limb, skin


def render_person(img, owner, joints_px, scale, pid, rng):
    """Draw one figure (painters order) into img (RGB) and owner (int32)."""
    import cv2

    torso_c, limb_c, skin_c = _person_colors(rng)
    thick = max(2, int(0.05 * scale))

    def _pts(*ids):
        return np.array([joints_px[i] for i in ids], np.int32)

    def draw(fn):
        fn(img, lambda c: tuple(int(v) for v in c))
        fn(owner, lambda c: int(pid + 1))

    # torso quad
    quad = _pts(LSHO, RSHO, RHIP, LHIP)
    draw(lambda buf, cv: cv2.fillConvexPoly(buf, quad, cv(torso_c)))
    # limbs
    for a, b in _LIMB_SEGMENTS:
        pa, pb = joints_px[a].astype(int), joints_px[b].astype(int)
        draw(lambda buf, cv, pa=pa, pb=pb: cv2.line(
            buf, tuple(pa), tuple(pb), cv(limb_c), thick))
    # head
    center = ((joints_px[UPPERNECK] + joints_px[HEADTOP]) / 2).astype(int)
    rad = max(2, int(0.075 * scale))
    draw(lambda buf, cv: cv2.circle(buf, tuple(center), rad, cv(skin_c), -1))
    # part-colored joint dots LAST so each person's own joints sample its id
    jrad = max(2, int(0.028 * scale))
    for p in range(17):
        pt = joints_px[p].astype(int)
        draw(lambda buf, cv, pt=pt, p=p: cv2.circle(
            buf, tuple(pt), jrad, cv(_PART_COLORS[p]), -1))


def render_scene(rng, hw, n_people_range=(2, 6), crowd_prob=0.15):
    """Render one scene. Returns (image u8 RGB, people list, crowds list).

    people: dicts with joints_px [N_JOINTS,2], vis [17] in {0,1,2},
    bbox (x,y,w,h), area, head_box x1y1x2y2.
    crowds: dicts with bbox, area, region polygon.
    """
    import cv2

    h, w = hw
    # background: vertical gradient + blocks + noise
    top = rng.integers(0, 120, 3)
    bot = rng.integers(80, 200, 3)
    t = np.linspace(0, 1, h)[:, None, None]
    img = (top * (1 - t) + bot * t).astype(np.uint8)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    for _ in range(int(rng.integers(2, 7))):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        x1 = min(w, x0 + int(rng.integers(20, w // 2)))
        y1 = min(h, y0 + int(rng.integers(20, h // 2)))
        color = tuple(int(v) for v in rng.integers(0, 255, 3))
        cv2.rectangle(img, (x0, y0), (x1, y1), color, -1)
    owner = np.zeros((h, w), np.int32)

    people = []
    n_people = int(rng.integers(*n_people_range, endpoint=True))
    scales = np.exp(rng.uniform(np.log(0.25 * h), np.log(0.95 * h), n_people))
    scales.sort()  # small (far) first: painters order
    for pid in range(n_people):
        s = scales[pid]
        local = sample_pose(rng)
        cx = rng.uniform(-0.1 * w, 1.1 * w)
        cy = rng.uniform(0.2 * h, 0.9 * h)
        joints_px = local * s + np.array([cx, cy])
        render_person(img, owner, joints_px, s, pid, rng)
        people.append({"joints_px": joints_px, "scale": s})

    crowds = []
    if rng.random() < crowd_prob:
        # crowd cluster: many tiny figures, single iscrowd region
        cw, ch_ = int(rng.uniform(0.25, 0.45) * w), int(rng.uniform(0.2, 0.35) * h)
        cx0 = int(rng.uniform(0, w - cw))
        cy0 = int(rng.uniform(0, h - ch_))
        crowd_pid = n_people + 100
        for _ in range(int(rng.integers(6, 13))):
            s = rng.uniform(0.15, 0.3) * ch_
            jp = sample_pose(rng) * s + np.array([
                rng.uniform(cx0 + 10, cx0 + cw - 10),
                rng.uniform(cy0 + 10, cy0 + ch_ - 10),
            ])
            render_person(img, owner, jp, s, crowd_pid, rng)
        crowds.append({
            "bbox": (cx0, cy0, cw, ch_),
            "area": float(cw * ch_),
            "segmentation": [[
                float(cx0), float(cy0), float(cx0 + cw), float(cy0),
                float(cx0 + cw), float(cy0 + ch_), float(cx0), float(cy0 + ch_),
            ]],
        })

    # per-person visibility / bbox / area from the ownership buffer
    for pid, person in enumerate(people):
        jp = person["joints_px"]
        vis = np.zeros(17, np.int32)
        for p in range(17):
            fx, fy = jp[p]
            if not (0 <= fx < w and 0 <= fy < h):
                continue
            x, y = int(fx), int(fy)
            y0, y1 = max(0, y - 1), min(h, y + 2)
            x0, x1 = max(0, x - 1), min(w, x + 2)
            vis[p] = 2 if (owner[y0:y1, x0:x1] == pid + 1).any() else 1
        ys, xs = np.nonzero(owner == pid + 1)
        if len(xs):
            bbox = (float(xs.min()), float(ys.min()),
                    float(xs.max() - xs.min() + 1),
                    float(ys.max() - ys.min() + 1))
            area = float(len(xs))
        else:
            labeled = jp[:17][vis > 0]
            if len(labeled) == 0:
                person["vis"] = vis
                person["bbox"] = None
                continue
            x0, y0 = labeled.min(axis=0)
            x1, y1 = labeled.max(axis=0)
            bbox = (float(x0), float(y0),
                    float(max(x1 - x0, 1)), float(max(y1 - y0, 1)))
            area = float(bbox[2] * bbox[3] * 0.5)
        person["vis"] = vis
        person["bbox"] = bbox
        person["area"] = area
        hc = (jp[UPPERNECK] + jp[HEADTOP]) / 2
        hr = 0.075 * person["scale"]
        person["head_box"] = (
            float(hc[0] - hr), float(hc[1] - hr),
            float(hc[0] + hr), float(hc[1] + hr),
        )

    noise = rng.normal(0, 6, img.shape)
    img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    return img, people, crowds


def _coco_person_ann(person, ann_id, image_id):
    jp, vis = person["joints_px"], person["vis"]
    kpts = []
    n_labeled = 0
    for p in range(17):
        v = int(vis[p])
        if v > 0:
            kpts += [float(jp[p, 0]), float(jp[p, 1]), v]
            n_labeled += 1
        else:
            kpts += [0.0, 0.0, 0]
    x, y, bw, bh = person["bbox"]
    return {
        "id": ann_id, "image_id": image_id, "category_id": 1,
        "keypoints": kpts, "num_keypoints": n_labeled,
        "bbox": [x, y, bw, bh], "area": person["area"], "iscrowd": 0,
        "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]],
    }


def generate_synthetic_coco(
    root: str, n_train: int = 400, n_val: int = 100, seed: int = 0,
    sizes=((368, 432), (427, 640), (480, 640), (384, 512)),
    version: str = "2017", jpeg_quality: int = 92, emit_mpii: bool = True,
    train_start: int = 0,
) -> str:
    """Write a synthetic dataset in real COCO layout under `root`:
      <root>/annotations/person_keypoints_{train,val}<version>.json
      <root>/{train,val}<version>/*.jpg
    and (emit_mpii) an MPII-format twin under <root>/mpii/:
      mpii_annotations.json + images/ (val scenes; img_train=0).

    Deterministic in (seed, n_train, n_val, sizes). Returns `root`.

    `train_start` shifts the train split to scene indices
    [train_start, train_start + n_train): per-scene seeding means these are
    exactly the scenes a longer train split would have continued with, so a
    tail slice beyond a model's training range is a held-out tune split
    (scripts/tune_ppn_decode.py). Must keep train_start + n_train < 10**6
    (the val scene-index offset).
    """
    import cv2

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    mpii_entries = []
    if emit_mpii:
        os.makedirs(os.path.join(root, "mpii", "images"), exist_ok=True)

    assert train_start + n_train < 10**6, "train scenes must stay below the val offset"
    for split, n_imgs, seed_off in (
        ("train", n_train, train_start), ("val", n_val, 10**6),
    ):
        img_dir = os.path.join(root, f"{split}{version}")
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(n_imgs):
            rng = np.random.default_rng(seed * 2**30 + seed_off + i)
            hw = sizes[int(rng.integers(0, len(sizes)))]
            img, people, crowds = render_scene(rng, hw)
            image_id = seed_off + i + 1
            fname = f"synth_{image_id:012d}.jpg"
            cv2.imwrite(
                os.path.join(img_dir, fname),
                cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
            )
            images.append({
                "id": image_id, "file_name": fname,
                "height": hw[0], "width": hw[1],
            })
            n_labeled_people = 0
            for person in people:
                if person["bbox"] is None or person["vis"].max() == 0:
                    continue
                annotations.append(_coco_person_ann(person, ann_id, image_id))
                ann_id += 1
                n_labeled_people += 1
            for crowd in crowds:
                x, y, bw, bh = crowd["bbox"]
                annotations.append({
                    "id": ann_id, "image_id": image_id, "category_id": 1,
                    "keypoints": [0.0] * 51, "num_keypoints": 0,
                    "bbox": [float(x), float(y), float(bw), float(bh)],
                    "area": crowd["area"], "iscrowd": 1,
                    "segmentation": crowd["segmentation"],
                })
                ann_id += 1
            if emit_mpii and n_labeled_people:
                mpii_name = f"mpii_{image_id:012d}.jpg"
                cv2.imwrite(
                    os.path.join(root, "mpii", "images", mpii_name),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
                )
                entry_people = []
                for person in people:
                    if person["bbox"] is None:
                        continue
                    jp, vis17 = person["joints_px"], person["vis"]
                    joints = np.zeros((16, 3))
                    for row, src in enumerate(MPII_FROM_INTERNAL):
                        joints[row, :2] = jp[src]
                        if src < 17:
                            joints[row, 2] = 1.0 if vis17[src] > 0 else 0.0
                        else:
                            x, y = jp[src]
                            h, w = hw
                            joints[row, 2] = float(
                                0 <= x < w and 0 <= y < h
                            )
                    entry_people.append({
                        "joints": joints.tolist(),
                        "headbox": list(person["head_box"]),
                    })
                mpii_entries.append({
                    "image": mpii_name,
                    "img_train": 1 if split == "train" else 0,
                    "people": entry_people,
                })
        ann = {
            # The JAX package's wording, kept so both packages write the same
            # annotation bytes from the same seed.
            "info": {"description": f"hyperpose_tpu synthetic ({split})"},
            "licenses": [],
            "images": images,
            "annotations": annotations,
            "categories": [{
                "id": 1, "name": "person", "supercategory": "person",
            }],
        }
        with open(os.path.join(
            root, "annotations", f"person_keypoints_{split}{version}.json",
        ), "w") as f:
            json.dump(ann, f)

    if emit_mpii:
        with open(os.path.join(root, "mpii", "mpii_annotations.json"), "w") as f:
            json.dump(mpii_entries, f)
    return root


DEFAULT_N_TRAIN = 400
DEFAULT_N_VAL = 100


def ensure_synthetic_dataset(
    path: str | None = None, seed: int = 0,
    n_train: int = DEFAULT_N_TRAIN, n_val: int = DEFAULT_N_VAL,
) -> str:
    """Generate the standard benchmark under `path` unless already present
    (train.py/eval.py --synthetic). Deterministic in seed."""
    root = path or "./data_synth"
    marker = os.path.join(root, ".synthetic_meta.json")
    meta = {"seed": seed, "n_train": n_train, "n_val": n_val, "rev": 2}
    if os.path.exists(marker):
        with open(marker) as f:
            have = json.load(f)
        # A dataset generated with MORE train scenes is a superset: per-scene
        # seeding makes scene i byte-identical regardless of n_train, and the
        # val split is offset-isolated — so eval/tune runs against a dir built
        # with --synthetic_train_scenes never clobber it by regenerating.
        if have == meta or (
            {k: have.get(k) for k in ("seed", "n_val", "rev")}
            == {k: meta[k] for k in ("seed", "n_val", "rev")}
            and have.get("n_train", -1) >= n_train
        ):
            return root
    generate_synthetic_coco(root, n_train=n_train, n_val=n_val, seed=seed)
    with open(marker, "w") as f:
        json.dump(meta, f)
    return root


# ---------------------------------------------------------------------------
# Synthetic ImageNet (backbone-pretraining twin)
# ---------------------------------------------------------------------------

_IN_SHAPES = ("circle", "square", "triangle", "star", "cross")
_IN_COLORS = (
    ("red", (220, 40, 40)), ("green", (40, 200, 60)),
    ("blue", (50, 80, 230)), ("yellow", (230, 210, 40)),
    ("magenta", (210, 50, 200)),
)


def _render_imagenet_sample(rng, size: int, shape: str, color) -> np.ndarray:
    """One class sample: textured background + the class shape at random
    position/scale/rotation with brightness jitter. Classification requires
    learning shape+color invariances, not a pixel lookup."""
    import cv2

    img = rng.integers(0, 90, (size, size, 3)).astype(np.uint8)
    # background distractor blobs (class-uninformative: gray)
    for _ in range(int(rng.integers(2, 6))):
        c = (int(rng.integers(0, size)), int(rng.integers(0, size)))
        g = int(rng.integers(90, 160))
        cv2.circle(img, c, int(rng.integers(2, size // 8 + 2)), (g, g, g), -1)
    scale = float(rng.uniform(0.25, 0.42)) * size
    cx = float(rng.uniform(scale, size - scale))
    cy = float(rng.uniform(scale, size - scale))
    rot = float(rng.uniform(0, 2 * np.pi))
    bright = float(rng.uniform(0.6, 1.25))
    col = tuple(int(min(255, v * bright)) for v in color)

    def pts(angles, radii):
        return np.stack([
            (cx + np.cos(a + rot) * r, cy + np.sin(a + rot) * r)
            for a, r in zip(angles, radii)
        ]).astype(np.int32)

    if shape == "circle":
        cv2.circle(img, (int(cx), int(cy)), int(scale), col, -1)
    elif shape == "square":
        ang = np.pi / 2 * np.arange(4) + np.pi / 4
        cv2.fillPoly(img, [pts(ang, [scale] * 4)], col)
    elif shape == "triangle":
        ang = 2 * np.pi / 3 * np.arange(3)
        cv2.fillPoly(img, [pts(ang, [scale] * 3)], col)
    elif shape == "star":
        ang = np.pi / 5 * np.arange(10)
        radii = [scale if i % 2 == 0 else scale * 0.45 for i in range(10)]
        cv2.fillPoly(img, [pts(ang, radii)], col)
    elif shape == "cross":
        w = scale * 0.35
        for a0 in (0.0, np.pi / 2):
            ang = np.array([a0 + np.arctan2(w, scale),
                            a0 + np.pi - np.arctan2(w, scale),
                            a0 + np.pi + np.arctan2(w, scale),
                            a0 - np.arctan2(w, scale)])
            r = np.hypot(scale, w)
            cv2.fillPoly(img, [pts(ang, [r] * 4)], col)
    return img


def generate_synthetic_imagenet(
    root: str, n_classes: int = 10, n_train_per_class: int = 100,
    n_val_per_class: int = 20, size: int = 96, seed: int = 0,
    jpeg_quality: int = 92,
) -> str:
    """Folder-per-class dataset in the ImageNet layout the pretrain loop
    expects (<root>/{train,val}/<class>/*.jpg; reference layout:
    Dataset/imagenet_dataset/dataset.py:5-80). Classes are shape x color
    pairs; deterministic per-sample seeding."""
    import cv2

    combos = [(s, cn, cv) for s in _IN_SHAPES for cn, cv in _IN_COLORS]
    assert n_classes <= len(combos)
    for split, n_per, off in (("train", n_train_per_class, 0),
                              ("val", n_val_per_class, 10**6)):
        for ci in range(n_classes):
            shape, cname, cval = combos[ci]
            cdir = os.path.join(root, split, f"class{ci:02d}_{shape}_{cname}")
            os.makedirs(cdir, exist_ok=True)
            for i in range(n_per):
                rng = np.random.default_rng(
                    seed * 2**40 + off + ci * 2**20 + i
                )
                img = _render_imagenet_sample(rng, size, shape, cval)
                cv2.imwrite(
                    os.path.join(cdir, f"img_{i:05d}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality],
                )
    return root


def ensure_synthetic_imagenet(
    path: str | None = None, seed: int = 0, n_classes: int = 10,
    n_train_per_class: int = 100, n_val_per_class: int = 20, size: int = 96,
) -> str:
    root = path or "./data_synth_imagenet"
    marker = os.path.join(root, ".synthetic_imagenet_meta.json")
    meta = {"seed": seed, "n_classes": n_classes,
            "n_train_per_class": n_train_per_class,
            "n_val_per_class": n_val_per_class, "size": size, "rev": 1}
    if os.path.exists(marker):
        with open(marker) as f:
            if json.load(f) == meta:
                return root
    generate_synthetic_imagenet(
        root, n_classes=n_classes, n_train_per_class=n_train_per_class,
        n_val_per_class=n_val_per_class, size=size, seed=seed,
    )
    with open(marker, "w") as f:
        json.dump(meta, f)
    return root
