"""Seeded synthetic multi-person scenes, the benchmark's input frames.

A frozen copy of the scene model of `hyperpose_torch/data/synthetic.py`
(`sample_pose`, `_person_colors`, `render_person`, `render_scene`: 2-6
articulated COCO figures on a gradient with blocks and noise), with its
OpenCV drawing calls replaced by a numpy rasterizer, so the frames depend
on neither the port nor OpenCV. Of the annotations only what training needs
is kept: each figure's COCO joints and each crowd's box.
"""
from __future__ import annotations

import numpy as np

NOSE, LEYE, REYE, LEAR, REAR = 0, 1, 2, 3, 4
LSHO, RSHO, LELB, RELB, LWRI, RWRI = 5, 6, 7, 8, 9, 10
LHIP, RHIP, LKNE, RKNE, LANK, RANK = 11, 12, 13, 14, 15, 16
PELVIS, THORAX, UPPERNECK, HEADTOP = 17, 18, 19, 20
N_JOINTS = 21

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
    return np.array([np.sin(theta), np.cos(theta)])


def sample_pose(rng: np.random.Generator) -> np.ndarray:
    """A random articulated skeleton, pelvis at the origin, in units of body
    height, y down: [N_JOINTS, 2]."""
    j = np.zeros((N_JOINTS, 2))
    tilt = rng.uniform(-0.4, 0.4)
    up = -_dir(tilt)
    perp = np.array([up[1], -up[0]])
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
        sh = th + rng.uniform(-0.2, 1.1)
        j[ank] = j[kne] + 0.24 * _dir(sh)
    return j


def _person_colors(rng):
    hue = rng.uniform(0, 1)
    base = np.array([0.5 + 0.5 * np.sin(2 * np.pi * (hue + k / 3.0)) for k in range(3)])
    torso = np.clip(base * 200 + 40, 0, 255).astype(np.uint8)
    limb = np.clip(base * 130 + 90, 0, 255).astype(np.uint8)
    skin = np.array(rng.choice([[236, 188, 160], [198, 134, 94], [141, 85, 56]])).astype(np.uint8)
    return torso, limb, skin


def _paint(img, box, mask, color):
    """Paint `color` where `mask` holds inside the pixel box (y0, y1, x0, x1)."""
    y0, y1, x0, x1 = box
    img[y0:y1, x0:x1][mask] = color


def _box(img, lo, hi):
    h, w = img.shape[:2]
    y0, x0 = max(0, int(np.floor(lo[1]))), max(0, int(np.floor(lo[0])))
    y1, x1 = min(h, int(np.ceil(hi[1])) + 1), min(w, int(np.ceil(hi[0])) + 1)
    if y0 >= y1 or x0 >= x1:
        return None
    yy, xx = np.mgrid[y0:y1, x0:x1]
    return (y0, y1, x0, x1), xx.astype(np.float32), yy.astype(np.float32)


def fill_polygon(img, pts, color):
    """A convex polygon `pts` [N, 2] (x, y), filled."""
    pts = np.asarray(pts, np.float32)
    got = _box(img, pts.min(0), pts.max(0))
    if got is None:
        return
    box, xx, yy = got
    nxt = np.roll(pts, -1, axis=0)
    cross = [(b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0]) for a, b in zip(pts, nxt)]
    inside = np.all([c >= 0 for c in cross], 0) | np.all([c <= 0 for c in cross], 0)
    _paint(img, box, inside, color)


def draw_line(img, a, b, color, thickness):
    """A segment from `a` to `b` (x, y) `thickness` pixels wide, round caps."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    r = thickness / 2.0
    got = _box(img, np.minimum(a, b) - r, np.maximum(a, b) + r)
    if got is None:
        return
    box, xx, yy = got
    d = b - a
    n2 = float(d @ d)
    t = np.zeros_like(xx) if n2 == 0 else np.clip(((xx - a[0]) * d[0] + (yy - a[1]) * d[1]) / n2, 0, 1)
    dist2 = (xx - a[0] - t * d[0]) ** 2 + (yy - a[1] - t * d[1]) ** 2
    _paint(img, box, dist2 <= r * r, color)


def draw_disc(img, c, radius, color):
    c = np.asarray(c, np.float32)
    got = _box(img, c - radius, c + radius)
    if got is None:
        return
    box, xx, yy = got
    _paint(img, box, (xx - c[0]) ** 2 + (yy - c[1]) ** 2 <= radius * radius, color)


def render_person(img, joints_px, scale, rng):
    """One figure, painter's order: torso, limbs, head, then the part-colored
    joint dots."""
    torso_c, limb_c, skin_c = _person_colors(rng)
    thick = max(2, int(0.05 * scale))
    fill_polygon(img, joints_px[[LSHO, RSHO, RHIP, LHIP]], torso_c)
    for a, b in _LIMB_SEGMENTS:
        draw_line(img, joints_px[a], joints_px[b], limb_c, thick)
    draw_disc(img, (joints_px[UPPERNECK] + joints_px[HEADTOP]) / 2, max(2, int(0.075 * scale)), skin_c)
    jrad = max(2, int(0.028 * scale))
    for p in range(17):
        draw_disc(img, joints_px[p], jrad, _PART_COLORS[p])


def render_scene(rng: np.random.Generator, hw, n_people: int, crowd: bool,
                 people: list | None = None, crowds: list | None = None) -> np.ndarray:
    """One scene of `n_people` figures, with a crowd of small unlabelled
    figures where `crowd`, as a uint8 RGB image of size `hw`. With `people`
    (a list), each figure's 17 COCO joints in pixels [17, 2] are appended to
    it, in painter's order; with `crowds`, the crowd's box (x0, y0, w, h)."""
    h, w = hw
    top = rng.integers(0, 120, 3)
    bot = rng.integers(80, 200, 3)
    t = np.linspace(0, 1, h)[:, None, None]
    img = np.broadcast_to((top * (1 - t) + bot * t).astype(np.uint8), (h, w, 3)).copy()
    for _ in range(int(rng.integers(2, 7))):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        x1 = min(w, x0 + int(rng.integers(20, w // 2)))
        y1 = min(h, y0 + int(rng.integers(20, h // 2)))
        img[y0:y1 + 1, x0:x1 + 1] = rng.integers(0, 255, 3).astype(np.uint8)
    scales = np.sort(np.exp(rng.uniform(np.log(0.25 * h), np.log(0.95 * h), n_people)))
    for s in scales:
        local = sample_pose(rng)
        centre = np.array([rng.uniform(-0.1 * w, 1.1 * w), rng.uniform(0.2 * h, 0.9 * h)])
        joints = local * s + centre
        render_person(img, joints, s, rng)
        if people is not None:
            people.append(joints[:17].astype(np.float32))
    if crowd:
        cw, ch = int(rng.uniform(0.25, 0.45) * w), int(rng.uniform(0.2, 0.35) * h)
        cx0, cy0 = int(rng.uniform(0, w - cw)), int(rng.uniform(0, h - ch))
        if crowds is not None:
            crowds.append((cx0, cy0, cw, ch))
        for _ in range(int(rng.integers(6, 13))):
            s = rng.uniform(0.15, 0.3) * ch
            jp = sample_pose(rng) * s + np.array([rng.uniform(cx0 + 10, cx0 + cw - 10),
                                                  rng.uniform(cy0 + 10, cy0 + ch - 10)])
            render_person(img, jp, s, rng)
    noise = rng.normal(0, 6, img.shape).astype(np.float32)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def scene_sizes(rng: np.random.Generator, n: int) -> list[tuple[int, bool]]:
    """(people, crowd) of `n` scenes: 2 to 6 people in turn and a crowd in
    15% of them (the synthetic set's mix), in an order drawn from `rng`, so
    every seed's scenes hold the same people."""
    people = np.resize(np.arange(2, 7), n)
    crowd = np.arange(n) < round(0.15 * n)
    return [(int(p), bool(c)) for p, c in zip(rng.permutation(people), rng.permutation(crowd))]


def scene_pool(seed: int, n: int, hw, stream: int = 0) -> np.ndarray:
    """`n` scenes [n, H, W, 3] uint8 from `seed` (`scene_sizes`); `stream`
    picks an independent sequence from the same seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])
    return np.stack([render_scene(rng, hw, p, c) for p, c in scene_sizes(rng, n)])
