"""Human / skeleton result types.

The decoders return fixed-shape arrays; this module provides the `Human`
object API on top of them, mirroring the reference's result types
(reference: include/hyperpose/utility/human.hpp:14-58,
hyperpose/Model/human.py:3-151) without the dynamic std::vector layout.
A copy of `hyperpose_tpu/utils/human.py`, which cannot be imported without
flax.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from .topology import Topology


@dataclasses.dataclass
class BodyPart:
    """One detected keypoint: normalized (x, y) in [0, 1] plus confidence."""

    part_idx: int
    x: float
    y: float
    score: float


@dataclasses.dataclass
class Human:
    """One detected person: sparse dict of BodyParts + aggregate score."""

    parts: dict[int, BodyPart]
    score: float = 0.0

    @property
    def n_parts(self) -> int:
        return len(self.parts)

    def get_bbox(self) -> tuple[float, float, float, float]:
        """(min_x, min_y, w, h) in normalized coordinates."""
        xs = [p.x for p in self.parts.values()]
        ys = [p.y for p in self.parts.values()]
        if not xs:
            return 0.0, 0.0, 0.0, 0.0
        return min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)

    def scaled(self, w: float, h: float) -> "Human":
        return Human(
            parts={
                i: BodyPart(p.part_idx, p.x * w, p.y * h, p.score)
                for i, p in self.parts.items()
            },
            score=self.score,
        )

    def unletterboxed(self, ratio_x: float, ratio_y: float) -> "Human":
        """Undo letterbox padding: scale coords back up by the inverse of the
        content ratio (reference: human.hpp:44-58 `resume_ratio`)."""
        return Human(
            parts={
                i: BodyPart(p.part_idx, p.x / ratio_x, p.y / ratio_y, p.score)
                for i, p in self.parts.items()
            },
            score=self.score,
        )


@dataclasses.dataclass
class SkeletonBatch:
    """Fixed-shape decoded results for a batch of images.

    coords: [B, MAX_HUMANS, P, 2] float32 — normalized (x, y) per keypoint.
    part_scores: [B, MAX_HUMANS, P] float32 — per-keypoint confidence.
    part_valid: [B, MAX_HUMANS, P] bool — keypoint present.
    scores: [B, MAX_HUMANS] float32 — aggregate person score.
    valid: [B, MAX_HUMANS] bool — person slot populated.
    """

    coords: np.ndarray
    part_scores: np.ndarray
    part_valid: np.ndarray
    scores: np.ndarray
    valid: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.coords.shape[0])

    def __getitem__(self, b: int) -> list[Human]:
        return self.to_humans(b)

    def __iter__(self) -> Iterator[list[Human]]:
        for b in range(self.batch_size):
            yield self.to_humans(b)

    def to_humans(self, b: int) -> list[Human]:
        humans = []
        coords = np.asarray(self.coords[b])
        pscores = np.asarray(self.part_scores[b])
        pvalid = np.asarray(self.part_valid[b])
        scores = np.asarray(self.scores[b])
        valid = np.asarray(self.valid[b])
        for h in range(coords.shape[0]):
            if not valid[h]:
                continue
            parts = {}
            for p in range(coords.shape[1]):
                if pvalid[h, p]:
                    parts[p] = BodyPart(
                        p, float(coords[h, p, 0]), float(coords[h, p, 1]),
                        float(pscores[h, p]),
                    )
            humans.append(Human(parts=parts, score=float(scores[h])))
        return humans


def draw_humans(
    image: np.ndarray,
    humans: Sequence[Human],
    topology: Topology,
    thickness: int = 3,
    alpha: float = 1.0,
    bgr: bool = False,
) -> np.ndarray:
    """Draw skeletons on an HWC uint8 image (reference: src/human.cpp:7-39).

    Coordinates in `humans` are normalized to [0, 1]. `alpha` blends the
    skeleton overlay into the original frame (reference: cli.cpp --alpha).
    `bgr=True` draws onto a BGR (cv2-native) frame with the palette
    reversed, so streaming paths never need a full-frame cvtColor.
    """
    import cv2

    out = np.ascontiguousarray(image.copy())
    h, w = out.shape[:2]
    colors = topology.colors
    if bgr:
        colors = [tuple(reversed(tuple(c))) for c in colors]
    for human in humans:
        centers = {}
        for i, part in human.parts.items():
            center = (int(part.x * w + 0.5), int(part.y * h + 0.5))
            centers[i] = center
            color = tuple(int(c) for c in colors[i % len(colors)])
            cv2.circle(out, center, thickness, color, thickness=-1)
        for l, (a, b) in enumerate(topology.limbs):
            if int(a) in centers and int(b) in centers:
                color = tuple(int(c) for c in colors[l % len(colors)])
                cv2.line(out, centers[int(a)], centers[int(b)], color, thickness - 1)
    if alpha < 1.0:
        out = cv2.addWeighted(out, alpha, image, 1.0 - alpha, 0.0)
    return out
