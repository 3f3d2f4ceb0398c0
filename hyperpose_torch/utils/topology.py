"""Keypoint topology tables for all supported model families.

Semantics mirror the reference framework's topology definitions
(reference: hyperpose/Model/openpose/define.py:1-145, src/coco.hpp:10-52,
hyperpose/Model/pose_proposal/define.py, hyperpose/Model/pifpaf/define.py),
re-expressed as immutable numpy tables. A copy of
`hyperpose_tpu/utils/topology.py`: importing that package pulls in flax.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np


class CocoPart(IntEnum):
    """18-part COCO topology + background (reference: openpose/define.py:4-24)."""

    Nose = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    REye = 14
    LEye = 15
    REar = 16
    LEar = 17
    Background = 18


# 19 limbs in training/channel order: limb i reads PAF channels (2i, 2i+1)
# (reference: openpose/define.py:26-27)
COCO_LIMBS = np.array(
    [
        (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13),
        (1, 2), (2, 3), (3, 4), (2, 16), (1, 5), (5, 6), (6, 7),
        (5, 17), (1, 0), (0, 14), (0, 15), (14, 16), (15, 17),
    ],
    dtype=np.int32,
)

# Greedy-assembly processing order used by the native decoder
# (reference: src/coco.hpp:31-52 COCOPAIRS; the last two pairs are "virtual":
# they may extend/merge existing skeletons but never seed a new one,
# src/coco.hpp:6, src/paf.cpp:213).
COCO_ASSEMBLY_ORDER = np.array(
    [6, 10, 7, 8, 11, 12, 0, 1, 2, 3, 4, 5, 14, 15, 17, 16, 18, 9, 13],
    dtype=np.int32,
)
# Limb indices (into COCO_LIMBS) that are virtual for assembly.
COCO_VIRTUAL_LIMBS = np.array([9, 13], dtype=np.int32)

COCO_COLORS = np.array(
    [
        [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
        [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
        [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
        [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
        [255, 0, 170], [255, 0, 85],
    ],
    dtype=np.uint8,
)


class MpiiPart(IntEnum):
    """15-part MPII topology + background (reference: openpose/define.py:86-101)."""

    Headtop = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    Center = 14
    Background = 15


MPII_LIMBS = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7),
        (1, 14), (14, 8), (8, 9), (9, 10), (14, 11), (11, 12), (12, 13),
    ],
    dtype=np.int32,
)


class PpnCocoPart(IntEnum):
    """18-part PoseProposal topology: the OpenPose part order with the
    whole-person Instance anchor in the Neck slot
    (reference: pose_proposal/define.py:4-22)."""

    Nose = 0
    Instance = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    REye = 14
    LEye = 15
    REar = 16
    LEar = 17


# 17 limbs forming a tree rooted at Instance; each limb's source part is
# assigned before it appears as a destination, so one ordered pass propagates
# person ids (reference: pose_proposal/define.py:24-25).
PPN_LIMBS = np.array(
    [
        (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 2),
        (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 0), (0, 14), (0, 15),
        (14, 16), (15, 17),
    ],
    dtype=np.int32,
)


class PifPafPart(IntEnum):
    """17-part standard COCO keypoint topology (reference: pifpaf/define.py)."""

    Nose = 0
    LEye = 1
    REye = 2
    LEar = 3
    REar = 4
    LShoulder = 5
    RShoulder = 6
    LElbow = 7
    RElbow = 8
    LWrist = 9
    RWrist = 10
    LHip = 11
    RHip = 12
    LKnee = 13
    RKnee = 14
    LAnkle = 15
    RAnkle = 16


# 19 skeleton bones, 0-indexed (reference: pifpaf/define.py COCO_PERSON_SKELETON;
# also src/pifpaf_decoder/openpifpaf_postprocessor.hpp:64-84).
PIFPAF_BONES = np.array(
    [
        (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
        (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
        (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6),
    ],
    dtype=np.int32,
)

# Per-keypoint OKS sigmas (reference: pifpaf/define.py COCO_SIGMA; also the
# standard COCO keypoint evaluation constants).
COCO_SIGMAS = np.array(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
    # float64: OKS evaluation must reproduce cocoapi bit-for-bit; f32
    # consumers (target generation) downcast at the point of use.
    dtype=np.float64,
)


def _mirror_flip_list(part_enum, swaps) -> np.ndarray:
    n = len(part_enum)
    flip = np.arange(n, dtype=np.int32)
    for a, b in swaps:
        flip[a], flip[b] = b, a
    return flip


# Horizontal-flip permutations (reference: openpose/define.py:34-81,112-145).
COCO_FLIP_LIST = _mirror_flip_list(
    CocoPart,
    [
        (CocoPart.REye, CocoPart.LEye), (CocoPart.REar, CocoPart.LEar),
        (CocoPart.RShoulder, CocoPart.LShoulder),
        (CocoPart.RElbow, CocoPart.LElbow), (CocoPart.RWrist, CocoPart.LWrist),
        (CocoPart.RHip, CocoPart.LHip), (CocoPart.RKnee, CocoPart.LKnee),
        (CocoPart.RAnkle, CocoPart.LAnkle),
    ],
)

MPII_FLIP_LIST = _mirror_flip_list(
    MpiiPart,
    [
        (MpiiPart.RShoulder, MpiiPart.LShoulder),
        (MpiiPart.RElbow, MpiiPart.LElbow), (MpiiPart.RWrist, MpiiPart.LWrist),
        (MpiiPart.RHip, MpiiPart.LHip), (MpiiPart.RKnee, MpiiPart.LKnee),
        (MpiiPart.RAnkle, MpiiPart.LAnkle),
    ],
)

PIFPAF_FLIP_LIST = _mirror_flip_list(
    PifPafPart,
    [
        (PifPafPart.LEye, PifPafPart.REye), (PifPafPart.LEar, PifPafPart.REar),
        (PifPafPart.LShoulder, PifPafPart.RShoulder),
        (PifPafPart.LElbow, PifPafPart.RElbow),
        (PifPafPart.LWrist, PifPafPart.RWrist),
        (PifPafPart.LHip, PifPafPart.RHip),
        (PifPafPart.LKnee, PifPafPart.RKnee),
        (PifPafPart.LAnkle, PifPafPart.RAnkle),
    ],
)

PPN_FLIP_LIST = _mirror_flip_list(
    PpnCocoPart,
    [
        (PpnCocoPart.LEye, PpnCocoPart.REye),
        (PpnCocoPart.LEar, PpnCocoPart.REar),
        (PpnCocoPart.LShoulder, PpnCocoPart.RShoulder),
        (PpnCocoPart.LElbow, PpnCocoPart.RElbow),
        (PpnCocoPart.LWrist, PpnCocoPart.RWrist),
        (PpnCocoPart.LHip, PpnCocoPart.RHip),
        (PpnCocoPart.LKnee, PpnCocoPart.RKnee),
        (PpnCocoPart.LAnkle, PpnCocoPart.RAnkle),
    ],
)


@dataclasses.dataclass(frozen=True, eq=False)
class Topology:
    # eq=False => identity-based __eq__/__hash__, so a Topology can be a jit
    # static argument (ndarray fields are unhashable by value).
    """An immutable keypoint topology: parts, limb index pairs, draw colors."""

    name: str
    parts: type
    limbs: np.ndarray  # [L, 2] int32 part-index pairs, channel order
    flip_list: np.ndarray  # [P] int32 horizontal-flip permutation
    colors: np.ndarray = dataclasses.field(default_factory=lambda: COCO_COLORS)
    # Order limbs are visited during greedy assembly; defaults to channel order.
    assembly_order: np.ndarray | None = None
    # Limb ids that never seed a new skeleton during assembly.
    virtual_limbs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32)
    )

    @property
    def n_parts(self) -> int:
        # Background channels are not body parts.
        return sum(1 for p in self.parts if p.name != "Background")

    @property
    def n_limbs(self) -> int:
        return int(self.limbs.shape[0])

    def order(self) -> np.ndarray:
        if self.assembly_order is not None:
            return self.assembly_order
        return np.arange(self.n_limbs, dtype=np.int32)


COCO_TOPOLOGY = Topology(
    name="coco_openpose",
    parts=CocoPart,
    limbs=COCO_LIMBS,
    flip_list=COCO_FLIP_LIST,
    assembly_order=COCO_ASSEMBLY_ORDER,
    virtual_limbs=COCO_VIRTUAL_LIMBS,
)

MPII_TOPOLOGY = Topology(
    name="mpii_openpose",
    parts=MpiiPart,
    limbs=MPII_LIMBS,
    flip_list=MPII_FLIP_LIST,
)

PPN_TOPOLOGY = Topology(
    name="coco_ppn",
    parts=PpnCocoPart,
    limbs=PPN_LIMBS,
    flip_list=PPN_FLIP_LIST,
)


class PpnMpiiPart(IntEnum):
    """PoseProposal MPII parts incl. Instance anchor
    (reference: pose_proposal/define.py:82-98)."""

    Headtop = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    Center = 14
    Instance = 15


# reference: pose_proposal/define.py:100-101 MpiiLimb
PPN_MPII_LIMBS = np.array(list(zip(
    [15, 15, 1, 2, 3, 1, 5, 6, 1, 14, 8, 9, 14, 11, 12],
    [0, 1, 2, 3, 4, 5, 6, 7, 14, 8, 9, 10, 11, 12, 13],
)), dtype=np.int32)

PPN_MPII_FLIP_LIST = _mirror_flip_list(
    PpnMpiiPart,
    [
        (PpnMpiiPart.LShoulder, PpnMpiiPart.RShoulder),
        (PpnMpiiPart.LElbow, PpnMpiiPart.RElbow),
        (PpnMpiiPart.LWrist, PpnMpiiPart.RWrist),
        (PpnMpiiPart.LHip, PpnMpiiPart.RHip),
        (PpnMpiiPart.LKnee, PpnMpiiPart.RKnee),
        (PpnMpiiPart.LAnkle, PpnMpiiPart.RAnkle),
    ],
)

PPN_MPII_TOPOLOGY = Topology(
    name="mpii_ppn",
    parts=PpnMpiiPart,
    limbs=PPN_MPII_LIMBS,
    flip_list=PPN_MPII_FLIP_LIST,
)


def instance_part_idx(topology: Topology, default: int = 1) -> int:
    """Row index of the PoseProposal Instance anchor in a topology."""
    for part in topology.parts:
        if part.name == "Instance":
            return int(part.value)
    return default

PIFPAF_TOPOLOGY = Topology(
    name="coco_pifpaf",
    parts=PifPafPart,
    limbs=PIFPAF_BONES,
    flip_list=PIFPAF_FLIP_LIST,
)
