"""Dataset framework: records, base dataset interface, enum dispatch.

Replaces the reference's Dataset package (reference:
hyperpose/Dataset/__init__.py:11-91 get_dataset dispatch,
base_dataset.py:67-287 Base_dataset train/eval/test list assembly). Instead
of a tf.data generator of pickled dicts, datasets produce plain record
objects, which eval.evaluate reads into device batches. A copy of
`hyperpose_tpu/data/base.py` with the same names and behaviour.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Sequence

import numpy as np

logger = logging.getLogger("hyperpose_torch.DATA")


@dataclasses.dataclass
class TrainRecord:
    """One annotated training image.

    kpts [M, P, 2] float32 in original-image pixels (MISSING where absent),
    valid [M, P] bool. mask_fn, when set, lazily returns a [H, W] float
    don't-care mask at original resolution (crowd regions = 0; reference:
    mscoco_dataset/format.py:26-144 masking policy). bbxs [M, 4] optional
    (x0, y0, w, h) person boxes; derived from keypoint extent when absent.
    """

    image_path: str
    kpts: np.ndarray
    valid: np.ndarray
    mask_fn: Callable[[], np.ndarray] | None = None
    bbxs: np.ndarray | None = None


@dataclasses.dataclass
class EvalRecord:
    """One evaluation/test image (reference: base_dataset.py:182-269)."""

    image_path: str
    image_id: int


class BasePoseDataset:
    """Interface every dataset implements (reference: base_dataset.py:67-287:
    get_train_dataset / get_eval_dataset / get_test_dataset / official_eval)."""

    def get_train_records(self) -> list[TrainRecord]:
        raise NotImplementedError

    def get_eval_records(self) -> list[EvalRecord]:
        raise NotImplementedError

    def get_test_records(self) -> list[EvalRecord]:
        raise NotImplementedError

    def official_eval(
        self, pd_annotations: list[dict], eval_dir: str
    ) -> dict[str, float]:
        raise NotImplementedError

    def output_converter(self, kpts_xy: np.ndarray) -> list[float]:
        """Model-native keypoint array [P, 2] (missing < 0) -> the dataset's
        official submission keypoint list."""
        raise NotImplementedError


def derive_bbxs(kpts: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per-person (x0, y0, w, h) from valid keypoint extent."""
    m = kpts.shape[0]
    bbxs = np.zeros((m, 4), np.float32)
    for i in range(m):
        pts = kpts[i][valid[i]]
        if len(pts) == 0:
            continue
        x0, y0 = pts.min(axis=0)
        x1, y1 = pts.max(axis=0)
        bbxs[i] = (x0, y0, max(x1 - x0, 1.0), max(y1 - y0, 1.0))
    return bbxs


def get_dataset(config):
    """Enum-dispatched dataset construction
    (reference: Dataset/__init__.py:11-91), including user-added data mixing
    (useradd_flag) and the MULTIPLE concatenation type."""
    from ..config import DATA

    d = config.data
    dtype = d.dataset_type

    if dtype == DATA.USERDEF:
        dataset = d.userdef_dataset
        if dataset is None:
            raise ValueError(
                "DATA.USERDEF requires Config.set_userdef_dataset(...)"
            )
        if not isinstance(dataset, BasePoseDataset):
            from .multi import UserPoseDataset

            dataset = UserPoseDataset(dataset)
        base = dataset
    elif dtype == DATA.MULTIPLE:
        from .multi import MultiPoseDataset

        parts = d.userdef_dataset
        if not parts:
            raise ValueError(
                "DATA.MULTIPLE requires a list of datasets via "
                "Config.set_userdef_dataset([...])"
            )
        return MultiPoseDataset(config, list(parts))
    elif dtype == DATA.MPII:
        from .mpii import MpiiPoseDataset

        base = MpiiPoseDataset(config)
    else:
        from .mscoco import CocoPoseDataset

        base = CocoPoseDataset(config)

    if d.useradd_flag and d.useradd_train_img_paths:
        from .multi import MultiPoseDataset, UserPoseDataset

        extra = UserPoseDataset(list(zip(
            d.useradd_train_img_paths,
            *_split_targets(d.useradd_train_targets),
        )))
        # official_flag=False drops the official train split and trains on
        # the user-added data alone (reference: base_dataset.py:67-180
        # assembles train list from official_flag + useradd_flag).
        if not d.official_flag:
            return extra
        return MultiPoseDataset(
            config, [base, extra], scale_rates=[1, d.useradd_scale_rate]
        )
    return base


def _split_targets(targets: Sequence) -> tuple[list, list]:
    """useradd targets may be (kpts, valid) tuples or dicts with kpt/valid
    keys (reference: base_dataset.py user-added target pickles)."""
    kpts, valids = [], []
    for t in targets:
        if isinstance(t, dict):
            kpts.append(np.asarray(t["kpt"], np.float32))
            valids.append(np.asarray(
                t.get("valid", np.ones(kpts[-1].shape[:2], bool))
            ))
        else:
            kpts.append(np.asarray(t[0], np.float32))
            valids.append(np.asarray(t[1], bool))
    return kpts, valids
