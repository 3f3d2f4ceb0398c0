"""User-defined and concatenated datasets.

(reference: hyperpose/Dataset/multi_dataset.py:6-88 Multi_dataset and the
userdef/useradd paths of Dataset/__init__.py:11-91.)
"""
from __future__ import annotations

import numpy as np

from .base import BasePoseDataset, EvalRecord, TrainRecord


class UserPoseDataset(BasePoseDataset):
    """Wraps plain (image_path, kpts [M, P, 2], valid [M, P]) samples, or
    ready TrainRecords, as a dataset (reference: userdef dataset support,
    Dataset/__init__.py:60-75)."""

    def __init__(self, samples, eval_records: list[EvalRecord] | None = None):
        self._records: list[TrainRecord] = []
        for s in samples:
            if isinstance(s, TrainRecord):
                self._records.append(s)
            else:
                path, kpts, valid = s[0], s[1], s[2]
                self._records.append(TrainRecord(
                    path, np.asarray(kpts, np.float32), np.asarray(valid, bool)
                ))
        self._eval_records = eval_records or []

    def get_train_records(self) -> list[TrainRecord]:
        return list(self._records)

    def get_eval_records(self) -> list[EvalRecord]:
        return list(self._eval_records)

    def get_test_records(self) -> list[EvalRecord]:
        return list(self._eval_records)

    def official_eval(self, pd_annotations, eval_dir):
        raise NotImplementedError(
            "user-defined datasets carry no official metric"
        )

    def output_converter(self, kpts_xy: np.ndarray) -> list[float]:
        out = []
        for x, y in np.asarray(kpts_xy, np.float32):
            visible = x > -100.0 and y > -100.0
            out += [float(x), float(y), 1.0 if visible else 0.0]
        return out


class MultiPoseDataset(BasePoseDataset):
    """Concatenation of datasets with integer oversampling rates
    (reference: multi_dataset.py:6-88 — train lists are concatenated,
    eval/official metrics delegate to the first (primary) dataset)."""

    def __init__(
        self, config, datasets: list[BasePoseDataset],
        scale_rates: list[int] | None = None,
    ):
        if not datasets:
            raise ValueError("MultiPoseDataset needs at least one dataset")
        self.config = config
        self.datasets = datasets
        self.scale_rates = list(scale_rates or [1] * len(datasets))
        if len(self.scale_rates) != len(datasets):
            raise ValueError("scale_rates must match datasets")

    def get_train_records(self) -> list[TrainRecord]:
        records: list[TrainRecord] = []
        for ds, rate in zip(self.datasets, self.scale_rates):
            rs = ds.get_train_records()
            for _ in range(int(rate)):
                records.extend(rs)
        return records

    def get_eval_records(self) -> list[EvalRecord]:
        return self.datasets[0].get_eval_records()

    def get_test_records(self) -> list[EvalRecord]:
        return self.datasets[0].get_test_records()

    def official_eval(self, pd_annotations, eval_dir):
        return self.datasets[0].official_eval(pd_annotations, eval_dir)

    def output_converter(self, kpts_xy: np.ndarray) -> list[float]:
        return self.datasets[0].output_converter(kpts_xy)
