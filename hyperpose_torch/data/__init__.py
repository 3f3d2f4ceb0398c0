"""Datasets and augmentation of the PyTorch port: the dataset readers the
evaluation path runs (reference: Dataset/__init__.py:11-91). A copy of
`hyperpose_tpu/data/`'s numpy half; the training pipeline and the target
generator wait for the training slice.
"""
from .augment import MISSING, AugmentResult, BasicAugmentor
from .base import BasePoseDataset, EvalRecord, TrainRecord, get_dataset

__all__ = [
    "MISSING", "AugmentResult", "BasicAugmentor", "BasePoseDataset",
    "EvalRecord", "TrainRecord", "get_dataset",
]
