"""Datasets, augmentation, the training input pipeline and the target
generators of the PyTorch port (reference: Dataset/__init__.py:11-91,
Model/*/utils.py target generators). A copy of `hyperpose_tpu/data/`'s
numpy half; `targets` is its port to torch, run on the device.
"""
from .augment import MISSING, AugmentResult, BasicAugmentor
from .base import BasePoseDataset, EvalRecord, TrainRecord, get_dataset
from .pipeline import TrainPipeline

__all__ = [
    "MISSING", "AugmentResult", "BasicAugmentor", "BasePoseDataset",
    "EvalRecord", "TrainRecord", "get_dataset", "TrainPipeline",
]
