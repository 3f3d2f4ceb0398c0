"""Weight inspection utilities (reference: hyperpose/Model/examine.py:4-32).

A port of `hyperpose_tpu/utils/examine.py` on a model's flat flax names
(`utils/weights.py` `state_dict_to_flax`): `params/<path>/kernel`, ...,
`batch_stats/<path>/mean|var`, the names the JAX package prints for the same
network and the keys of the npz files both packages write.
"""
from __future__ import annotations

import numpy as np
from torch import nn

from .weights import state_dict_to_flax


def _flat(variables) -> dict:
    """{flax name: array} of a model, or of a flat or nested dict of
    arrays."""
    from .weights import read_flax_weights

    if isinstance(variables, nn.Module):
        return state_dict_to_flax(variables.state_dict())
    return read_flax_weights(variables)


def exam_model_weights(variables, logger=print) -> list[tuple[str, tuple]]:
    """Print/return (name, shape) for every weight of a model (or a dict of
    arrays), in the sorted name order of a flax variables tree."""
    rows = [(name, tuple(np.shape(v))) for name, v in sorted(_flat(variables).items())]
    for name, shape in rows:
        logger(f"{name}: {shape}")
    return rows


def exam_npz_dict_weights(path: str, logger=print) -> list[tuple[str, tuple]]:
    with np.load(path) as data:
        rows = [(k, tuple(data[k].shape)) for k in sorted(data.files)]
    for name, shape in rows:
        logger(f"{name}: {shape}")
    return rows


def compare_weights(variables, npz_path: str) -> dict[str, str]:
    """Diff a model's weights (or a dict of arrays) against an npz dump;
    returns mismatches."""
    problems = {}
    with np.load(npz_path) as data:
        names = set(data.files)
        for name, shape in exam_model_weights(variables, logger=lambda *_: None):
            if name not in names:
                problems[name] = "missing in npz"
            elif tuple(data[name].shape) != shape:
                problems[name] = f"shape {tuple(data[name].shape)} != {shape}"
            names.discard(name)
    for extra in names:
        problems[extra] = "unused npz entry"
    return problems
