"""Carry weights between the JAX package's flat flax npz and PyTorch.

The JAX package saves weights as one flat npz of "/"-joined flax paths
(`hyperpose_tpu/train/checkpoint.py` save_weights_npz): `params/.../kernel`
(HWIO), `params/.../bias`, BN `params/.../scale|bias` and
`batch_stats/.../mean|var`. The port's modules carry the flax module names,
so a path maps to a `state_dict` key by renaming its last part:

    params/<p>/kernel   -> <p>.weight         (HWIO -> OIHW)
    params/<p>/bias     -> <p>.bias
    params/<p>/scale    -> <p>.weight         (BatchNorm)
    batch_stats/<p>/mean -> <p>.running_mean
    batch_stats/<p>/var  -> <p>.running_var
    params/<p>/w1p, b1p -> <p>.w1p, <p>.b1p  (VggTinyFusedStem's bare
                                               parameters, as they are)
    params/<p>/alpha    -> <p>.alpha          (PRelu, as it is)
    params/<p>/dw_kernel, pw_kernel -> <p>.dw_kernel, <p>.pw_kernel
                                              (SeparableConv's bare kernels,
                                               HWIO -> OIHW)

Both directions are exact, so each package reads the other's weights.
"""
from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_BARE_PARAMS = ("w1p", "b1p", "alpha")
_BARE_KERNELS = ("dw_kernel", "pw_kernel")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def read_flax_weights(src) -> dict[str, np.ndarray]:
    """Flat {"params/...": array} from an npz path or a (nested or flat)
    dict of arrays."""
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as data:
            return {k: data[k] for k in data.files}
    return _flatten(src)


def flax_to_state_dict(src) -> dict[str, torch.Tensor]:
    """Convert flax-layout weights to `state_dict` entries (float32 CPU
    tensors). Raises on a path it cannot map."""
    out = {}
    for name, arr in read_flax_weights(src).items():
        coll, *path, leaf = name.split("/")
        if coll == "params" and leaf in _BARE_PARAMS + _BARE_KERNELS:
            if leaf in _BARE_KERNELS:
                arr = arr.transpose(3, 2, 0, 1)
            out[".".join(path + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        table = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}.get(coll)
        if table is None or leaf not in table or not path:
            raise KeyError(f"unexpected flax weight {name!r}")
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        key = ".".join(path + [table[leaf]])
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_weights(model: nn.Module, src) -> nn.Module:
    """Load flax-layout weights into `model`. Every weight must be consumed
    and every parameter and BN statistic of the model filled: a missing or
    unexpected key, or a shape mismatch, raises."""
    sd = flax_to_state_dict(src)
    own = {
        k: v for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")
    }
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"weights do not match the model: missing {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''}, unexpected {unexpected[:8]}"
            f"{'...' if len(unexpected) > 8 else ''}"
        )
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"{k}: shape {tuple(v.shape)} != model {tuple(own[k].shape)}"
            )
    model.load_state_dict(sd, strict=False)
    return model


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of `flax_to_state_dict`: flat flax-layout numpy arrays."""
    out = {}
    for key, t in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        p = "/".join(path)
        if leaf in _BARE_PARAMS:
            out["/".join(["params", *path, leaf])] = arr
        elif leaf in _BARE_KERNELS:
            out["/".join(["params", *path, leaf])] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 4:
            out[f"params/{p}/kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 1:
            out[f"params/{p}/scale"] = arr
        elif leaf == "bias":
            out[f"params/{p}/bias"] = arr
        elif leaf == "running_mean":
            out[f"batch_stats/{p}/mean"] = arr
        elif leaf == "running_var":
            out[f"batch_stats/{p}/var"] = arr
        else:
            raise KeyError(f"cannot map state_dict entry {key!r} to flax")
    return out


def save_flax_npz(model: nn.Module, path) -> None:
    """Write `model`'s weights as the JAX package's flat npz."""
    np.savez(path, **state_dict_to_flax(model.state_dict()))


def random_flax_weights(shapes, seed: int) -> dict[str, np.ndarray]:
    """Seeded random float32 weights in the flat flax layout, drawn with
    numpy in the order of `shapes` (a mapping of flax key -> shape, or a
    model, whose keys and shapes are taken): kernels (and SeparableConv's
    `dw_kernel` and `pw_kernel`) normal with std sqrt(1 / fan_in), BN scales
    and variances uniform in [0.5, 1.5], PReLU slopes `alpha` uniform in
    [0.05, 0.5] (non-zero, so the negative branch is used), biases and means
    0.1 * normal. Both packages load the result, so it stands in for a
    checkpoint where none is committed."""
    if isinstance(shapes, nn.Module):
        shapes = {k: v.shape for k, v in state_dict_to_flax(shapes.state_dict()).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("kernel",) + _BARE_KERNELS:
            arr = rng.standard_normal(shape) * np.sqrt(1.0 / np.prod(shape[:-1]))
        elif leaf in ("scale", "var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif leaf == "alpha":
            arr = rng.uniform(0.05, 0.5, shape)
        else:
            arr = 0.1 * rng.standard_normal(shape)
        out[name] = arr.astype(np.float32)
    return out
