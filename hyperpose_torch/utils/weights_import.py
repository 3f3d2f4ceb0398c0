"""Ingest reference TensorLayer `npz_dict` checkpoints into the port's models.

A port of `hyperpose_tpu/utils/weights_import.py`: the JAX package's
algorithm, run on the nested flax-name view of the model's state dict
(`utils/weights.py` `state_dict_to_flax`, HWIO kernels, the names the
flax modules carry), with plain dict walks in sorted key order where the
JAX package flattens with `jax.tree_util`; the assigned arrays go back into
the model through `flax_to_state_dict`. An import is then the same
assignment in both packages, value for value.

The reference saves weights as `{<layer_name>/<param_name>:0: array}`
(reference: Model/train.py:319 train_model.save_weights(.., format=
"npz_dict"); names come from the explicit `name=` kwargs in the reference
model definitions, e.g. openpose/model/openpose.py:119-199). Exact layer
names vary across TensorLayer versions, so this importer does NOT rely on
a hand-written name table. Instead it exploits two invariants:

  1. npz_dict preserves the model's build order (zip entry order), and the
     flax-name view flattens in a name order that tracks the architectural
     order within each block family;
  2. a parameter's KIND (conv kernel / bias / BN scale / BN bias / BN
     moving stats / PReLU alpha) is recoverable from its TL param name, and
     its shape must match exactly.

Each kind forms an ordered stream on both sides; every source entry is
greedily assigned to the first unclaimed target of the same kind whose
shape it fits, so uniquely-shaped layers (stems, heads) align regardless of
relative ordering and equally-shaped runs align by order. TF/TL conv
kernels are HWIO, the layout of the flax view, so no transposition is
needed; TF depthwise kernels [H, W, C, M] are reshaped to the grouped-conv
[H, W, 1, C*M].

Use `compare_report` first to inspect how a given file lines up.
"""
from __future__ import annotations

import logging
import zipfile
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .weights import flax_to_state_dict, state_dict_to_flax

logger = logging.getLogger("hyperpose_torch.MODEL")

# TL param-name suffix -> kind (reference: tensorlayer layer weight names).
_TL_KINDS = {
    "filters": "kernel", "weights": "kernel", "kernel": "kernel",
    "W": "kernel",
    "biases": "bias", "b": "bias", "bias": "bias",
    "gamma": "bn_scale", "beta": "bn_bias",
    "moving_mean": "mean", "moving_var": "var",
    "moving_variance": "var",
    "alphas": "alpha", "alpha": "alpha",
    # tl.layers.SeparableConv2d (one TL layer: dw + pw + bias; used by the
    # small-openpose stage heads, mbv2_sm_openpose.py:166-170)
    "depthwise_filters": "dw_kernel", "depthwise_kernel": "dw_kernel",
    "pointwise_filters": "pw_kernel", "pointwise_kernel": "pw_kernel",
}


@dataclass
class Entry:
    name: str
    kind: str
    array: np.ndarray


def _tl_kind(key: str) -> str | None:
    base = key.rsplit(":", 1)[0].rsplit("/", 1)[-1]
    return _TL_KINDS.get(base)


def load_npz_dict_entries(path: str) -> list[Entry]:
    """npz entries in file (build) order with kind classification."""
    with zipfile.ZipFile(path) as zf:
        order = [n[:-4] for n in zf.namelist() if n.endswith(".npy")]
    data = np.load(path, allow_pickle=True)
    entries = []
    for key in order:
        arr = np.asarray(data[key])
        if arr.dtype == object:
            arr = np.asarray(arr.item())
        kind = _tl_kind(key)
        if kind is None:
            logger.warning("npz_dict key %s: unknown kind, skipped", key)
            continue
        entries.append(Entry(key, kind, arr))
    return entries


def _flax_kind(path_names: tuple[str, ...], collection: str) -> str | None:
    leaf = path_names[-1]
    if collection == "batch_stats":
        return {"mean": "mean", "var": "var"}.get(leaf)
    if leaf in ("dw_kernel", "pw_kernel"):
        return leaf
    if leaf == "kernel":
        return "kernel"
    if leaf == "scale":
        return "bn_scale"
    if leaf == "alpha":
        return "alpha"
    if leaf == "bias":
        # flax BatchNorm uses 'bias' too; its sibling is 'scale'.
        return "bn_bias" if "bn" in path_names[-2].lower() else "bias"
    return None


def _variables(model: nn.Module) -> dict:
    """The nested flax-name view of `model`'s state dict:
    {"params": {...}, "batch_stats": {...}} of numpy arrays."""
    tree: dict = {}
    for name, arr in state_dict_to_flax(model.state_dict()).items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """(key path, leaf) of a nested dict in sorted key order, the order in
    which `jax.tree_util` flattens a dict."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _target_entries(variables: dict) -> list[tuple[str, tuple, str, tuple]]:
    """[(collection, keypath, kind, shape)] in tree order (layer order)."""
    out = []
    for coll in ("params", "batch_stats"):
        if coll not in variables or not variables[coll]:
            continue
        for names, leaf in _leaves(variables[coll]):
            kind = _flax_kind(names, coll)
            if kind is not None:
                out.append((coll, names, kind, tuple(leaf.shape)))
    return out


def _adapt(arr: np.ndarray, shape: tuple) -> np.ndarray | None:
    """Fit a TL array to a flax param shape (dw-conv reshape, squeeze)."""
    if tuple(arr.shape) == shape:
        return arr
    # TF depthwise [H, W, C, M] -> flax grouped conv [H, W, 1, C*M]
    if (
        arr.ndim == 4 and len(shape) == 4 and shape[2] == 1
        and arr.shape[0] == shape[0] and arr.shape[1] == shape[1]
        and arr.shape[2] * arr.shape[3] == shape[3]
    ):
        return arr.reshape(shape)
    if arr.size == int(np.prod(shape)):
        return arr.reshape(shape)
    return None


def compare_report(model: nn.Module, npz_path: str) -> dict:
    """Dry-run alignment report: per kind, how many source/target entries
    and whether the ordered shapes line up."""
    sources = load_npz_dict_entries(npz_path)
    targets = _target_entries(_variables(model))
    report = {}
    kinds = {e.kind for e in sources} | {t[2] for t in targets}
    for kind in sorted(kinds):
        src = [e for e in sources if e.kind == kind]
        tgt = [t for t in targets if t[2] == kind]
        matched = _greedy_match(src, tgt)
        report[kind] = {
            "source": len(src), "target": len(tgt),
            "matched": len(matched),
            "aligned": len(matched) == len(src) == len(tgt),
        }
    return report


def _greedy_match(src: list[Entry], tgt: list) -> list[tuple[Entry, tuple]]:
    """Assign each source entry (in build order) to the first unclaimed
    shape-compatible target (in tree order)."""
    taken = [False] * len(tgt)
    matched = []
    for e in src:
        for i, t in enumerate(tgt):
            if taken[i]:
                continue
            if _adapt(e.array, t[3]) is not None:
                taken[i] = True
                matched.append((e, t))
                break
    return matched


# ---------------------------------------------------------------------------
# Structural (layer-sequence) import — the exact path for known families
# ---------------------------------------------------------------------------
#
# The kind-stream matcher below aligns each parameter KIND independently,
# which silently mis-rotates equal-shaped runs when flax's alphabetical
# flatten order differs from the TL build order (e.g. the LW cpm stage:
# TL builds init, m0, m1, m2, end; flax flattens end, init, m0, m1, m2 —
# four identical 3x3x128x128 kernels land one slot off). The structural
# importer instead:
#   1. groups TL entries into LAYERS (name prefix) in file (build) order,
#   2. groups flax params into layers and sorts them with a per-family
#      order key transcribing the reference build order,
#   3. walks both sequences in lockstep, requiring type+shape agreement,
#   4. folds TL conv biases into the following BN's moving_mean when the
#      flax conv has no bias (mean' = moving_mean - bias: exact at
#      inference, since BN sees conv(x)+b in TL but conv(x) here),
#   5. fails loudly on any mismatch, listing both sequences at the point
#      of divergence.

_BN_KINDS = {"bn_scale", "bn_bias", "mean", "var"}


@dataclass
class TlLayer:
    name: str
    arrays: dict  # kind -> np.ndarray


@dataclass
class FlaxLayer:
    path: tuple
    ltype: str    # "conv" | "bn" | "prelu" | "dense"
    params: dict  # kind -> (collection, keypath, shape)


def group_tl_layers(entries: list[Entry]) -> list[TlLayer]:
    """Group consecutive npz_dict entries by layer-name prefix."""
    layers: list[TlLayer] = []
    for e in entries:
        prefix = e.name.rsplit(":", 1)[0].rsplit("/", 1)[0]
        if not layers or layers[-1].name != prefix:
            layers.append(TlLayer(prefix, {}))
        layers[-1].arrays[e.kind] = e.array
    return layers


def group_flax_layers(variables: dict) -> dict[tuple, FlaxLayer]:
    by_path: dict[tuple, FlaxLayer] = {}
    for coll, names, kind, shape in _target_entries(variables):
        path = names[:-1]
        layer = by_path.setdefault(path, FlaxLayer(path, "", {}))
        layer.params[kind] = (coll, names, shape)
    for layer in by_path.values():
        kinds = set(layer.params)
        if kinds & _BN_KINDS:
            layer.ltype = "bn"
        elif "alpha" in kinds:
            layer.ltype = "prelu"
        elif "dw_kernel" in kinds:
            layer.ltype = "sepconv"
        elif "kernel" in kinds:
            shape = layer.params["kernel"][2]
            layer.ltype = "dense" if len(shape) == 2 else "conv"
    return by_path


def _tl_layer_type(layer: TlLayer) -> str:
    kinds = set(layer.arrays)
    if kinds & {"bn_scale", "bn_bias", "mean", "var"}:
        return "bn"
    if "alpha" in kinds:
        return "prelu"
    if "dw_kernel" in kinds:
        return "sepconv"
    if "kernel" in kinds:
        return "dense" if layer.arrays["kernel"].ndim == 2 else "conv"
    return "unknown"


def import_tl_checkpoint(
    model: nn.Module, npz_path: str, order_key, strict: bool = True,
) -> nn.Module:
    """Exact structural import of a reference TL npz_dict checkpoint into
    `model`, in place; returns it.

    order_key(path_tuple) -> sortable key transcribing the reference build
    order for this model family (`utils/tl_orders.py` ORDER_KEYS).
    """
    variables = _variables(model)
    tl_seq = group_tl_layers(load_npz_dict_entries(npz_path))
    flax_layers = sorted(
        group_flax_layers(variables).values(),
        key=lambda fl: order_key(fl.path),
    )

    def fail(msg, i):
        ctx = []
        for j in range(max(0, i - 2), min(max(len(tl_seq), len(flax_layers)),
                                          i + 3)):
            src = tl_seq[j].name if j < len(tl_seq) else "<end>"
            tgt = ("/".join(flax_layers[j].path)
                   if j < len(flax_layers) else "<end>")
            ctx.append(f"    [{j}] tl={src}  flax={tgt}")
        raise ValueError(
            f"TL checkpoint import failed at layer {i}: {msg}\n"
            + "\n".join(ctx)
        )

    if len(tl_seq) != len(flax_layers):
        fail(
            f"{len(tl_seq)} TL layers vs {len(flax_layers)} flax layers",
            min(len(tl_seq), len(flax_layers)),
        )

    assignments: dict[tuple, np.ndarray] = {}
    pending_bias: np.ndarray | None = None
    for i, (tl, fl) in enumerate(zip(tl_seq, flax_layers)):
        ttype = _tl_layer_type(tl)
        if ttype != fl.ltype:
            fail(f"type mismatch: tl {tl.name} is {ttype}, flax "
                 f"{'/'.join(fl.path)} is {fl.ltype}", i)
        if fl.ltype in ("conv", "dense"):
            coll, keypath, shape = fl.params["kernel"]
            fitted = _adapt(tl.arrays["kernel"], shape)
            if fitted is None:
                fail(f"kernel shape {tl.arrays['kernel'].shape} does not "
                     f"fit {shape} ({tl.name} -> {'/'.join(fl.path)})", i)
            assignments[(coll,) + keypath] = fitted
            tl_bias = tl.arrays.get("bias")
            if "bias" in fl.params:
                coll, keypath, shape = fl.params["bias"]
                if tl_bias is None:
                    # TL layer built with b_init=None: keep the zero init.
                    logger.info("%s: no TL bias for %s (b_init=None)",
                                npz_path, "/".join(fl.path))
                elif tl_bias.shape != shape:
                    fail(f"bias shape {tl_bias.shape} != {shape}", i)
                else:
                    assignments[(coll,) + keypath] = tl_bias
            elif tl_bias is not None:
                if pending_bias is not None:
                    fail("two consecutive fold-pending conv biases", i)
                pending_bias = tl_bias  # fold into the next BN
        elif fl.ltype == "bn":
            for tl_kind, fl_kind in (("bn_scale", "bn_scale"),
                                     ("bn_bias", "bn_bias"),
                                     ("mean", "mean"), ("var", "var")):
                if fl_kind not in fl.params:
                    continue
                coll, keypath, shape = fl.params[fl_kind]
                arr = tl.arrays.get(tl_kind)
                if arr is None or arr.shape != shape:
                    fail(f"bn param {tl_kind}: "
                         f"{None if arr is None else arr.shape} != {shape}",
                         i)
                if fl_kind == "mean" and pending_bias is not None:
                    arr = arr - pending_bias
                assignments[(coll,) + keypath] = arr
            pending_bias = None
        elif fl.ltype == "sepconv":
            for kind in ("dw_kernel", "pw_kernel", "bias"):
                if kind == "bias" and "bias" not in tl.arrays:
                    continue  # b_init=None: keep zero init
                coll, keypath, shape = fl.params[kind]
                fitted = _adapt(tl.arrays[kind], shape)
                if fitted is None:
                    fail(f"sepconv {kind} shape "
                         f"{tl.arrays[kind].shape} does not fit {shape}", i)
                assignments[(coll,) + keypath] = fitted
        elif fl.ltype == "prelu":
            coll, keypath, shape = fl.params["alpha"]
            arr = tl.arrays.get("alpha")
            if arr is None or arr.reshape(-1).shape != (int(np.prod(shape)),):
                fail(f"prelu alpha mismatch at {tl.name}", i)
            assignments[(coll,) + keypath] = arr.reshape(shape)
    if pending_bias is not None and strict:
        raise ValueError("dangling conv bias with no following BN to fold")

    n_targets = len(_target_entries(variables))
    if strict and len(assignments) != n_targets:
        missing = n_targets - len(assignments)
        raise ValueError(
            f"structural import left {missing}/{n_targets} flax parameters "
            "unassigned"
        )

    _apply_assignments(model, variables, assignments)
    logger.info("structurally imported %d parameters (%d layers) from %s",
                len(assignments), len(tl_seq), npz_path)
    return model


@torch.no_grad()
def _apply_assignments(model: nn.Module, variables: dict, assignments: dict) -> None:
    """Copy each assigned array, cast to its target's dtype, into `model`'s
    state dict through the weight bridge."""
    flat = {}
    for coll in ("params", "batch_stats"):
        for names, leaf in _leaves(variables.get(coll, {})):
            key = (coll,) + names
            if key in assignments:
                flat["/".join(key)] = np.asarray(assignments[key], dtype=leaf.dtype)
    sd = model.state_dict()
    for key, t in flax_to_state_dict(flat).items():
        sd[key].copy_(t)


def import_npz_dict(model: nn.Module, npz_path: str, strict: bool = True) -> nn.Module:
    """Replace every matched parameter of `model`, in place, by the
    reference checkpoint value (order-preserving per-kind merge); returns
    the model.

    strict=True raises if any stream misaligns (count or shape mismatch);
    strict=False imports the aligned prefix of each stream and logs the
    rest (the analog of tl.files.load_and_assign_npz_dict(skip=True),
    reference: Model/train.py:432).
    """
    variables = _variables(model)
    sources = load_npz_dict_entries(npz_path)
    targets = _target_entries(variables)

    by_kind_src: dict[str, list[Entry]] = {}
    for e in sources:
        by_kind_src.setdefault(e.kind, []).append(e)
    by_kind_tgt: dict[str, list] = {}
    for t in targets:
        by_kind_tgt.setdefault(t[2], []).append(t)

    assignments: dict[tuple, np.ndarray] = {}
    problems = []
    for kind, tgt in by_kind_tgt.items():
        src = by_kind_src.get(kind, [])
        if len(src) != len(tgt):
            problems.append(
                f"kind {kind}: {len(src)} source vs {len(tgt)} target entries"
            )
        matched = _greedy_match(src, tgt)
        if len(matched) < min(len(src), len(tgt)):
            problems.append(
                f"kind {kind}: only {len(matched)}/{len(src)} source "
                "entries found a shape-compatible target"
            )
        for e, t in matched:
            assignments[(t[0],) + t[1]] = _adapt(e.array, t[3])
    for kind, src in by_kind_src.items():
        if kind not in by_kind_tgt:
            problems.append(f"kind {kind}: {len(src)} unused source entries")
    if problems:
        msg = "npz_dict import misalignments:\n  " + "\n  ".join(problems)
        if strict:
            raise ValueError(msg)
        logger.warning(msg)

    _apply_assignments(model, variables, assignments)
    logger.warning(
        "imported %d/%d parameters from %s with the HEURISTIC kind-stream "
        "matcher, which can silently mis-rotate runs of equal-shaped layers "
        "(proven in tests/test_tl_import.py::"
        "test_kind_stream_matcher_would_rotate_cpm). Every facade family "
        "has an exact structural order now — prefer "
        "import_tl_checkpoint(model, path, ORDER_KEYS[model_type]).",
        len(assignments), len(targets), npz_path,
    )
    return model
