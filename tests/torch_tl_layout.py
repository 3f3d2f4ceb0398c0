"""Weights written in the reference TensorLayer npz_dict layout, with the
port's importer machinery: a JAX-free copy of tests/test_tl_roundtrip.py
`retarget_entries` (which `chip_smoke.py` and the port's tests use; the
port's test holds the two equal)."""
from __future__ import annotations

import numpy as np

from hyperpose_torch.utils.weights_import import (
    Entry, _tl_kind, group_flax_layers, group_tl_layers,
)


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr)
    return tree


def tl_layout(entries, flat: dict, order_key) -> list[tuple[str, np.ndarray]]:
    """Fixture TL entries (reference names, build order and layouts,
    tests/tl_fixtures.py) rewritten to carry the flat flax weights `flat`:
    the inverse of the structural importer, layer for layer. A conv bias
    with no flax counterpart (folded into the next BatchNorm's mean on
    import) is written as zeros, so the round trip is exact."""
    variables = _nest(flat)
    ents = [Entry(name, _tl_kind(name), np.asarray(arr)) for name, arr in entries]
    tl_seq = group_tl_layers(ents)
    flax_layers = sorted(group_flax_layers(variables).values(),
                         key=lambda fl: order_key(fl.path))
    if len(tl_seq) != len(flax_layers):
        raise ValueError(f"{len(tl_seq)} TL layers vs {len(flax_layers)} flax layers")

    def leaf(coll, keypath):
        node = variables[coll]
        for k in keypath:
            node = node[k]
        return np.asarray(node, np.float32)

    values: dict[str, dict] = {}
    for tl, fl in zip(tl_seq, flax_layers):
        arrays = {}
        for kind, tl_arr in tl.arrays.items():
            if kind == "bias" and "bias" not in fl.params:
                arrays[kind] = np.zeros_like(tl_arr)
                continue
            coll, keypath, _ = fl.params[kind]
            arrays[kind] = leaf(coll, keypath).reshape(tl_arr.shape)
        values[tl.name] = arrays
    return [(name, values[name.rsplit(":", 1)[0].rsplit("/", 1)[0]][_tl_kind(name)]
             .astype(np.float32)) for name, _ in entries]
