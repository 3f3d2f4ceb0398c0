"""The kernel wrappers as PyTorch operators, for traced steps.

`torch.export` cannot trace a ctypes call, so each wrapper that a serving
step launches (`limb_scores`, `peak_topk`, `peak_candidates`, `fused_grow`,
`int8_quantize`, `int8_conv`, `int8_dwconv`, `conv1_pool`) is also
registered as an operator `hyperpose::<name>` (`torch.library`), with
a fake implementation that gives the exact output shapes, dtypes and
strides. While a step is traced (`tracing()`), a wrapper calls its operator,
which the exported program then holds; a loaded program calls the operator,
whose implementation is the wrapper's own: the plain version on a CPU
tensor, the kernel on a CUDA tensor, with the same launch count. An eager
call goes to that implementation directly, without the dispatcher's cost.
Importing a wrapper's module registers its operator, which a loaded program
needs (`utils/export.py` `load_serialized` imports them all).
"""
from __future__ import annotations

import functools

import torch

NAMESPACE = "hyperpose"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, impl, fake):
    """Register the operator `hyperpose::<name>(<schema>)`: `impl` runs it on
    every device (a CompositeExplicitAutograd kernel, which tracing keeps as
    one node), `fake` gives its outputs' metadata. Returns the operator.
    This is the low-level registration: a loaded int8 step calls about a
    hundred operators, and `torch.library.custom_op` wraps each call in
    more Python."""
    _LIB.define(name + schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def tracing() -> bool:
    """True while `torch.export` traces a step: the wrappers then call their
    operators."""
    return torch.compiler.is_exporting()


def device_table(fn):
    """`functools.lru_cache` for a function that builds a constant table on
    a device, bypassed while tracing: a table made then is a traced value,
    which must neither be cached nor come from the cache of eager calls."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def table(*args):
        return fn(*args) if tracing() else cached(*args)

    return table
