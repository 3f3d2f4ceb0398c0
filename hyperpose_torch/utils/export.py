"""Model export for deployment: the counterpart of
`hyperpose_tpu/utils/export.py` (reference: export_pb.py:66-104,
measure_flops.py:13-23):

  * weights as the JAX package's flat .npz (portable between the packages),
  * a serialized step through `torch.export`: the program and its weights in
    one `.pt2` file, the analog of a serialized TensorRT engine
    (src/tensorrt.cpp:463-471) and of the JAX package's jax.export
    StableHLO. The hand-written kernels are in it as the `hyperpose::`
    operators (`ops/kernels/library.py`), so a loaded program launches the
    same kernels as the eager step.

The JAX package's `export_pb` and `export_tflite` (TensorFlow artifacts for
foreign runtimes) have no counterpart here: PyTorch's route to foreign
runtimes is ONNX, which is not installed.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .weights import read_flax_weights, save_flax_npz


def export_npz(variables, path: str) -> str:
    """Write weights as the JAX package's flat npz ("params/.../kernel"
    arrays, float32; its `load_weights_npz` reads it back). `variables` is an
    `nn.Module` (its state dict, through `save_flax_npz`) or flat flax-layout
    weights (a dict of arrays or an npz path)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(variables, nn.Module):
        save_flax_npz(variables, path)
    else:
        np.savez(path, **read_flax_weights(variables))
    return path


def export_serialized(fn_or_module, example_args, path: str) -> str:
    """Trace `fn_or_module` on `example_args` with `torch.export.export`
    (fixed shapes, non-strict, under `torch.no_grad()`) and save the program
    with its weights to `path` (a `.pt2` file). A plain function is wrapped
    in a module first; weights it reaches without a module become constants
    of the program. The program keeps its tensors on the device they were
    on when traced."""
    module = fn_or_module
    if not isinstance(module, nn.Module):
        module = _Fn(fn_or_module)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args), strict=False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def register_kernel_ops() -> None:
    """Import every module that registers a `hyperpose::` operator: a loaded
    program that holds one needs it registered."""
    from ..ops.kernels import conv1_pool, grow, int8_gemm, line_gather, peak_topk  # noqa: F401


def load_serialized(path: str):
    """Load a program saved by `export_serialized`; returns a callable that
    runs it without autograd."""
    register_kernel_ops()
    module = torch.export.load(path).module()

    def run(*args):
        with torch.inference_mode():
            return module(*args)

    run.module = module
    return run


def measure_flops(fn, *example_args) -> dict:
    """Floating-point operations of one call of `fn` on `example_args`,
    counted by `torch.utils.flop_counter.FlopCounterMode` (a multiply-add
    counts 2; convolutions and matmuls only, what XLA's cost analysis also
    counts for them). Returns {"flops", "bytes_accessed"}: "bytes_accessed"
    is NaN because PyTorch has no counterpart of XLA's cost analysis of the
    bytes a compiled program moves (reference: measure_flops.py uses the TF
    profiler)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*example_args)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}
