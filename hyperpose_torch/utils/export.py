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

  * a frozen TensorFlow GraphDef `.pb` (`export_pb`) and a `.tflite`
    flatbuffer, float or fully uint8-quantized (`export_tflite`), with the
    JAX package's signatures (`hyperpose_tpu/utils/export.py:62, 95`),
    for foreign runtimes. The float32 forward is lowered to TensorFlow ops
    from the port's own graph (`tf_lower.py`: `torch.export`, then one TF
    op per ATen op, the weights as constants), so the artifacts hold plain
    TF ops, never a kernel of this package, and no ONNX is involved.
    TensorFlow is a host tool here: these two import it when called, and
    the GPU machine has none.
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


def import_tensorflow():
    """`tensorflow`, or an ImportError that says where it is missing."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "export_pb / export_tflite need tensorflow, which this machine does not "
            "have (the GPU machine has none): they are host tools, run them where "
            "tensorflow is installed (`--device cpu`)") from e
    return tf


def export_pb(fn, input_shape, path: str, input_name: str = "input") -> str:
    """Freeze `fn` (a port network, or a callable on NHWC float32 images
    returning a dict of tensors; a float32 copy of a bf16 one) into a
    TensorFlow GraphDef `.pb` (reference: export_pb.py:87-104,
    convert_variables_to_constants_v2 on the forward's concrete function).
    The graph is `tf_lower`'s lowering of the float32 forward at
    `input_shape` (B, H, W, 3): one Placeholder `input_name`, TF ops and
    constants, outputs `Identity`, `Identity_1`, ... for the forward's
    tensor outputs in sorted key order, as the JAX package's `.pb`. Raises
    ImportError, writing nothing, without TensorFlow."""
    tf = import_tensorflow()
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    from .tf_lower import plan_forward, tf_function

    tf_fn = tf_function(plan_forward(fn, tuple(input_shape)), input_name)
    frozen = convert_variables_to_constants_v2(tf_fn.get_concrete_function())
    out_dir = os.path.dirname(path) or "."
    os.makedirs(out_dir, exist_ok=True)
    tf.io.write_graph(graph_or_graph_def=frozen.graph.as_graph_def(), logdir=out_dir,
                      name=os.path.basename(path), as_text=False)
    return path


def export_tflite(fn, example_input, path: str, representative_inputs=None,
                  quantize_uint8: bool = False) -> str:
    """Convert `fn` (as `export_pb` takes it) at the shape of
    `example_input` to a `.tflite` flatbuffer (reference:
    export_tflite.py:29-41). With `quantize_uint8=True` and
    `representative_inputs` (float32 arrays of that shape), full-integer
    quantization with uint8 input and output, the JAX package's settings.
    Raises ImportError, writing nothing, without TensorFlow."""
    tf = import_tensorflow()
    from .tf_lower import plan_forward, tf_function

    if quantize_uint8 and representative_inputs is None:
        raise ValueError("uint8 quantization needs representative_inputs")
    tf_fn = tf_function(plan_forward(fn, tuple(np.shape(example_input))))
    converter = tf.lite.TFLiteConverter.from_concrete_functions(
        [tf_fn.get_concrete_function()], tf_fn)
    if quantize_uint8:
        def rep():
            for arr in representative_inputs:
                yield [np.asarray(arr, np.float32)]

        converter.optimizations = [tf.lite.Optimize.DEFAULT]
        converter.representative_dataset = rep
        converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
        converter.inference_input_type = tf.uint8
        converter.inference_output_type = tf.uint8
    blob = converter.convert()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return path
