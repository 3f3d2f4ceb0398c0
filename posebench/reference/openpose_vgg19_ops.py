"""Closed-form conv operations of CMU OpenPose on VGG19 (`openpose_vgg19`),
from its weight shapes: 2 x the multiply-adds of each conv, k^2 x cin x cout
at every output pixel. The stages' count is the yardstick of the stage
convs' share of the bf16 peak (`stages_mfu.vgg19`); the stages' and the
backbone's counts together are the whole network's."""
from __future__ import annotations

from .openpose_vgg19 import _VGG, param_shapes

STRIDE_POOLS = 3    # the stride-8 grid: three 2x2 pools


def _down(n: int, pools: int) -> int:
    """A side after `pools` SAME 2x2 max pools, which round up."""
    for _ in range(pools):
        n = -(-n // 2)
    return n


def _conv_ops(shape: tuple, h: int, w: int) -> int:
    k, _, cin, cout = shape
    return 2 * h * w * k * k * cin * cout


def stage_operations(h: int, w: int) -> int:
    """The initial and refinement stages' convs (every `init_*` and `ref*`
    conv) on one h x w frame, at the stride-8 grid: 339.2 GFLOP at 368x656."""
    hs, ws = _down(h, STRIDE_POOLS), _down(w, STRIDE_POOLS)
    return sum(_conv_ops(shape, hs, ws) for key, shape in param_shapes().items()
               if key.endswith("/kernel") and key.startswith(("params/init_", "params/ref")))


def backbone_operations(h: int, w: int) -> int:
    """VGG19's ten convs, each at its own grid, then `cpm1` and `cpm2` at
    the stride-8 grid, on one h x w frame."""
    shapes = param_shapes()
    ops, b, pools = 0, 0, 0
    for item in _VGG:
        if item == "pool":
            pools += 1
            continue
        for _ in range(item[1]):
            ops += _conv_ops(shapes[f"params/backbone/conv_{b}/kernel"], _down(h, pools),
                             _down(w, pools))
            b += 1
    return ops + sum(_conv_ops(shapes[f"params/{key}/kernel"], _down(h, STRIDE_POOLS),
                               _down(w, STRIDE_POOLS)) for key in ("cpm1", "cpm2"))
