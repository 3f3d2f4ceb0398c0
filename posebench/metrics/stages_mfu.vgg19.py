"""The stage convs' share of their roofline, the bf16 peak (their arithmetic intensity is high):
the batch's stage conv operations (`reference/openpose_vgg19_ops.py`) over the mean device wall of
span `openpose/stages` in the traced run's `metrics` slice. None where the program has no such
span, or no device wall."""
from posebench.reference import counting, openpose_vgg19_ops

NAME = "openpose/stages"


def read(summary):
    from hyperpose_torch.utils import tracing

    if not hasattr(tracing, "periods"):
        return None
    slices = [p["period"] for p in tracing.periods() if p["profiler"] and NAME in p["names"]]
    wall_ms = tracing.mean_ms(NAME, slices[-2], "device") if len(slices) >= 2 else None
    if not wall_ms:
        return None
    ops = summary["batch"] * openpose_vgg19_ops.stage_operations(*summary["input_hw"])
    return 100.0 * ops / (wall_ms * 1e-3 * counting.H100_BF16_OPS_PER_S)
