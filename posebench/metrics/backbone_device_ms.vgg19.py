"""Device wall of OpenPose's backbone (span `openpose/backbone`: VGG19's ten convs, cpm1 and cpm2), mean per step.

Read from the traced run's `metrics` slice, the second-to-last profiler
period holding the span (as `network_device_ms.offline`). None where the
program has no such span (no span inside the model), or no device wall."""

NAME, WALL = "openpose/backbone", "device"


def read(summary):
    from hyperpose_torch.utils import tracing

    if not hasattr(tracing, "periods"):
        return None
    slices = [p["period"] for p in tracing.periods() if p["profiler"] and NAME in p["names"]]
    return tracing.mean_ms(NAME, slices[-2], WALL) if len(slices) >= 2 else None
