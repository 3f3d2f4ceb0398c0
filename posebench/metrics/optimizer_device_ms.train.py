"""Device wall of Adam's update (span `trainer/optimizer`), mean per step.

Read from the traced run's `metrics` slice: the window profiles it and then
the `host` slice (`posebench/trace.py`), and the port keeps the spans of each
profiler session as a period, so it is the second-to-last period holding the
span. None where the program has no span system, or no device wall."""

NAME, WALL = "trainer/optimizer", "device"


def read(summary):
    from hyperpose_torch.utils import tracing

    if not hasattr(tracing, "periods"):
        return None
    slices = [p["period"] for p in tracing.periods() if p["profiler"] and NAME in p["names"]]
    return tracing.mean_ms(NAME, slices[-2], WALL) if len(slices) >= 2 else None
