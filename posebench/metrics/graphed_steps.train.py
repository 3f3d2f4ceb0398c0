"""Share of the training steps replayed as CUDA graphs (count `graphed` of span `trainer/step`, `Trainer.step`), in %.

Read from the traced run's `metrics` slice: the window profiles it and then
the `host` slice (`posebench/trace.py`), and the port keeps the spans of each
profiler session as a period, so it is the second-to-last period holding the
span. None where the program has no span system, or no step span of the
slice carries the count."""

NAME, COUNT = "trainer/step", "graphed"


def read(summary):
    from hyperpose_torch.utils import tracing

    if not hasattr(tracing, "periods"):
        return None
    slices = [p["period"] for p in tracing.periods() if p["profiler"] and NAME in p["names"]]
    if len(slices) < 2:
        return None
    flags = [s["counts"][COUNT] for s in tracing.spans(slices[-2], NAME) if COUNT in s["counts"]]
    return 100.0 * sum(flags) / len(flags) if flags else None
