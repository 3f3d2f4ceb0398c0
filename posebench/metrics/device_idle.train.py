"""Share of the traced slice with no operation on the device, training."""
from posebench import readers


def read(summary):
    return readers.device_idle(summary)
