"""Share of the traced slice with no operation on the device, live cameras."""
from posebench import readers


def read(summary):
    return readers.device_idle(summary)
