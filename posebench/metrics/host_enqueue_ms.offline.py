"""Host wall of one infer_batch_device call, which returns without waiting for the device."""
from posebench import readers


def read(summary):
    return readers.host_enqueue_ms(summary)
