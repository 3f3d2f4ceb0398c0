"""Frames a dispatched step of the stream carries."""
from posebench import readers


def read(summary):
    return readers.batch_fill(summary)
