"""The served step's share of the bf16 peak: the useful frames' conv operations over the slice's wall."""
from posebench import readers


def read(summary):
    return readers.mfu(summary)
