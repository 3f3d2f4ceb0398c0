"""The training step's share of the bf16 peak: 3 x the forward's conv operations of the images finished, over the slice's wall."""
from posebench import readers


def read(summary):
    return readers.mfu(summary, passes=3)
