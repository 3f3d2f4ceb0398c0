"""The decoder's peak kernel's share of its roofline bound, offline serving."""
from posebench import readers


def read(summary):
    return readers.peak_topk_roofline(summary)
