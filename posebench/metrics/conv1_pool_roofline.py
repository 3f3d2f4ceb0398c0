"""The fused stem kernel's share of its roofline bound."""
from posebench import readers


def read(summary):
    return readers.conv1_pool_roofline(summary)
