"""posebench: the benchmark of the PyTorch port, hyperpose_torch."""
