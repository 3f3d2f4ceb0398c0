"""Command-line tools of the PyTorch port: `python -m hyperpose_torch.tools.eval`
and `python -m hyperpose_torch.tools.official_test`."""
