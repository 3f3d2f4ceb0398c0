"""Command-line tools of the PyTorch port, each the counterpart of a JAX
script with its flags and `--device`: `python -m hyperpose_torch.tools.eval`,
`official_test`, `train`, `pretrain`, `export_model`, `measure_flops` and
`convert_reference_npz`."""
