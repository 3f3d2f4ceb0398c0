"""Evaluation of the PyTorch port: the COCO and MPII scorers and the
`Evaluator` that runs a model and its decoder over a dataset."""
