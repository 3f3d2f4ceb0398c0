"""Training of the PyTorch port: the `Trainer` (one device, or every rank
of a `torch.distributed` group in Sync_sgd, Sync_avg or Pair_avg) with its
optax-equivalent optimizers, checkpoints in the JAX package's flat npz
layout, flax's initialization, domain adaptation and ImageNet pretraining
of the backbones (a port of `hyperpose_tpu/train/`)."""
