"""Training of the PyTorch port: the single-device `Trainer` with its
optax-equivalent optimizers, checkpoints in the JAX package's flat npz
layout, flax's initialization and domain adaptation (a port of
`hyperpose_tpu/train/`; ImageNet pretraining and the multi-device
Sync_avg / Pair_avg modes are not ported yet)."""
