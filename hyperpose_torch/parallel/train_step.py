"""The Sync_sgd step across ranks.

A port of `hyperpose_tpu/parallel/train_step.py` (reference:
Model/train.py:454-473,512-559, KungFu's Sync_sgd). JAX jits one step over a
batch sharded on "dp" with the parameters replicated: flax's `jnp.mean` over
that batch is the global batch's mean (XLA inserts the all-reduce), so the
BatchNorm statistics and their gradients are those of the whole batch, and
XLA all-reduces the gradients before optax sees them. The step equals the
one-device step on the global batch.

Here each rank steps on its own rows (`mesh.local_rows`): its train-mode
BatchNorms take their statistics over every rank (the trainer runs its
forward under `models.backbones.cross_rank_batchnorm`, whose collectives
carry the gradients across the ranks too), then one
all-reduce (mean) of the gradients in flattened buckets and one of the
metrics. The losses divide by the local batch, so with equal shards the
mean of the ranks' gradients is the global batch's: clipping and
MultiSteps see the global gradient, as optax does. Not
`DistributedDataParallel`, whose plain BatchNorm normalises each rank by
its own shard: that is another step.
"""
from __future__ import annotations

from ..utils import tracing
from .mesh import all_reduce_mean_, mean_metrics


def sync_sgd_loss_and_grads(trainer, batch: dict):
    """`trainer.loss_and_grads` of this rank's rows (BatchNorm over
    `trainer.group`), its gradients and metrics averaged over the ranks:
    (metrics, grads) of the global batch. With no group, the trainer's
    own. Row-sharded (spatial parallelism), a rank's gradient is its image
    rows' share of its dp shard's, so the gradients are summed over "sp"
    and averaged over "dp": the all-reduced sum over the world / dp."""
    metrics, grads = trainer.loss_and_grads(batch)
    all_reduce_mean_(grads, trainer.group, trainer.dp)
    return mean_metrics(metrics, trainer.group), grads


def sync_sgd_step(trainer, batch: dict) -> dict:
    """One Sync_sgd step of `trainer` on this rank's rows of the global
    batch; returns the global batch's metrics. The update is the device
    span `trainer/optimizer` (`utils/tracing.py`)."""
    metrics, grads = sync_sgd_loss_and_grads(trainer, batch)
    with trainer._precision(), tracing.span("trainer/optimizer", device=trainer.device):
        trainer.optimizer.step(grads)
    return metrics
