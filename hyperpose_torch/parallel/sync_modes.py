"""The Sync_avg and Pair_avg modes across ranks.

A port of `hyperpose_tpu/parallel/sync_modes.py` (reference:
Model/train.py:454-456,512-522; Config/define.py:33-36, KungFu's
SynchronousAveragingOptimizer and PairAveragingOptimizer). Each rank runs
its own step on its rows, as the JAX step does per device inside
`shard_map`: BatchNorm on this rank's batch, the family loss alone (the
JAX sync path's `loss_fn` has no L2 term), the optimizer's update on the
local gradients. Then the weights are exchanged:

- Sync_avg: every float parameter is averaged over the ranks (pmean);
- Pair_avg: each rank mixes with one partner, 0.5 * (x + other), the
  pairing alternating with the parity of the step index: (i, i ^ 1) on even
  steps; on odd steps i - 1 for even i and i + 1 for odd i (mod the world
  size). An odd world size has no such pairing and raises.

The new BatchNorm statistics, the optimizer's float state (Adam's moments,
MultiSteps' accumulator; its integer counts are left alone) and the metrics
are then averaged over the ranks (`_pmean_floats`).
"""
from __future__ import annotations

import torch

from .mesh import all_reduce_mean_, exchange, group_size, mean_metrics

MODES = ("sync_avg", "pair_avg")


def pair_partner(rank: int, world: int, step_i: int) -> int:
    """The rank that `rank` mixes with at step `step_i` under Pair_avg."""
    if world % 2:
        raise ValueError(f"Pair_avg needs an even number of ranks, got {world}")
    if step_i % 2 == 0:
        return rank ^ 1
    return (rank + 1) % world if rank % 2 else (rank - 1) % world


def _float_buffers(model) -> list[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


def _optimizer_floats(opt) -> list[torch.Tensor]:
    return list(opt.mu) + list(opt.nu) + list(opt.acc)


@torch.no_grad()
def pair_mix_(tensors, step_i: int, group) -> None:
    """Each tensor replaced by 0.5 * (its own + the partner rank's), one
    exchange of a flattened bucket."""
    if not tensors:
        return
    world, me = group_size(group), torch.distributed.get_rank(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    other = exchange(flat, torch.distributed.get_global_rank(
        group, pair_partner(me, world, step_i)), group)
    flat = 0.5 * (flat + other)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def local_step(trainer, batch: dict, step_i: int, mode: str) -> dict:
    """One Sync_avg / Pair_avg step of `trainer` on this rank's rows, at
    step index `step_i`; returns the metrics averaged over the ranks (the
    family's loss parts and `total_loss`, the loss without L2)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    group = trainer.group
    metrics, grads = trainer.loss_and_grads(batch, l2=False)
    with trainer._precision():
        trainer.optimizer.step(grads)
    params = [p.data for p in trainer.params]
    if mode == "sync_avg":
        all_reduce_mean_(params, group)
    else:
        pair_mix_(params, step_i, group)
    all_reduce_mean_(_optimizer_floats(trainer.optimizer), group)
    all_reduce_mean_(_float_buffers(trainer.model), group)
    return mean_metrics(metrics, group)
