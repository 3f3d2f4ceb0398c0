"""Sharded stream inference across ranks.

A port of `hyperpose_tpu/parallel/stream_shard.py`. The reference scales
inference only within one process (pipeline stages + parser replica
threads, reference: stream.hpp:18-89); the JAX package shards frame batches
over a device mesh and all-gathers the fixed-shape skeletons. Here each
rank of a `torch.distributed` group runs its `PoseEngine` step (the fused
forward and decode, with their kernels) on the frames it owns, and the
small fixed-shape `DecodedSkeletons` are all-gathered, so every rank holds
the skeletons of the whole global batch in frame order (the ordering
guarantee of reference stream.hpp:82-87, kept across ranks). Frames are the
only large payload, and each rank feeds only its own.

Where the JAX engine takes (model, variables, decoder_call, mesh), the
port's takes a built `PoseEngine` (model, weights and decoder) and a
process group. With `spatial` sp > 1 the ranks form the dp x sp mesh of
`make_distributed_mesh(spatial)`, as the JAX engine's mesh shards frames on
("dp", "sp"): the sp ranks of a dp shard each run the network on their
rows of its frames with a halo exchange around every conv
(`parallel/spatial.py`), the maps are gathered over "sp", and each of them
decodes the whole maps with the decoder's kernels; the skeletons are then
gathered over "dp".
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.paf_decode import DecodedSkeletons
from ..utils import tracing
from . import spatial as sp_rows
from .mesh import all_gather_rows, dp_sp_mesh, group_size, world_size


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """`all_gather_rows`, with bool fields gathered as uint8."""
    if t.dtype == torch.bool:
        return all_gather_rows(t.to(torch.uint8), group).to(torch.bool)
    return all_gather_rows(t, group)


class ShardedStreamEngine:
    """Data-parallel fused inference over the ranks of `group` (default:
    the whole process group when there is one, else none: one process runs
    every frame). `engine` is this rank's `PoseEngine`, the same weights on
    every rank. With `spatial` > 1 the whole process group forms a dp x sp
    mesh: `group` is then its "dp" group (the ranks of this rank's sp
    index, among which frames are split) and `shard` this rank's rows
    (`parallel/spatial.py`); the engine's input must be rgb8 and its
    `fused_decode`, where it has one, must have a `decode`."""

    def __init__(self, engine, group=None, spatial: int = 1):
        self.engine = engine
        self.shard = None
        if spatial > 1:
            if group is not None:
                raise ValueError("spatial > 1 shards over the whole process group's "
                                 "dp x sp mesh; pass no group")
            if engine.input_format != "rgb8" or (
                    engine.fused_decode is not None
                    and not hasattr(engine.fused_decode, "decode")):
                raise ValueError("a row-sharded step needs rgb8 input and a fused_decode "
                                 "with decode(outputs, image_hw)")
            m = make_distributed_mesh(spatial)
            group = m.get_group("dp")
            self.shard = sp_rows.make_shard(engine.model, engine.input_hw[0],
                                            m.get_group("sp"), engine.dtype, engine.device)
        elif group is None and world_size() > 1:
            group = dist.group.WORLD
        self.group = group

    @property
    def ranks(self) -> int:
        """The ranks among which frames are split ("dp")."""
        return group_size(self.group)

    def _rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def infer_global_batch(self, images_u8) -> DecodedSkeletons:
        """images_u8: [B_global, H, W, 3], the same array on every rank; B
        must be divisible by the ranks. Each rank runs its rows
        [r*B/n, (r+1)*B/n) and returns the skeletons of ALL frames (prefer
        `infer_local_shard`, which never holds frames a rank does not
        own)."""
        b = int(np.shape(images_u8)[0])
        n = self.ranks
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} ranks")
        lo = self._rank() * b // n
        return self.infer_local_shard(images_u8[lo:lo + b // n], global_batch=b)

    def infer_local_shard(self, local_images_u8, global_batch: int | None = None
                          ) -> DecodedSkeletons:
        """Each rank feeds ONLY the frames it owns (equal-size shards,
        ordered by rank: rank r owns global rows [r*B/n, (r+1)*B/n)); the
        skeletons of the ENTIRE global batch come back on every rank, on
        its engine's device. Row-sharded, a rank's frames may hold all the
        image rows or only its own (`shard.rows`)."""
        n = self.ranks
        local_b = int(np.shape(local_images_u8)[0])
        if global_batch is None:
            global_batch = local_b * n
        if global_batch != local_b * n:
            raise ValueError(
                f"global batch {global_batch} != local {local_b} x {n} ranks "
                "(shards must be equal-size)")
        if self.shard is None:
            out = self.engine.infer_batch_device(local_images_u8)
        else:
            out = self._row_step(local_images_u8)
        return DecodedSkeletons(**{f.name: _gather(getattr(out, f.name), self.group)
                                   for f in dataclasses.fields(out)})

    @torch.inference_mode()
    def _row_step(self, images_u8) -> DecodedSkeletons:
        """The engine's step on this rank's rows of its frames: the network
        with its halos, the maps gathered over "sp", the whole maps
        decoded (`PoseEngine.decode_outputs`); spans as `PoseEngine._step`'s."""
        eng, (lo, hi) = self.engine, self.shard.rows
        x = torch.as_tensor(images_u8)
        if x.shape[1] == eng.input_hw[0]:
            x = x[:, lo:hi]
        elif x.shape[1] != hi - lo:
            raise ValueError(f"frames of {x.shape[1]} rows: neither the input's "
                             f"{eng.input_hw[0]} nor this rank's {hi - lo}")
        with tracing.span("engine/step", device=eng.device, frames=int(x.shape[0])):
            with tracing.span("engine/network", device=eng.device):
                x = x.to(eng.device, non_blocking=True).to(eng.dtype) / 255.0
                with sp_rows.row_sharded(self.shard):
                    out = sp_rows.gather_outputs(eng.model(x),
                                                 getattr(eng.model, "output_row_dims", None))
            return eng.decode_outputs(out)


def make_distributed_mesh(spatial: int = 1):
    """The ("dp", "sp") mesh over every rank of the process group
    (`mesh.make_mesh`; reference analog: KungFu cluster bootstrap,
    Model/train.py:454-461), made once a process group (`mesh.dp_sp_mesh`)."""
    return dp_sp_mesh(spatial)


def scaling_report(fps_1chip: float, fps_nchip: float, n: int) -> dict:
    """Scaling-efficiency row: frames/s on n ranks over n x one rank's."""
    return {
        "chips": n,
        "fps_per_chip_1": fps_1chip,
        "fps_total_n": fps_nchip,
        "efficiency": fps_nchip / (fps_1chip * n) if n else 0.0,
    }
