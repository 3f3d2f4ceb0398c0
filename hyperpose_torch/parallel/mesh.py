"""The process group, its device mesh, and the collectives the port runs.

A port of `hyperpose_tpu/parallel/mesh.py` (reference: Model/train.py:327-588
parallel_train, Config/define.py:33-36). JAX lays a `Mesh` over the devices
and XLA inserts the collectives; the port runs one process per rank under
`torch.distributed` (started by `torchrun`) and calls the collectives
itself. What stands in for the JAX module's placements:

- `batch_sharding(mesh)` (the batch split over "dp" and image rows over
  "sp"): each rank takes its rows `[r*B/R, (r+1)*B/R)` of the global batch,
  `local_rows`, and under spatial parallelism (`spatial.py`) each of a dp
  shard's sp ranks its rows of those images;
- `replicated(mesh)` (parameters on every device): every rank holds the
  whole model, drawn from the same seed, and `broadcast_state_` checks it
  equal to rank 0's.

NCCL serves CUDA tensors, one rank a card; gloo serves the CPU, and also
CUDA tensors when several ranks share one card (NCCL refuses two ranks on
one device). gloo reduces and broadcasts CUDA tensors itself; its
all-gather and point-to-point sends take CPU tensors only, so those two
collectives stage a CUDA tensor through a host copy (`_staged`), stated in
their docstrings. Every collective here takes its group explicitly: None
means no group (one process), where it does nothing.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_distributed() else 0


def group_size(group) -> int:
    """Ranks in `group`; 1 for None (no group)."""
    return 1 if group is None else dist.get_world_size(group)


def init_from_env(backend: str | None = None, device: str = "cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that `torchrun` describes in the environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); returns whether there is
    one. On the card each rank takes device LOCAL_RANK modulo the cards
    present. `backend` defaults to gloo for the CPU, and for the card to
    NCCL with a card a local rank, else gloo: NCCL refuses two ranks on one
    device, so the ranks that share a card (LOCAL_WORLD_SIZE, or WORLD_SIZE,
    above the cards present) reduce through gloo."""
    if "WORLD_SIZE" not in os.environ:
        return False
    if is_distributed():
        return True
    cuda = torch.device(device).type == "cuda"
    if cuda:
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = backend or ("nccl" if local <= cards else "gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
    backend = backend or "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def init_tcp(rank_: int, world: int, port: int, backend: str = "gloo",
             timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a group of `world` ranks at tcp://localhost:`port` (the tests'
    and the smoke script's own workers, which no launcher describes)."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank_,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def rank0_first(fn):
    """`fn()` on rank 0, then on the other ranks once rank 0 is done (a
    barrier between): for work that fills a shared directory, such as
    generating a dataset, which the others then find ready."""
    out = fn() if rank() == 0 else None
    if is_distributed():
        dist.barrier()
    return out if rank() == 0 else fn()


def make_mesh(n_devices: int | None = None, spatial: int = 1, device_type: str | None = None):
    """The ("dp", "sp") `DeviceMesh` over every rank of the group:
    data-parallel x spatial-parallel (image rows across ranks, with a halo
    exchange around every conv: `spatial.py`). Rank r sits at (r // spatial,
    r % spatial), as the JAX mesh reshapes its devices to (n // spatial,
    spatial); `mesh.get_group("sp")` holds the ranks that share a dp shard,
    `get_group("dp")` those with the same sp index. A process group cannot
    drop ranks, so `n_devices`, when given, must be the world size, and
    `spatial` must divide it."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices in a group of {n} ranks")
    if n % spatial:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // spatial, spatial), mesh_dim_names=("dp", "sp"))


# (world group, spatial) -> its mesh: `make_mesh` makes new process groups
_MESHES: dict = {}


def dp_sp_mesh(spatial: int):
    """`make_mesh(spatial=spatial)` over the process group, made once a
    group: the trainer, its float64 twin and the sharded stream engine share
    its "dp" and "sp" groups."""
    key = (dist.group.WORLD, spatial)
    if key not in _MESHES:
        _MESHES[key] = make_mesh(spatial=spatial)
    return _MESHES[key]


def host_local_batch_size(global_batch: int) -> int:
    """This rank's slice of the global batch; the world size must divide it
    (the losses divide by the local batch, so only equal shards average to
    the global batch's gradient)."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} ranks")
    return global_batch // n


def local_rows(batch, rank_: int, world: int):
    """Rows [rank*B/world, (rank+1)*B/world) of every array of `batch` (a
    dict of arrays or tensors, or one), B its leading size."""
    if isinstance(batch, dict):
        return {k: local_rows(v, rank_, world) for k, v in batch.items()}
    b = int(batch.shape[0])
    if b % world:
        raise ValueError(f"batch {b} not divisible by {world} ranks")
    n = b // world
    return batch[rank_ * n:(rank_ + 1) * n]


# -- collectives -----------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor in a gloo group: the all-gather and the point-to-point
    sends move it through a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _buckets(tensors: Sequence[torch.Tensor]) -> dict:
    """{(device, dtype): [indices]} of `tensors`."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.device, t.dtype), []).append(i)
    return out


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None,
                     count: int | None = None) -> None:
    """Replace each tensor by its mean over the ranks, in place: one
    all-reduce (sum, then / world) of a flattened bucket per device and
    dtype. `count` replaces the world as the divisor: under spatial
    parallelism a gradient is summed over "sp" and averaged over "dp"."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    for idx in _buckets(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n if count is None else count
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def mean_metrics(metrics: dict[str, torch.Tensor], group=None) -> dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the ranks (one all-reduce)."""
    if group_size(group) == 1:
        return metrics
    keys = sorted(metrics)
    vals = [metrics[k].detach().clone().reshape(()) for k in keys]
    all_reduce_mean_(vals, group)
    return dict(zip(keys, vals))


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
    order. gloo gathers CPU tensors only: a CUDA tensor in a gloo group
    goes through a host copy and comes back to its device."""
    n = group_size(group)
    if n == 1:
        return t
    staged = _staged(t, group)
    src = t.cpu() if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def exchange(t: torch.Tensor, peer: int, group=None) -> torch.Tensor:
    """Send `t` to rank `peer` and receive its tensor of the same shape
    (one batched send/receive pair). gloo sends CPU tensors only: a CUDA
    tensor in a gloo group goes through a host copy."""
    staged = _staged(t, group)
    src = t.cpu() if staged else t.contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, peer, group), dist.P2POp(dist.irecv, buf, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(t.device) if staged else buf


def scatter_object(parts: Sequence[Any] | None, group=None) -> Any:
    """Rank r's `parts[r]` (any picklable value) from rank 0's list of one
    part a rank, which the other ranks pass as None: each rank is sent its
    own part alone. Without a group, `parts[0]`."""
    if group_size(group) == 1:
        return parts[0]
    box = [None]
    dist.scatter_object_list(box, parts if dist.get_rank(group) == 0 else None,
                             src=0, group=group)
    return box[0]


@torch.no_grad()
def broadcast_state_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Rank 0's tensors copied onto every rank (one broadcast a bucket); a
    rank whose own tensors differ from rank 0's raises (the ranks draw the
    same initial weights from the same seed)."""
    if group_size(group) == 1 or not tensors:
        return
    for idx in _buckets(tensors).values():
        own = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = own.clone()
        dist.broadcast(flat, src=0, group=group)
        if not torch.equal(flat, own):
            raise RuntimeError(f"rank {dist.get_rank(group)}'s initial weights differ "
                               "from rank 0's")
        off = 0
        for i in idx:
            t = tensors[i]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

