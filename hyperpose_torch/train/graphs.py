"""The one-process training step replayed as CUDA graphs, one graph a phase.

On one CUDA device a training step is thousands of small launches, and the
host's per-op dispatch (autograd's above all) takes longer than the card
takes to run them. `Trainer.step` therefore replays its step as four CUDA
graphs, captured on one memory pool and replayed in the order they were
captured, where `applies` holds (a CUDA device, one process, the Sync_sgd
step, no domain adaptation, no row shard, no MultiSteps):

1. forward: the images / 255 in the compute dtype and the train-mode
   forward under autocast, its BatchNorm statistics updated in place
   (`batchnorm_stats_in_place`);
2. loss: the targets on the device, the family's loss and the L2 term;
3. backward: `torch.autograd.grad` of the objective;
4. optimizer: the optimizer's `update`, on the 0-d scalars that
   `set_scalars` fills from the host before each replay.

Each replay runs inside the device span of its phase (`trainer/forward`,
`trainer/loss`, `trainer/backward`, `trainer/optimizer`); the batch's copies
into the graphs' input buffers run before the forward's replay, inside its
span. As `torch.cuda.make_graphed_callables` does, the backward is captured
apart from its forward on the same pool: its kernels read the activations at
the addresses where the forward's replay writes them.

The first step at a set of input shapes runs eager: the warm-up a capture
needs (cuDNN's plans, the autograd engine's threads), and a real step. The
next step at those shapes captures, then replays; a step at other shapes
starts over. Every eager step of such a trainer runs on the stream the
graphs are captured on (the caller's stream waits for it): autograd keeps a
stream with each parameter's gradient node, which a hook holding an earlier
step's outputs keeps alive into the capture, where any other stream would
have to wait on the capturing one. A step captures anew where the optimizer object, the loss
function, or any parameter, buffer, moment or optimizer scalar now lives at
another address than at the capture (a checkpoint loaded in place is seen
by the replays as it is). Autocast runs with its weight cache off inside the
captures, as PyTorch asks of graphed autocast code: each replay casts the
updated float32 weights anew.

A replay calls no module hook. The model's own forward hooks are called
after the forward's replay with copies of that step's input and outputs
(made only while one is registered); a forward pre-hook, a backward hook, a
forward hook on a submodule or a global module hook keeps the step eager.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
from torch.nn.modules import module as _module
from torch.utils._pytree import tree_map

from ..models.backbones import batchnorm_stats_in_place
from ..parallel.train_step import sync_sgd_step
from ..utils import tracing

EAGER, WARMUP, CAPTURE, REPLAY = "eager", "warmup", "capture", "replay"
BATCH_KEYS = ("images", "kpts", "valid", "mask", "bbxs")


def applies(trainer) -> bool:
    """Whether the trainer's step may run as graphs: on a CUDA device, in
    one process (no process group), the Sync_sgd step (no `sync_mode`), no
    domain adaptation, no row shard, and an optimizer that updates at every
    call (`accum_steps` 1)."""
    opt = trainer.optimizer
    return (trainer.device.type == "cuda" and trainer.group is None
            and trainer.sync_mode is None and not trainer.domainadapt
            and trainer.row_shard is None and opt is not None and opt.accum_steps == 1)


def hooks_in_the_way(model: torch.nn.Module, modules=None) -> bool:
    """Whether a module hook would see a replayed step otherwise than an
    eager one: a global module hook, or a forward pre-hook, backward hook or
    (on a submodule) forward hook anywhere in `model` (whose `modules` may
    be given). The model's own forward hooks do not count: `StepGraphs`
    calls them."""
    if (_module._global_forward_hooks or _module._global_forward_pre_hooks
            or _module._global_backward_hooks or _module._global_backward_pre_hooks):
        return True
    return any(m._forward_pre_hooks or m._backward_hooks or m._backward_pre_hooks
               or (m is not model and m._forward_hooks)
               for m in (model.modules() if modules is None else modules))


def _signature(batch: dict) -> tuple:
    arrays = [np.asarray(batch[k]) for k in BATCH_KEYS]
    return tuple((a.shape, a.dtype.str) for a in arrays)


def _copy(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


class StepGraphs:
    """The graphs of one trainer's step (module docstring). The trainer
    asks `mode` before each step and, where it is not `EAGER`, runs the
    step through `step`."""

    def __init__(self):
        self.warm: set = set()      # input signatures that ran an eager step
        self.stream = None          # the captures' stream, made at the first need
        self.release()

    @staticmethod
    def _addresses(trainer, modules: list) -> tuple:
        """The address of every tensor the graphs read or write: the
        parameters and buffers of `modules` (the model's) and the
        optimizer's moments and scalars."""
        opt = trainer.optimizer
        tensors = [t for m in modules for d in (m._parameters, m._buffers) for t in d.values()
                   if t is not None]
        tensors = itertools.chain(tensors, opt.mu, opt.nu, (opt.neg_lr,), opt.bias_corrections)
        return tuple(map(torch.Tensor.data_ptr, tensors))

    def _fixed(self, trainer, modules: list) -> tuple:
        """What a capture fixes: the optimizer and loss objects (held, so
        that no new object takes their place unseen) and the addresses."""
        return trainer.optimizer, trainer.targets_loss, self._addresses(trainer, modules)

    def mode(self, trainer, batch: dict) -> str:
        """`EAGER` (the trainer's own step), `WARMUP` (an eager step on the
        captures' stream), `CAPTURE` (capture, then replay) or `REPLAY`
        for the trainer's next step on `batch`."""
        if not applies(trainer):
            return EAGER
        modules, sig = list(trainer.model.modules()), _signature(batch)
        if sig not in self.warm or hooks_in_the_way(trainer.model, modules):
            self.warm.add(sig)
            return WARMUP
        if (self.graphs is None or sig != self.sig or trainer.optimizer is not self.fixed[0]
                or trainer.targets_loss is not self.fixed[1]
                or self._addresses(trainer, modules) != self.fixed[2]):
            return CAPTURE
        return REPLAY

    def release(self) -> None:
        """Drop the graphs and their tensors (the pool goes with them)."""
        self.graphs = self.inputs = self.x = self.predict = self.metrics = None
        self.grads = None
        self.sig = self.fixed = None

    def capture(self, trainer, batch: dict) -> None:
        """Capture the four graphs of the trainer's step at `batch`'s
        shapes. Nothing runs: the inputs are read at each replay."""
        self.release()
        dev = trainer.device
        arrays = [np.asarray(batch[k]) for k in BATCH_KEYS]
        dtypes = [torch.as_tensor(arrays[0]).dtype, *trainer.BATCH_DTYPES]
        self.inputs = [torch.empty(a.shape, dtype=dt, device=dev)
                       for a, dt in zip(arrays, dtypes)]
        images, kpts, valid, mask, bbxs = self.inputs
        pool, stream = torch.cuda.graph_pool_handle(), self._stream()
        graphs = [torch.cuda.CUDAGraph() for _ in range(4)]
        with trainer._precision(), torch.enable_grad(), batchnorm_stats_in_place():
            with torch.cuda.graph(graphs[0], pool=pool, stream=stream):
                x = images.to(trainer.compute_dtype) / 255.0
                trainer.model.train()
                with trainer._autocast(cache=False):
                    predict = trainer.model.forward(x)      # the hooks come after the replay
            with torch.cuda.graph(graphs[1], pool=pool, stream=stream):
                metrics, objective = trainer._objective(predict, kpts, valid, mask, bbxs)
            with torch.cuda.graph(graphs[2], pool=pool, stream=stream):
                grads = torch.autograd.grad(objective, trainer.params)
            with torch.cuda.graph(graphs[3], pool=pool, stream=stream):
                trainer.optimizer.update(grads)
        detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v  # noqa: E731
        self.x, self.predict = x, tree_map(detach, predict)
        self.metrics = {k: v.detach() for k, v in metrics.items()}
        self.grads, self.graphs = grads, graphs
        self.sig = _signature(batch)
        self.fixed = self._fixed(trainer, list(trainer.model.modules()))

    def _stream(self) -> torch.cuda.Stream:
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        return self.stream

    @contextlib.contextmanager
    def _on_stream(self):
        """The block on the captures' stream, ordered after the caller's
        stream's work so far and before its work after the block."""
        caller, stream = torch.cuda.current_stream(), self._stream()
        stream.wait_stream(caller)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:
            caller.wait_stream(stream)

    def step(self, trainer, batch: dict, mode: str) -> dict:
        """One step of the trainer on `batch` in `mode` (not `EAGER`): the
        Sync_sgd step on the captures' stream, or a replay of the graphs
        (captured first with `CAPTURE`); returns the step's metrics, copies
        of the graphs' own where replayed."""
        if mode == WARMUP:
            with self._on_stream():
                return sync_sgd_step(trainer, batch)
        if mode == CAPTURE:
            self.capture(trainer, batch)
        dev = trainer.device
        fwd, loss, bwd, opt = self.graphs
        with tracing.span("trainer/forward", device=dev):
            for buf, k in zip(self.inputs, BATCH_KEYS):
                buf.copy_(torch.as_tensor(np.asarray(batch[k])), non_blocking=True)
            fwd.replay()
            self._call_forward_hooks(trainer.model)
        with tracing.span("trainer/loss", device=dev):
            loss.replay()
        with tracing.span("trainer/backward", device=dev):
            bwd.replay()
        with tracing.span("trainer/optimizer", device=dev):
            trainer.optimizer.set_scalars()
            opt.replay()
        trainer.optimizer.count += 1
        return {k: v.clone() for k, v in self.metrics.items()}

    def _call_forward_hooks(self, model: torch.nn.Module) -> None:
        """The model's forward hooks, as its call would run them, on copies
        of this step's input and outputs."""
        if not model._forward_hooks:
            return
        args, out = (self.x.clone(),), tree_map(_copy, self.predict)
        for hook_id, hook in list(model._forward_hooks.items()):
            if hook_id in model._forward_hooks_with_kwargs:
                result = hook(model, args, {}, out)
            else:
                result = hook(model, args, out)
            if result is not None:
                raise RuntimeError(
                    "a forward hook of the trainer's model replaced its outputs, which the "
                    "training step replayed as CUDA graphs cannot feed to its loss")
