"""The output check fails a run whose timed path is broken underneath: each
cell's whole run on the CPU at a small size (skipping only the harness's
look for a card), with the cells' own limits, for each fault its kind of
cell can have: an answer altered where it is produced, half of the batch
left out, and for training a step that leaves its state unchanged."""
from __future__ import annotations

import pytest
import torch

from tiny import cell, run, tiny_tree
from posebench import program
from posebench.drivers import serving

build_engine, build_trainer = program.build_engine, program.build_trainer


def _shifted_answer(*args, **kwargs):
    """An engine whose step moves one frame's skeletons by a pixel."""
    return serving.shift_one_answer(build_engine(*args, **kwargs))


def _half_batch_engine(*args, **kwargs):
    """An engine whose network runs on the first half of the batch and
    gives the rest those frames' maps."""
    engine = build_engine(*args, **kwargs)
    forward = engine.model.forward

    def broken(x):
        half = max(1, x.shape[0] // 2)
        out = forward(x[:half])
        reps = -(-x.shape[0] // half)
        return {k: (torch.cat([v] * reps)[:x.shape[0]] if torch.is_tensor(v) else v)
                for k, v in out.items()}

    engine.model.forward = broken
    return engine


def _unchanged_trainer(*args, **kwargs):
    """A trainer whose step computes its loss and leaves its state as it was."""
    trainer = build_trainer(*args, **kwargs)

    def broken(batch, unlabeled=None, step_idx=0):
        return trainer.loss_and_grads(batch, grads=False)[0]

    trainer.step = broken
    return trainer


def _half_batch_trainer(*args, **kwargs):
    """A trainer whose step runs the forward on the whole batch but takes
    its loss, and so its gradient, over the first half of the images alone,
    the mean over those."""
    trainer = build_trainer(*args, **kwargs)
    targets_loss = trainer.targets_loss

    def broken(predict, kpts, valid, mask, bbxs):
        half = max(1, kpts.shape[0] // 2)

        def cut(v):
            return [cut(t) for t in v] if isinstance(v, (list, tuple)) else v[:half]

        return targets_loss({k: cut(v) for k, v in predict.items()}, kpts[:half], valid[:half],
                            mask[:half], bbxs[:half])

    trainer.targets_loss = broken
    return trainer


SERVING = ["lwopenpose-tinyvgg.offline-b32", "openpose-vgg19.live-cams"]


@pytest.mark.parametrize("workload", SERVING)
@pytest.mark.parametrize("fault", [_shifted_answer, _half_batch_engine],
                         ids=["answer_altered", "half_batch"])
def test_a_broken_serving_step_is_not_correct(workload, fault, tmp_path, monkeypatch):
    monkeypatch.setattr(program, "build_engine", fault)
    line = run(cell(workload, tiny_tree(tmp_path)))
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", [_unchanged_trainer, _half_batch_trainer],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(program, "build_trainer", fault)
    line = run(cell("lwopenpose-tinyvgg.train-b8", tiny_tree(tmp_path)))
    assert line["correct"] is False, line["checks"]
