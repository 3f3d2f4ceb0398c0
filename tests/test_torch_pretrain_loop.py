"""JAX's own `single_pretrain` against the port's (ImageNet pretraining,
`hyperpose_torch/train/pretrain.py`) on the CPU: 3 steps of MobilenetV1 in
float64 (JAX's loop under `jax.enable_x64`), from the same initial weights
on the same batches of the synthetic classification twin. JAX's loop casts
the logits to float32 before the cross-entropy, which leaves float32
rounding in its float64 gradients; the port's float64 step widens that
cast. So the bounds are set from a reading, not the 1e-6 that
tests/test_torch_pretrain.py holds JAX's step body to with the cast
widened in both.
"""
import shutil
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from test_torch_pretrain import (  # noqa: F401  (imagenet_root is a fixture)
    SIZE, _as64, _close, _configs, _flat_tree, imagenet_root,
)
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.train import pretrain as JP
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.train import pretrain as PP
from hyperpose_torch.utils.weights import load_flax_weights, state_dict_to_flax

# read 1.3e-4 (params/sep_6/bn2/bias), 6.4e-5 (mu), 5.5e-5 (nu) and 1.6e-6
# (statistics) of each tensor's max |value|; the losses 6.2e-8
LOOP_RTOL = 1e-3
LOOP_LOSS_RTOL = 1e-6


class _MobilenetV1x64(JB.MobilenetV1):
    """JAX's MobilenetV1 computing in float64 on float64 variables: the
    flax module keeps float32 parameters whatever its `dtype`, so `init`
    casts them."""
    dtype: Any = jnp.float64

    def init(self, *args, **kwargs):
        return _as64(super().init(*args, **kwargs))


def test_single_pretrain_matches_the_jax_loop(imagenet_root, tmp_path, monkeypatch):
    """JAX's own `single_pretrain` (under `jax.enable_x64`, on MobilenetV1
    in float64) against the port's in float64, 3 steps on the same batches
    from the same initial weights: the logged losses, the parameters and
    statistics, and Adam's moments (read from JAX's checkpoint, which
    restores only into the chain the port rebuilds: optax's
    add_decayed_weights, then inject_hyperparams(adam)) within `LOOP_RTOL`
    of each tensor's max |value|, and the same lr and count."""
    from hyperpose_tpu.train.checkpoint import CheckpointManager as JaxCkpt

    jcfg, pcfg = _configs(tmp_path, batch_size=4, log_interval=1)
    p = jcfg.pretrain
    with jax.enable_x64(True):
        v = _MobilenetV1x64(pretraining=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=True)
        jparams, jstats, jh = JP.single_pretrain(
            _MobilenetV1x64, jcfg, dataset=JP.load_imagenet_splits(imagenet_root, SIZE)[0],
            n_step=3)
        tx = optax.chain(optax.add_decayed_weights(p.weight_decay_factor),
                         optax.inject_hyperparams(optax.adam)(learning_rate=p.lr_init))
        _, jstate = JaxCkpt(p.pretrain_model_dir).restore(
            {"params": jparams, "batch_stats": jstats, "opt_state": tx.init(jparams)})
        adam = jstate["opt_state"][1]
        want = {**_flat_tree(jstate["params"], "params"),
                **_flat_tree(jstate["batch_stats"], "batch_stats"),
                **_flat_tree(adam.inner_state[0].mu, "mu"),
                **_flat_tree(adam.inner_state[0].nu, "nu")}
        j_count, j_lr = int(adam.inner_state[0].count), float(adam.hyperparams["learning_rate"])
    flat = {**_flat_tree(v["params"], "params"), **_flat_tree(v["batch_stats"], "batch_stats")}
    monkeypatch.setattr(PP, "pretrain_model", lambda cls, size, dev: load_flax_weights(
        cls(pretraining=True), flat).to(dev, torch.float64))
    captured = {}
    real_optimizer = PP.pretrain_optimizer
    monkeypatch.setattr(PP, "pretrain_optimizer", lambda m, c: captured.setdefault(
        "opt", real_optimizer(m, c)))
    model, ph = PP.single_pretrain(
        PB.MobilenetV1, pcfg, dataset=PP.load_imagenet_splits(imagenet_root, SIZE)[0],
        n_step=3, device="cpu", compute_dtype=torch.float64)
    opt = captured["opt"]

    assert opt.count == j_count == 3
    assert opt.learning_rate == j_lr == ph["log"][-1]["lr"]
    assert [r["lr"] for r in ph["log"]] == [r["lr"] for r in jh["log"]]
    got = state_dict_to_flax(model.state_dict())
    names = [n for n, q in model.named_parameters()]
    for tag, moments in (("mu", opt.mu), ("nu", opt.nu)):
        got.update({k.replace("params/", tag + "/", 1): val for k, val in state_dict_to_flax(
            dict(zip(names, moments))).items()})
    assert sorted(got) == sorted(want)
    for a, b in zip(ph["log"], jh["log"]):
        _close(a["loss"], b["loss"], f"loss {a['step']}", LOOP_LOSS_RTOL)
    for k, w in want.items():
        assert got[k].dtype == np.float64, k
        _close(got[k], w, k, LOOP_RTOL)
    shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints
