"""ImageNet pretraining in the port (`hyperpose_torch/train/pretrain.py`, the
backbones' `pretraining` heads) against the JAX package on the CPU.

- The heads: tests/test_torch_pretrain_heads.py.
- Steps: 3 pretraining steps of VggTiny at 48x48, batch 4, from JAX's
  initial weights on the synthetic classification twin's batches, in
  float64 in both packages (JAX's step body with float64 parameters under
  `jax.enable_x64`; the port's `PretrainStep`): parameters, statistics and
  Adam's moments within 1e-6 of each tensor's max |value|. The whole step
  is float64 there: the logits' cast to float32 before the cross-entropy
  is a float64 one in both (the port's step widens it in a float64 run),
  and so are Adam's learning rate and bias corrections (optax's under
  `jax.enable_x64`; float32 ones moved the weights by 8e-5 of their max in
  three steps).
- JAX's `single_pretrain` itself against the port's:
  tests/test_torch_pretrain_loop.py.
- The loop (on MobilenetV1, whose small head keeps the CPU steps short):
  `single_pretrain`'s lr events and logged lr against JAX's with a scripted
  validation (the stuck branch) and with the schedule; a resumed run keeps
  the decayed lr. `single_val`'s top-1 / top-5 equal JAX's on the same
  weights; the port learns the synthetic twin (Resnet18, 20 steps); a
  VggTiny npz grafts into either package's flagship with the same count;
  `tools.pretrain` writes its npz. Tests delete their checkpoints (VggTiny's
  with its head holds 27 M parameters at 32x32) when they pass.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pifpaf import _flax_shapes
from torch_parity import nest
from hyperpose_tpu import config as JC
from hyperpose_tpu.data.synthetic import generate_synthetic_imagenet
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.train import pretrain as JP
from hyperpose_torch import config as PC
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.train import pretrain as PP
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

X64_RTOL = 1e-6        # of each tensor's max |value|
N_CLASSES, SIZE = 4, 48

def _close(got, want, name, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max |d| {err} vs max |v| {scale}"


def _flat_tree(tree, prefix):
    return {f"{prefix}/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


# -- the pretraining steps and loop ------------------------------------------------

@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthin"))
    generate_synthetic_imagenet(root, n_classes=N_CLASSES, n_train_per_class=12,
                                n_val_per_class=4, size=SIZE, seed=3)
    return root


def _configs(tmp, **over):
    """The JAX and the port's pretraining configs, the same overrides."""
    out = []
    for C, sub in ((JC, "jax"), (PC, "port")):
        C.reset()
        C.set_pretrain(True)
        kw = dict(batch_size=8, lr_init=1e-3, log_interval=5, val_interval=10**6,
                  save_interval=10**6, lr_decay_step=10**6, val_num=64,
                  pretrain_model_dir=os.path.join(str(tmp), sub))
        kw.update(over)
        for k, v in kw.items():
            C._set("pretrain", k, v)
        out.append(C.get_config(create_dirs=False))
        C.reset()
    return out


def _jax_pretrain_step(model, tx):
    """The body of `hyperpose_tpu/train/pretrain.py` single_pretrain's step,
    the logits' cast widened to the float64 of the run (module docstring)."""

    def step(params, batch_stats, opt_state, images, labels):
        def loss_fn(pp):
            logits, updates = model.apply({"params": pp, "batch_stats": batch_stats}, images,
                                          train=True, mutable=["batch_stats"])
            loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.promote_types(logits.dtype, jnp.float32)), labels))
            return loss, updates["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, loss

    return jax.jit(step)


def test_three_float64_steps_match_jax(imagenet_root, tmp_path):
    jcfg, pcfg = _configs(tmp_path, batch_size=4)
    p = jcfg.pretrain
    ds, _ = JP.load_imagenet_splits(imagenet_root, image_size=SIZE)
    pds, _ = PP.load_imagenet_splits(imagenet_root, image_size=SIZE)
    rng, prng = np.random.default_rng(0), np.random.default_rng(0)
    batches = [b for b, _ in zip(ds.batches(4, rng), range(3))]
    pbatches = [b for b, _ in zip(pds.batches(4, prng), range(3))]
    for (a, la), (b, lb) in zip(batches, pbatches):   # the same copy of the reader
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)

    jm = JB.VggTiny(pretraining=True, dtype=jnp.float64)
    v = jax.jit(lambda x: JB.VggTiny(pretraining=True).init(
        jax.random.PRNGKey(0), x, train=True))(jnp.zeros((1, SIZE, SIZE, 3)))
    flat = {**_flat_tree(v["params"], "params"), **_flat_tree(v["batch_stats"], "batch_stats")}

    model = load_flax_weights(PB.VggTiny(pretraining=True, image_size=SIZE), flat)
    model = model.to(torch.float64)
    opt = PP.pretrain_optimizer(model, pcfg)
    step = PP.PretrainStep(model, opt, torch.float64)
    tx = optax.chain(optax.add_decayed_weights(p.weight_decay_factor),
                     optax.inject_hyperparams(optax.adam)(learning_rate=p.lr_init))
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["params"])
        stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["batch_stats"])
        state = tx.init(params)
        jstep = _jax_pretrain_step(jm, tx)
        for (images, labels), (pi, pl) in zip(batches, pbatches):
            params, stats, state, loss = jstep(params, stats, state,
                                               jnp.asarray(images, jnp.float64),
                                               jnp.asarray(labels))
            ploss, _ = step(pi, pl)
            _close(float(ploss), float(loss), "loss", X64_RTOL)
        want = {**_flat_tree(params, "params"), **_flat_tree(stats, "batch_stats"),
                **_flat_tree(state[1].inner_state[0].mu, "mu"),
                **_flat_tree(state[1].inner_state[0].nu, "nu")}
    got = state_dict_to_flax(model.state_dict())
    names = [n for n, q in model.named_parameters()]
    for tag, moments in (("mu", opt.mu), ("nu", opt.nu)):
        got.update({k.replace("params/", tag + "/", 1): val for k, val in state_dict_to_flax(
            dict(zip(names, moments))).items()})
    assert opt.count == 3 and int(state[1].inner_state[0].count) == 3
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == np.float64, k
        _close(got[k], w, k, X64_RTOL)


def test_stuck_validation_and_schedule_match_jax(imagenet_root, tmp_path):
    """The lr events, the logged lr and the validations of
    `single_pretrain` over 6 steps with the schedule at every 3rd step and a
    scripted validation at every step (tests/test_pretrain.py's: stuck 3
    times by step 4) equal the JAX loop's history."""
    accs = [0.5, 0.4, 0.4, 0.4, 0.45, 0.3]
    jcfg, pcfg = _configs(tmp_path, val_interval=1, lr_decay_step=3, log_interval=1,
                          batch_size=4)
    jacc, pacc = iter(accs), iter(accs)
    _, _, jh = JP.single_pretrain(
        JB.MobilenetV1, jcfg, dataset=JP.load_imagenet_splits(imagenet_root, SIZE)[0],
        n_step=6, val_fn=lambda *a: {"top1": next(jacc), "top5": 1.0, "n": 1})
    _, ph = PP.single_pretrain(
        PB.MobilenetV1, pcfg, dataset=PP.load_imagenet_splits(imagenet_root, SIZE)[0],
        n_step=6, val_fn=lambda m: {"top1": next(pacc), "top5": 1.0, "n": 1}, device="cpu")
    assert jh["lr_events"] == [("schedule", 3), ("stuck_val", 4), ("schedule", 6)]
    assert ph["lr_events"] == jh["lr_events"]
    assert [r["lr"] for r in ph["log"]] == [r["lr"] for r in jh["log"]]
    assert [v["top1"] for v in ph["val"]] == [v["top1"] for v in jh["val"]]
    shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints


def test_resumed_run_keeps_the_decayed_lr(imagenet_root, tmp_path):
    """2 steps with lr / 5 at step 2 and a checkpoint, then a resumed run to
    step 3: its lr is the decayed one, as a straight 3-step run's, and its
    checkpoint keeps it."""
    _, pcfg = _configs(tmp_path / "a", lr_decay_step=2, log_interval=1, save_interval=2,
                       batch_size=4)
    ds = PP.load_imagenet_splits(imagenet_root, SIZE)[0]
    PP.single_pretrain(PB.MobilenetV1, pcfg, dataset=ds, n_step=2, device="cpu")
    _, h = PP.single_pretrain(PB.MobilenetV1, pcfg, dataset=ds, n_step=3, device="cpu")
    decayed = float(np.float32(float(np.float32(1e-3)) / 5.0))
    assert [r["step"] for r in h["log"]] == [3] and h["log"][0]["lr"] == decayed
    _, pcfg_b = _configs(tmp_path / "b", lr_decay_step=2, log_interval=1, batch_size=4)
    _, hb = PP.single_pretrain(PB.MobilenetV1, pcfg_b, dataset=ds, n_step=3,
                               device="cpu")
    assert hb["log"][-1]["lr"] == h["log"][-1]["lr"]
    state = torch.load(os.path.join(pcfg.pretrain.pretrain_model_dir, "ckpt", "3.pt"))
    assert state["optimizer"]["lr"] == decayed and state["optimizer"]["count"] == 3
    shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints


def test_single_val_matches_jax(imagenet_root, tmp_path):
    jcfg, pcfg = _configs(tmp_path)
    _, val = JP.load_imagenet_splits(imagenet_root, SIZE)
    _, pval = PP.load_imagenet_splits(imagenet_root, SIZE)
    flat = random_flax_weights(_flax_shapes(JB.VggTiny(pretraining=True), (SIZE, SIZE)), 7)
    v = nest(flat)
    want = JP.single_val(JB.VggTiny(pretraining=True), v["params"], v["batch_stats"], val,
                         jcfg, batch_size=8)
    model = load_flax_weights(PB.VggTiny(pretraining=True, image_size=SIZE), flat)
    got = PP.single_val(model, pval, pcfg, batch_size=8)
    assert got == want and got["n"] == N_CLASSES * 4


def test_single_pretrain_learns(imagenet_root, tmp_path):
    """20 steps of Resnet18 on the synthetic twin (tests/test_pretrain.py's
    set): the loss falls, top-1 beats chance (0.25) in training and in
    validation."""
    _, pcfg = _configs(tmp_path)
    train_ds, val_ds = PP.load_imagenet_splits(imagenet_root, SIZE)
    model, history = PP.single_pretrain(PB.Resnet18, pcfg, dataset=train_ds,
                                        val_dataset=val_ds, n_step=20, device="cpu")
    first, last = history["log"][0], history["log"][-1]
    assert last["loss"] < first["loss"], history["log"]
    assert last["top1"] > 0.4, history["log"]
    v = PP.single_val(model, val_ds, pcfg, batch_size=8)
    assert v["top5"] >= v["top1"] > 0.3, v
    assert os.path.exists(os.path.join(pcfg.pretrain.pretrain_model_dir,
                                       "newest_Resnet18.npz"))
    shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints


def test_npz_grafts_into_both_flagships(tmp_path):
    """The port's newest_VggTiny.npz (as `single_pretrain` writes it, of the
    seed-0 pretraining model) grafts into the port's flagship and into
    JAX's with the same count and values, and JAX's npz into the port's."""
    from hyperpose_tpu.models.openpose import LightWeightOpenPose as JLW
    from hyperpose_tpu.train.checkpoint import save_weights_npz as jax_save
    from hyperpose_torch.models.openpose import LightWeightOpenPose as PLW
    from hyperpose_torch.train.checkpoint import save_weights_npz

    npz = str(tmp_path / "newest_VggTiny.npz")
    save_weights_npz(PP.pretrain_model(PB.VggTiny, 32, "cpu"), npz)
    port_lw = PLW(backbone=PB.VggTiny)
    n_port = PP.load_pretrained_backbone(port_lw, npz)
    jvars = jax.jit(lambda x: JLW(backbone=JB.VggTiny).init(
        jax.random.PRNGKey(0), x, train=True))(jnp.zeros((1, 64, 64, 3)))
    grafted, n_jax = JP.load_pretrained_backbone(jvars, npz)
    assert n_port == n_jax == 45      # 9 ConvBNs x (kernel, scale, bias, mean, var)
    got = state_dict_to_flax(port_lw.state_dict())
    for k in ("block_0/conv/kernel", "block_8/bn/scale"):
        want = grafted["params"]["backbone"]
        for part in k.split("/"):
            want = want[part]
        np.testing.assert_array_equal(got[f"params/backbone/{k}"], np.asarray(want))
    jpre = jax.jit(lambda x: JB.VggTiny(pretraining=True).init(
        jax.random.PRNGKey(1), x, train=True))(jnp.zeros((1, 32, 32, 3)))
    jnpz = str(tmp_path / "jax_newest_VggTiny.npz")
    jax_save({"params": jpre["params"], "batch_stats": jpre["batch_stats"]}, jnpz)
    port_lw2 = PLW(backbone=PB.VggTiny)
    assert PP.load_pretrained_backbone(port_lw2, jnpz) == n_jax
    np.testing.assert_array_equal(
        state_dict_to_flax(port_lw2.state_dict())["params/backbone/block_8/conv/kernel"],
        np.asarray(jpre["params"]["block_8"]["conv"]["kernel"]))
    shutil.rmtree(tmp_path, ignore_errors=True)   # two 100 MB npz files


def test_tools_pretrain_writes_its_npz(tmp_path, monkeypatch):
    """`python -m hyperpose_torch.tools.pretrain --synthetic --n_step 2
    --device cpu` generates the twin (10 classes at 96x96), takes 2 steps
    and writes newest_<Backbone>.npz with the head's keys (MobilenetV1,
    whose checkpoint is small; VggTiny's head alone is 98 M parameters at
    224); without `--device cpu` and without a GPU it raises."""
    from hyperpose_torch.tools import pretrain as tool

    monkeypatch.chdir(tmp_path)
    model, history, cfg = tool.run(["--synthetic", "--model_backbone", "Mobilenetv1",
                                    "--n_step", "2", "--batch_size", "4",
                                    "--log_interval", "1", "--device", "cpu"])
    npz = os.path.join(cfg.pretrain.pretrain_model_dir, "newest_MobilenetV1.npz")
    assert os.path.exists(npz) and len(history["log"]) == 2
    with np.load(npz) as data:
        assert data["params/fc_out/kernel"].shape == (1024, 1000)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            tool.run(["--n_step", "1"])
    shutil.rmtree(tmp_path / "save_dir", ignore_errors=True)
