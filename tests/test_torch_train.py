"""The port's training step (`hyperpose_torch/train/trainer.py` `Trainer`)
against the JAX package's on the CPU, from the same initial weights (a
flax `init`, or seeded random weights, carried across through the weight
bridge) and the same seeded batch (tests/torch_train_cases.py).

The JAX side is the body of `hyperpose_tpu/train/trainer.py`'s step
(`_build_step` / `_build_dmadapt_step`, jitted, without the device mesh),
on the JAX package's own `_family_targets_loss`, `l2_regularization` and
`make_optimizer`. Each step is taken twice on each side:

- in float64 (`jax.enable_x64`: the flax module's dtype, parameters,
  statistics and optimizer state float64; the port's `Trainer.twin`): the
  two packages' gradients agree tensor by tensor within 1e-6 in relative
  L2 norm (2.6e-7 at worst here), the new BatchNorm statistics within
  1e-6 x max(1, |v|), and the weights after Adam's update within 1e-3 x lr
  wherever JAX's |g| is at least 1e-6 of its tensor's max (3.5e-5 x lr at
  worst); below that a gradient is its rounding even in float64, and
  Adam's first step, lr x g / (|g| + 1e-8), may take either sign there
  (PifPaf: 2 x lr), so those weights are held within 2 x lr. Both losses
  form in float32 (the heads' outputs are cast to float32), so the loss is
  held as in float32. This is the witness that the two steps are the same
  function;
- in float32, as the trainers run: the loss and its parts within 1e-5
  relative, the new statistics within 3e-5 x max(1, |v|), and each
  package's float32 gradients held to JAX's float64 ones: over all the
  gradients the port's within 1e-2 in relative L2 norm and JAX's within
  5e-2, each tensor within 0.25 (its norm floored at 1e-4 of the largest
  tensor's, for the gradients that are 0 but for rounding: a conv bias
  before a train-mode BatchNorm). Float32 gradients of a train-mode step at
  flax's initialization are that noisy: a ReLU or max-pool input within a
  rounding of its threshold flips, and a BatchNorm's gradient cancels, so a
  tensor summed over few elements lands several % from float64, in JAX as
  in the port (JAX's float32 lands farther: 2.4% of the whole gradient's
  norm against the port's 0.4% on PifPaf). After Adam's update every
  parameter is within 2 x lr of JAX's (Adam's first step moves a weight by
  about lr x sign(g), and a gradient within the noise may flip its sign; a
  conv bias before a train-mode BatchNorm has only noise), and at most 1%
  of all the weights differ by more than 1e-3 x lr.

- One flagship step (Lightweight-OpenPose on VggTiny, 32 channels, 64x80,
  batch 2, Adam, JAX's initial weights), in float32 and float64.
- Three SGD steps (lr 1e-6): in float64 the weights' movement over the
  three steps within 1e-6 of JAX's per tensor (relative L2; 1.7e-8 here).
  In float32 within 5e-2 over all the weights (0.5 per tensor), the first
  step's loss within 1e-5 relative, the next ones' within 1e-3: the two
  float32 runs lie 1.5% apart after three steps, each 4.3-4.6% from the
  float64 steps (at lr 1e-5, 24% apart and 35-36% from float64, while the
  float64 steps stay within 8.3e-8): float32 rounding amplified by the
  steps, in JAX as in the port.
- PoseProposal, PifPaf and bfloat16 steps: tests/test_torch_train_families.py;
  domain adaptation: tests/test_torch_train_dmadapt.py; train-mode
  BatchNorm of every family: tests/test_torch_train_bn.py.
- A checkpoint resumes bit for bit, and `newest_model.npz` loads into the
  JAX model with the same maps (within 1e-4 x their max).
"""
import contextlib
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pifpaf import _flax_shapes
from torch_parity import nest
from torch_train_cases import bbxs_of, crowd_mask, random_people
from hyperpose_tpu import config as JC
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models import pifpaf as JPF
from hyperpose_tpu.models import pose_proposal as JPP
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch import config as PC
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models import pifpaf as PPF
from hyperpose_torch.models import pose_proposal as PPP
from hyperpose_torch.train.checkpoint import load_npz_tree
from hyperpose_torch.train.trainer import Trainer, make_optimizer
from hyperpose_torch.utils.topology import COCO_TOPOLOGY, PIFPAF_TOPOLOGY, PPN_TOPOLOGY
from hyperpose_torch.utils.weights import (
    load_flax_weights, random_flax_weights, state_dict_to_flax,
)

LR = 1e-4
ADAM_FLIP = 2 * LR * (1 + 1e-3)   # two first Adam steps of opposite signs
X64_RTOL = 1e-6     # the port's float64 step against JAX's
STATS_RTOL = 3e-5   # float32 statistics (module docstring)


def _flat_tree(tree, prefix):
    return {f"{prefix}/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def as64(tree):
    """Every leaf of `tree` as a float64 JAX array (under jax.enable_x64)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _x64(on: bool):
    return jax.enable_x64(True) if on else contextlib.nullcontext()


def _rel_close(got, want, name, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max |d| {err} vs max |v| {scale}"


def _stats_close(port_flat: dict, want: dict, rtol=STATS_RTOL):
    """Every "batch_stats/..." entry of the flat `port_flat` against `want`'s
    within rtol x max(1, |v|)."""
    got = {k: v for k, v in port_flat.items() if k.startswith("batch_stats/")}
    assert sorted(got) == sorted(want) and want
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert (err <= rtol * np.maximum(1.0, np.abs(w))).all(), f"{k}: max |d| {err.max()}"


def _lw_vggtiny_j(dtype=jnp.float32):
    return JO.LightWeightOpenPose(backbone=JB.VggTiny, num_channels=32, dtype=dtype)


def _lw_vggtiny_p():
    return PO.LightWeightOpenPose(backbone=PB.VggTiny, num_channels=32)


# -- batches and configs -------------------------------------------------------

def _batch(seed, hw, out_hw, n_parts, b=2, people=4):
    kpts, valid = random_people(seed, b, people, n_parts, hw)
    if n_parts == 19:   # the OpenPose family's dead background row
        kpts[:, :, 18] = -1000.0
        valid[:, :, 18] = False
    rng = np.random.default_rng(seed + 100)
    return {"images": rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8),
            "kpts": kpts, "valid": valid, "mask": crowd_mask(b, out_hw),
            "bbxs": bbxs_of(kpts, valid)}


def _configs(tmp, model_type, hw, out_hw, optim="Adam", dtype="float32", dmadapt=False):
    out = []
    for C, sub in ((JC, "jax"), (PC, "port")):
        C.reset()
        C.set_model_type(C.MODEL[model_type])
        C.set_model_inout(hin=hw[0], win=hw[1], hout=out_hw[0], wout=out_hw[1])
        C.set_optim_type(C.OPTIM[optim])
        C.set_compute_dtype(dtype)
        C.set_learning_rate(LR if optim == "Adam" else 1e-6)
        if dmadapt:
            C.set_domainadapt_dataset(["unused.jpg"])
        cfg = C.get_config(create_dirs=False)
        cfg.model.model_dir = os.path.join(str(tmp), sub)
        out.append(cfg)
    PC.reset()
    JC.reset()
    return out


def _jax_step(cfg, jm, limbs):
    """The JAX trainer's step body (`Trainer._build_step`'s `step`), jitted
    on one device; it also returns the gradients."""
    in_hw, out_hw = (cfg.model.hin, cfg.model.win), (cfg.model.hout, cfg.model.wout)
    targets_loss = JTR.Trainer._family_targets_loss(cfg, jm, limbs, in_hw, out_hw)
    wd = cfg.train.weight_decay_factor
    optimizer = JTR.make_optimizer(cfg)

    def step(params, batch_stats, opt_state, images, kpts, valid, mask, bbxs):
        def loss_wrapped(p):
            x = images.astype(jm.dtype) / 255.0
            predict, updates = jm.apply({"params": p, "batch_stats": batch_stats}, x,
                                        train=True, mutable=["batch_stats"])
            pd_loss, parts = targets_loss(predict, kpts, valid, mask, bbxs)
            re_loss = JTR.l2_regularization(p, wd)
            parts = dict(parts, loss_re=re_loss, pd_loss=pd_loss)
            return pd_loss + re_loss, (parts, updates["batch_stats"])

        (loss, (parts, new_stats)), grads = jax.value_and_grad(loss_wrapped, has_aux=True)(
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_stats, opt_state, dict(parts, total_loss=loss), grads

    return jax.jit(step), optimizer


def _jax_args(batch):
    return [jnp.asarray(batch[k]) for k in ("images", "kpts", "valid", "mask", "bbxs")]


def _port_trainer(cfg, pm, limbs, flat):
    """A CPU `Trainer` on `flat`'s weights with a fresh optimizer (what
    `init_state` leaves, with these weights in place of its draw)."""
    tr = Trainer(cfg, pm, limbs, device="cpu")
    load_flax_weights(tr.model, flat)
    tr.optimizer = make_optimizer(cfg, tr.params)
    return tr


def _l2(d, ref, floor=0.0) -> float:
    """||d|| / max(||ref||, floor)."""
    return float(np.linalg.norm(d)) / max(float(np.linalg.norm(ref)), floor, 1e-30)


def _check_params(got: dict, want: dict):
    """Weights after one float32 Adam update against JAX's: within 2 x lr
    everywhere (two first steps of opposite signs), and at most 1% of all
    the weights (the gradients' sign flips, module docstring) farther than
    1e-3 x lr."""
    n = flipped = 0
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert (d <= ADAM_FLIP).all(), f"{k}: max |d| {d.max()}"
        n, flipped = n + d.size, flipped + int((d > 1e-3 * LR).sum())
    assert flipped <= 1e-2 * n, f"{flipped} of {n} weights flipped"


def grad_errors(got: dict, want: dict) -> tuple[dict, float]:
    """({key: relative L2 distance of got's gradient from want's, the norm
    floored at 1e-4 of want's largest tensor's}, the relative L2 distance
    over all the gradients)."""
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    top = max(float(np.linalg.norm(want[k])) for k in keys)
    per = {k: _l2(got[k] - want[k], want[k], 1e-4 * top) for k in keys}
    whole = _l2(np.concatenate([np.ravel(got[k] - want[k]) for k in keys]),
                np.concatenate([np.ravel(want[k]) for k in keys]))
    return per, whole


def _check_x64_grads(got: dict, want: dict, rtol=X64_RTOL, what="d/d"):
    """The port's float64 gradients against JAX's: each tensor within rtol."""
    per, _ = grad_errors(got, want)
    for k, e in per.items():
        assert e <= rtol, f"{what} {k}: float64 port vs JAX {e}"


def check_x64_adam(got: dict, want: dict, grads: dict, tight=1e-3):
    """Weights after one float64 Adam update against JAX's: within
    tight x lr where JAX's |g| is at least 1e-6 of its tensor's max |g|, and
    within 2 x lr below that, where the gradient is its rounding and Adam's
    first step, lr x g / (|g| + 1e-8), may take either sign (module
    docstring)."""
    for k, w in want.items():
        d, g = np.abs(got[k] - w), np.abs(grads[k])
        big = g >= 1e-6 * g.max()
        assert (d[big] <= tight * LR).all(), f"{k}: max |d| {d[big].max()}"
        assert (d <= ADAM_FLIP).all(), f"{k}: max |d| {d.max()}"


def _check_grads(port: dict, jax32: dict, jax64: dict, whole_rtol=(1e-2, 5e-2), rtol=0.1):
    """Both packages' float32 gradients against JAX's float64 ones (module
    docstring): each tensor within rtol in relative L2 norm, and over all
    the gradients the port's within whole_rtol[0] and JAX's within
    whole_rtol[1]."""
    for name, g, bound in (("port", port, whole_rtol[0]), ("JAX", jax32, whole_rtol[1])):
        per, whole = grad_errors(g, jax64)
        for k, e in per.items():
            assert e <= rtol, f"d/d {k}: {name} float32 vs JAX float64 {e}"
        assert whole <= bound, (name, whole)


def _port_grads_flax(tr, grads):
    """{flax key: port gradient} (HWIO kernels)."""
    sd = {n: g for (n, _), g in zip(tr.model.named_parameters(), grads)}
    return state_dict_to_flax(sd)


# -- the steps of each family ----------------------------------------------------

STEP_CASES = {  # name -> (model type, flax module of a dtype, port module, input, output,
    #                     keypoint rows, limbs, batch seed)
    "flagship": ("LightweightOpenpose", _lw_vggtiny_j, _lw_vggtiny_p, (64, 80), (8, 10), 19,
                 COCO_TOPOLOGY.limbs, 0),
    "ppn": ("PoseProposal", lambda dt=jnp.float32: JPP.PoseProposal(hin=128, win=128, dtype=dt),
            lambda: PPP.PoseProposal(hin=128, win=128), (128, 128), (4, 4), 18,
            PPN_TOPOLOGY.limbs, 1),
    "pifpaf": ("Pifpaf", lambda dt=jnp.float32: JPF.Pifpaf(hin=64, win=64, dtype=dt),
               lambda: PPF.Pifpaf(hin=64, win=64), (64, 64), (8, 8), 17,
               PIFPAF_TOPOLOGY.limbs, 1),
}


def _jit_init(jm, hw):
    return jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=True))(
        jnp.zeros((1, *hw, 3)))


@lru_cache(maxsize=None)
def case_flat(name) -> dict:
    """The case's initial weights, flat: JAX's flax init for the flagship,
    seeded random weights (seed 5) for the others."""
    _, jmf, _, hw, *_ = STEP_CASES[name]
    if name == "flagship":
        v = _jit_init(jmf(), hw)
        return {**_flat_tree(v["params"], "params"),
                **_flat_tree(v["batch_stats"], "batch_stats")}
    return random_flax_weights(_flax_shapes(jmf(), hw), seed=5)


def case_batch(name, seed=None) -> dict:
    _, _, _, hw, out_hw, n_parts, _, default = STEP_CASES[name]
    return _batch(default if seed is None else seed, hw, out_hw, n_parts)


def case_port(name, tmp, optim="Adam", dtype="float32") -> Trainer:
    """The port's CPU trainer of the case on its initial weights."""
    mt, _, pmf, hw, out_hw, _, limbs, _ = STEP_CASES[name]
    _, pcfg = _configs(tmp, mt, hw, out_hw, optim, dtype)
    return _port_trainer(pcfg, pmf(), limbs, case_flat(name))


@lru_cache(maxsize=None)
def _jax_case_step(name, optim, x64):
    """(jitted JAX step, its optimizer) of the case in float32, or in
    float64 (traced and called under jax.enable_x64)."""
    mt, jmf, _, hw, out_hw, _, limbs, _ = STEP_CASES[name]
    jcfg, _ = _configs("/nonexistent", mt, hw, out_hw, optim)
    return _jax_step(jcfg, jmf(jnp.float64 if x64 else jnp.float32), limbs)


def run_jax(name, batches, optim="Adam", x64=False) -> list[dict]:
    """JAX's steps of the case from its initial weights, one per batch: for
    each, the flat params, batch_stats and gradients after it and its
    metrics, as numpy."""
    step, opt = _jax_case_step(name, optim, x64)
    v = nest(case_flat(name))
    out = []
    with _x64(x64):
        params, stats = v["params"], v["batch_stats"]
        if x64:
            params, stats = as64(params), as64(stats)
        state = opt.init(params)
        for b in batches:
            params, stats, state, metrics, grads = step(params, stats, state, *_jax_args(b))
            out.append({"params": _flat_tree(params, "params"),
                        "stats": _flat_tree(stats, "batch_stats"),
                        "grads": _flat_tree(grads, "params"),
                        "metrics": {k: np.asarray(m) for k, m in metrics.items()}})
    return out


@lru_cache(maxsize=None)
def jax_step1(name, x64=False) -> dict:
    """JAX's first Adam step of the case on its batch (`run_jax`)."""
    return run_jax(name, [case_batch(name)], x64=x64)[0]


def _check_metrics(got: dict, want: dict, rtol: float):
    assert sorted(got) == sorted(want)
    for k in want:
        _rel_close(np.asarray(got[k], np.float64), want[k], k, rtol)


def check_step_matches_jax(name, tmp, loss_rtol):
    """The case's float32 Adam step against JAX's: loss and parts, the new
    statistics, the weights after the update."""
    want = jax_step1(name)
    tr = case_port(name, tmp)
    metrics, grads = tr.loss_and_grads(case_batch(name))
    _check_metrics({k: v.numpy() for k, v in metrics.items()}, want["metrics"], loss_rtol)
    _stats_close(state_dict_to_flax(tr.model.state_dict()), want["stats"])
    tr.optimizer.step(grads)
    flat = state_dict_to_flax(tr.model.state_dict())
    _check_params(flat, want["params"])


def check_float64_step(name, tmp, loss_rtol):
    """The case's Adam step in float64 in both packages (`Trainer.twin`
    against a float64 flax module): the loss and parts, every gradient and
    new statistic within X64_RTOL, the weights after the update
    (`check_x64_adam`)."""
    want = jax_step1(name, x64=True)
    tw = case_port(name, tmp).twin()
    metrics, grads = tw.loss_and_grads(case_batch(name))
    assert all(p.dtype == torch.float64 for p in tw.model.parameters())
    _check_metrics({k: v.numpy() for k, v in metrics.items()}, want["metrics"], loss_rtol)
    _check_x64_grads(_port_grads_flax(tw, grads), want["grads"])
    _stats_close(state_dict_to_flax(tw.model.state_dict()), want["stats"], X64_RTOL)
    tw.optimizer.step(grads)
    check_x64_adam(state_dict_to_flax(tw.model.state_dict()), want["params"], want["grads"])


def check_float32_grads(name, tmp):
    """The case's float32 gradients, the port's and JAX's, against JAX's
    float64 ones (`_check_grads`)."""
    tr = case_port(name, tmp)
    _, grads = tr.loss_and_grads(case_batch(name))
    _check_grads(_port_grads_flax(tr, grads), jax_step1(name)["grads"],
                 jax_step1(name, x64=True)["grads"])


# -- the flagship --------------------------------------------------------------

def test_flagship_step_matches_jax(tmp_path):
    """One Adam step of the narrow flagship from JAX's initial weights."""
    check_step_matches_jax("flagship", tmp_path, 1e-5)


def test_flagship_float32_gradients_near_jax_float64(tmp_path):
    check_float32_grads("flagship", tmp_path)


def test_flagship_float64_step_matches_jax_float64(tmp_path):
    check_float64_step("flagship", tmp_path, 1e-5)


def _movement_errors(got: dict, want: dict, start: dict) -> tuple[dict, float]:
    """({key: relative L2 distance of got's weights from want's, over want's
    movement from start (floored at 1e-4 of the largest)}, the same over all
    the weights)."""
    return grad_errors({k: got[k] - start[k] for k in want},
                       {k: w - start[k] for k, w in want.items()})


def test_three_sgd_steps_match_jax(tmp_path):
    batches = [case_batch("flagship", 10 + i) for i in range(3)]
    start = {k: v for k, v in case_flat("flagship").items() if k.startswith("params/")}
    for x64 in (True, False):
        want = run_jax("flagship", batches, "SGD", x64)
        tr = case_port("flagship", tmp_path, "SGD")
        if x64:
            tr = tr.twin()
        for i, b in enumerate(batches):
            metrics = tr.step(b)
            _rel_close(metrics["total_loss"].numpy(), want[i]["metrics"]["total_loss"],
                       f"step {i} loss", 1e-5 if i == 0 or x64 else 1e-3)
        got = state_dict_to_flax(tr.model.state_dict())
        per, whole = _movement_errors(got, want[-1]["params"], start)
        for k, e in per.items():
            assert e <= (X64_RTOL if x64 else 0.5), f"{k}: moved {e} off JAX's movement"
        assert whole <= (X64_RTOL if x64 else 5e-2), f"the movement {whole} off JAX's"
        _stats_close(got, want[-1]["stats"], X64_RTOL if x64 else STATS_RTOL)


class _Batches:
    """A pipeline of fixed batches (a list, iterated from its start)."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """2 steps, a new trainer resuming from the checkpoint for 2 more, and 4
    straight steps: the same weights, statistics and optimizer state."""
    batches = [_batch(20 + i, (64, 80), (8, 10), 19) for i in range(4)]

    def run(sub, parts):
        _, cfg = _configs(tmp_path / sub, "LightweightOpenpose", (64, 80), (8, 10))
        cfg.train.save_interval = 2
        for n_step, bs in parts:
            tr = Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
            model = tr.train(_Batches(bs), n_step=n_step)
        return tr, model, cfg

    tr_a, a, cfg_a = run("resumed", [(2, batches[:2]), (4, batches[2:])])
    tr_b, b, _ = run("straight", [(4, batches)])
    assert tr_a.ckpt.steps() == [2, 4] and tr_a.optimizer.count == 4
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    for x, y in zip(tr_a.optimizer.mu + tr_a.optimizer.nu,
                    tr_b.optimizer.mu + tr_b.optimizer.nu):
        assert torch.equal(x, y)
    # newest_model.npz: the flat flax layout, loaded by the JAX model.
    npz = os.path.join(cfg_a.model.model_dir, "newest_model.npz")
    tree = load_npz_tree(npz)
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 80, 3)).astype(np.float32)
    want = _lw_vggtiny_j().apply({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                                 jnp.asarray(x), train=False)
    with torch.no_grad():
        got = b.eval()(torch.from_numpy(x))
    for k in ("conf_map", "paf_map"):
        _rel_close(got[k].numpy(), want[k], k, 1e-4)


def test_init_is_the_same_in_any_memory_layout(tmp_path):
    """The card's model is channels-last; its initial weights are the
    CPU's (a generator fills a tensor in memory order)."""
    _, cfg = _configs(tmp_path, "LightweightOpenpose", (64, 80), (8, 10))
    a = Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
    b = Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
    b.model.to(memory_format=torch.channels_last)
    a.init_state()
    b.init_state()
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_jax_npz_loads_into_the_port(tmp_path):
    """The JAX trainer's `save_weights_npz` of a flax init, loaded by the
    port's `load_weights_npz`: every parameter and statistic equal."""
    from hyperpose_tpu.train.checkpoint import save_weights_npz as jax_save
    from hyperpose_torch.train.checkpoint import load_weights_npz, save_weights_npz

    want = case_flat("flagship")
    path = str(tmp_path / "jax.npz")
    jax_save(nest(want), path)
    model = load_weights_npz(_lw_vggtiny_p(), path)
    got = state_dict_to_flax(model.state_dict())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    save_weights_npz(model, str(tmp_path / "port.npz"))
    with np.load(str(tmp_path / "port.npz")) as data:
        assert sorted(data.files) == sorted(want)


def test_pretrained_backbone_graft_matches_jax(tmp_path):
    """`load_pretrained_backbone` against the JAX package's: a pretraining
    npz of VggTiny (its own keys, an extra scale-32 block, one leaf of
    another shape) grafts the same leaves with the same values, and
    `Trainer.init_state` takes it from `<pretrain_model_dir>/newest_VggTiny.npz`."""
    from hyperpose_tpu.train.pretrain import load_pretrained_backbone as jax_graft
    from hyperpose_torch.train.pretrain import load_pretrained_backbone

    flat = case_flat("flagship")
    variables = nest(flat)
    rng = np.random.default_rng(12)
    pre = {}
    for k, v in flat.items():
        coll, first, *rest = k.split("/")
        if first == "backbone":
            pre["/".join([coll, *rest])] = rng.standard_normal(v.shape).astype(np.float32)
    pre["params/block_s32_0/conv/kernel"] = np.ones((3, 3, 384, 384), np.float32)
    pre["params/block_0/conv/kernel"] = np.ones((3, 3, 3, 7), np.float32)   # another shape
    path = str(tmp_path / "newest_VggTiny.npz")
    np.savez(path, **pre)
    want, n_jax = jax_graft(variables, path)
    model = load_flax_weights(_lw_vggtiny_p(), flat)
    n = load_pretrained_backbone(model, path)
    assert n == n_jax == sum(k.split("/")[1] == "backbone" for k in flat) - 1
    got = state_dict_to_flax(model.state_dict())
    for k, w in {**_flat_tree(want["params"], "params"),
                 **_flat_tree(want["batch_stats"], "batch_stats")}.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    _, cfg = _configs(tmp_path, "LightweightOpenpose", (64, 80), (8, 10))
    cfg.pretrain.pretrain_model_dir = str(tmp_path)
    tr = Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
    tr.init_state()
    np.testing.assert_array_equal(
        state_dict_to_flax(tr.model.state_dict())["params/backbone/block_3/conv/kernel"],
        pre["params/block_3/conv/kernel"])


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, cfg = _configs(tmp_path, "LightweightOpenpose", (64, 80), (8, 10))
    cfg.train.sync_type = PC.SYNC.Sync_avg
    with pytest.raises(NotImplementedError, match="Queue 1 #6"):
        Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
    cfg.train.sync_type = PC.SYNC.Sync_sgd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs)
