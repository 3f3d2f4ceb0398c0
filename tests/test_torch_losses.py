"""The port's training losses, optimizers and initialization against the
JAX package's, in float32 on the CPU:

- `openpose_loss`, `pose_proposal_loss`, `pifpaf_loss` (its eight parts)
  and the domain-adaptation `bce_logits` / `discriminator_losses`: each
  value and its gradient with respect to every prediction (`jax.grad`,
  jitted, against autograd) on seeded predictions and the JAX generators'
  targets. Tolerance: |d| <= 1e-5 x max(|value|) per loss and per gradient
  tensor, but 5e-5 for PoseProposal's loss values: JAX's float32 sum of the
  22,032 limb terms of an image is 3.5e-5 off its float64 sum here (the
  port's, 1e-7).
- the optimizers (`train/optim.py` through `train/trainer.py`
  `make_optimizer`) against the JAX package's `make_optimizer` (optax)
  over 5 steps of identical seeded gradients, with the staged schedule
  crossing a boundary: Adam, RMSprop, SGD, global-norm clipping and
  MultiSteps; parameters and every moment within 1e-6 x max(1, |v|).
- flax's initialization (`train/init.py`): the spread of every kernel of
  the full-width flagship within 5% of flax `lecun_normal`'s for the same
  shape, and the constants exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_train_cases import bbxs_of, crowd_mask, random_people
import torch_parity  # noqa: F401  (one thread)
from hyperpose_tpu import config as JC
from hyperpose_tpu.data import targets as JT
from hyperpose_tpu.models import openpose as JO
from hyperpose_tpu.models import pifpaf as JPF
from hyperpose_tpu.models import pose_proposal as JPP
from hyperpose_tpu.train import domainadapt as JDA
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch import config as PC
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models import pifpaf as PPF
from hyperpose_torch.models import pose_proposal as PPP
from hyperpose_torch.train import domainadapt as PDA
from hyperpose_torch.train import trainer as PTR
from hyperpose_torch.train.init import flax_init_
from hyperpose_torch.utils.topology import COCO_TOPOLOGY, PIFPAF_TOPOLOGY, PPN_TOPOLOGY

RTOL = 1e-5


def _close(got, want, name, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max |d| {err} vs max |v| {scale}"


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_tree(tree):
    """A nested dict / list of numpy arrays as leaf tensors needing grad."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch_tree(v) for v in tree]
    return torch.tensor(np.asarray(tree), requires_grad=True)


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_torch_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_torch_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _check_loss_and_grads(jax_loss, port_loss, pred_np, value_rtol=RTOL):
    """jax_loss(pred) / port_loss(pred) -> (total, parts) on the same
    predictions: the total and every part (within `value_rtol`) and
    d total / d prediction."""
    (jt, jparts), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, pred_np))
    pred_t = _torch_tree(pred_np)
    pt, pparts = port_loss(pred_t)
    pt.backward()
    _close(pt.detach().numpy(), jt, "total", value_rtol)
    assert sorted(pparts) == sorted(jparts)
    for k in jparts:
        _close(pparts[k].detach().numpy(), jparts[k], k, value_rtol)
    pleaves = _torch_leaves(pred_t)
    jleaves = _leaves(jgrads)
    assert sorted(pleaves) == sorted(jleaves)
    for k, g in jleaves.items():
        assert np.abs(g).max() > 0, f"no gradient reaches {k}"
        _close(pleaves[k].grad.numpy(), g, f"d/d {k}")


def test_openpose_loss_and_grads_match_jax():
    hw, out_hw, b = (64, 80), (8, 10), 2
    kpts, valid = random_people(3, b, 4, 18, hw)
    tg = JT.openpose_targets(jnp.asarray(kpts), jnp.asarray(valid), COCO_TOPOLOGY.limbs, hw,
                             out_hw)
    conf, paf = np.asarray(tg["conf_map"]), np.asarray(tg["paf_map"])
    mask = crowd_mask(b, out_hw)
    rng = np.random.default_rng(4)
    pred = {"stage_confs": [rng.standard_normal(conf.shape).astype(np.float32) * 0.3
                            for _ in range(2)],
            "stage_pafs": [rng.standard_normal(paf.shape).astype(np.float32) * 0.3
                           for _ in range(2)]}
    _check_loss_and_grads(
        lambda p: JO.openpose_loss(p, conf, paf, mask),
        lambda p: PO.openpose_loss(p, torch.from_numpy(conf), torch.from_numpy(paf),
                                   torch.from_numpy(mask)), pred)


def _ppn_case(seed, hw=(128, 128), out_hw=(4, 4), b=2):
    kpts, valid = random_people(seed, b, 5, 18, hw)
    tg = JT.ppn_targets(jnp.asarray(kpts), jnp.asarray(valid),
                        jnp.asarray(bbxs_of(kpts, valid)), PPN_TOPOLOGY.limbs, hw, out_hw)
    tg = {k: np.asarray(v) for k, v in tg.items()}
    rng = np.random.default_rng(seed + 10)
    pred = {k: rng.uniform(0.02, 0.98, tg["c"].shape).astype(np.float32) for k in "cixywh"}
    pred["e"] = rng.uniform(0.02, 0.98, tg["e"].shape).astype(np.float32)
    return tg, pred


def test_pose_proposal_loss_and_grads_match_jax():
    tg, pred = _ppn_case(5)
    jm = JPP.PoseProposal(hin=128, win=128)
    pm = PPP.PoseProposal(hin=128, win=128)
    tt = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tg.items()}
    _check_loss_and_grads(lambda p: JPP.pose_proposal_loss(jm, p, tg),
                          lambda p: PPP.pose_proposal_loss(pm, p, tt), pred, value_rtol=5e-5)


def test_pose_proposal_loss_weights_follow_the_config():
    """`get_model` hands the config's lambdas to the model the loss reads."""
    from hyperpose_torch import models as PM

    PC.reset()
    PC.set_model_type(PC.MODEL.PoseProposal)
    PC._set("model", "lmd_limb", 0.25)
    m = PM.get_model(PC.get_config(create_dirs=False))
    assert (m.lmd_rsp, m.lmd_iou, m.lmd_coor, m.lmd_size, m.lmd_limb) == (0.25, 1.0, 5.0, 5.0,
                                                                          0.25)
    PC.reset()


@pytest.mark.parametrize("masked", [False, True])
def test_pifpaf_loss_and_grads_match_jax(masked):
    hw, out_hw, b = (96, 112), (12, 14), 2
    kpts, valid = random_people(6, b, 4, 17, hw)
    mask = jnp.asarray(crowd_mask(b, out_hw)) if masked else None
    tg = JT.pifpaf_targets(jnp.asarray(kpts), jnp.asarray(valid), PIFPAF_TOPOLOGY.limbs, hw,
                           out_hw, mask=mask)
    tg = {k: np.asarray(v) for k, v in tg.items()}
    rng = np.random.default_rng(7)
    # Logits beyond the soft clamp and the clip in places, as early training.
    pred = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32) for k, v in tg.items()}
    tt = {k: torch.from_numpy(v) for k, v in tg.items()}
    _check_loss_and_grads(lambda p: JPF.pifpaf_loss(p, tg),
                          lambda p: PPF.pifpaf_loss(p, tt), pred)


@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_bce_focal_and_soft_clamp_match_jax(gamma):
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 5, 7)) * 20).astype(np.float32)
    gt = rng.uniform(0, 1, x.shape).astype(np.float32)
    gt[0, 0] = np.nan
    _close(PPF.soft_clamp(torch.from_numpy(x)).numpy(), JPF.soft_clamp(jnp.asarray(x)),
           "soft_clamp")
    _check_loss_and_grads(lambda p: (JPF.bce_loss(p["x"], gt, gamma), {}),
                          lambda p: (PPF.bce_loss(p["x"], torch.from_numpy(gt), gamma), {}),
                          {"x": x})


def test_discriminator_losses_match_jax():
    rng = np.random.default_rng(9)
    pred = {"l": (rng.standard_normal(6) * 40).astype(np.float32),
            "u": (rng.standard_normal(6) * 2).astype(np.float32)}

    def jloss(p):
        g, d = JDA.discriminator_losses(p["l"], p["u"])
        return g + 3 * d, {"g": g, "d": d}

    def ploss(p):
        g, d = PDA.discriminator_losses(p["l"], p["u"])
        return g + 3 * d, {"g": g, "d": d}

    _check_loss_and_grads(jloss, ploss, pred)


# -- optimizers --------------------------------------------------------------

OPTIMIZERS = {
    "adam": dict(optim="Adam"),
    "rmsprop": dict(optim="RMSprop"),
    "sgd": dict(optim="SGD"),
    "adam_clip": dict(optim="Adam", clip=0.5),             # clips every step
    "sgd_clip_loose": dict(optim="SGD", clip=1e3),        # never clips
    "adam_multisteps": dict(optim="Adam", accum=2, clip=0.5),
    "rmsprop_decay_steps": dict(optim="RMSprop", decay_steps=(1, 3)),
}


def _configs(optim, clip=0.0, accum=1, decay_steps=()):
    out = []
    for C in (JC, PC):
        C.reset()
        C.set_optim_type(C.OPTIM[optim])
        C.set_learning_rate(0.01)
        C.set_lr_decay(2, 0.5)
        C.set_grad_clip_norm(clip)
        if accum > 1:
            C.set_grad_accum_steps(accum)
        cfg = C.get_config(create_dirs=False)
        cfg.train.lr_decay_steps = tuple(decay_steps)
        out.append(cfg)
    return out


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_optax(name):
    jcfg, pcfg = _configs(**OPTIMIZERS[name])
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 3, 4, 5), "b": (5,), "c": (7, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = JTR.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(p, st, g):
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st

    tparams = [torch.tensor(params[k]) for k in sorted(shapes)]
    opt = PTR.make_optimizer(pcfg, tparams)
    for step in range(5):
        grads = {k: (rng.standard_normal(s) * (1 + step)).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in grads.items()})
        opt.step([torch.tensor(grads[k]) for k in sorted(shapes)])
        for k, t in zip(sorted(shapes), tparams):
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")
    # The moments too, after the five steps.
    jl = _leaves(jstate)
    for kind in ("mu", "nu"):
        own = getattr(opt, kind)
        if not own:
            continue
        for k, t in zip(sorted(shapes), own):
            key = [n for n in jl if n.endswith(f"{kind}/{k}") and "acc_grads" not in n]
            assert len(key) == 1, (kind, k, list(jl))
            np.testing.assert_allclose(t.numpy(), jl[key[0]], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {kind} {k}")


def test_staged_schedule_matches_jax():
    for decay_steps in ((), (3, 7)):
        jcfg, pcfg = _configs("Adam", decay_steps=decay_steps)
        js, ps = JTR.staged_lr_schedule(jcfg), PTR.staged_lr_schedule(pcfg)
        for step in range(10):
            assert ps(step) == float(js(jnp.int32(step))), (decay_steps, step)
    assert ps(2) == np.float32(0.01) and ps(3) == np.float32(np.float32(0.01) * np.float32(0.5))


# -- initialization ----------------------------------------------------------

def test_init_matches_flax_spread():
    """Every kernel of the full-width flagship (LightWeightOpenPose on
    VggTiny): its std within 5% of flax `lecun_normal`'s for the same HWIO
    shape (a flax draw 16 times as wide, so the reference's own sampling error is
    small beside the 5%), bounded at 2 standard deviations of the
    untruncated normal; biases and BN shifts 0, BN scales and variances 1,
    means 0."""
    from flax import linen as nn
    from hyperpose_torch.utils.weights import state_dict_to_flax

    model = flax_init_(PO.LightWeightOpenPose(backbone=PB.VggTiny),
                       torch.Generator().manual_seed(0))
    flat = state_dict_to_flax(model.state_dict())
    init = nn.initializers.lecun_normal()
    key = jax.random.PRNGKey(0)
    n_kernels = 0
    for name, w in flat.items():
        leaf = name.rsplit("/", 1)[1]
        if leaf == "kernel":
            key, sub = jax.random.split(key)
            # 16 x the output channels: the same fan-in, 16 x the samples.
            ref = np.asarray(init(sub, (*w.shape[:-1], 16 * w.shape[-1]), jnp.float32))
            fan_in = int(np.prod(w.shape[:-1]))
            assert abs(w.std() / ref.std() - 1) < 0.05, (name, w.std(), ref.std())
            bound = 2 * np.sqrt(1 / fan_in) / 0.87962566103423978
            assert np.abs(w).max() <= bound * (1 + 1e-6), name
            n_kernels += 1
        elif leaf in ("bias", "mean"):
            np.testing.assert_array_equal(w, 0, err_msg=name)
        elif leaf in ("scale", "var"):
            np.testing.assert_array_equal(w, 1, err_msg=name)
    assert n_kernels == 40


def test_init_draws_from_the_generator_and_prelu_is_zero():
    a = flax_init_(PO.OpenPose(n_refinements=1), torch.Generator().manual_seed(3))
    b = flax_init_(PO.OpenPose(n_refinements=1), torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert float(a.init_conf.l0.prelu.alpha.detach().abs().max()) == 0.0
    small = flax_init_(PO.MobilenetSmallOpenpose(), torch.Generator().manual_seed(0))
    sep = small.ref0_conf.l0.sep
    np.testing.assert_allclose(float(sep.dw_kernel.detach().std()), np.sqrt(1 / 49), rtol=0.05)
    assert float(sep.bias.detach().abs().max()) == 0.0
