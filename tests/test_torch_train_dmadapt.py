"""One step of domain adaptation (the narrow flagship of
tests/test_torch_train.py with the discriminator) of the port
(`Trainer.dmadapt_step`) against the JAX package's `_build_dmadapt_step`
body, jitted on one device, from JAX's initial weights and a flax init of
the discriminator (seed 1), on a seeded labeled batch and unlabeled batch.

- In float64 (`Trainer.twin` against the flax modules in float64 under
  `jax.enable_x64`): the loss and its parts (g_loss, d_loss) within 1e-5
  relative, the network's gradients tensor by tensor within 1e-6 in
  relative L2 norm and the discriminator's within 1e-5 (2.6e-6 here: it is
  the small difference of two nearly equal terms, its loss being near
  log 2 at initialization, on the features of the network after its
  update), the new statistics within 1e-6 x max(1, |v|), and both
  networks' weights after the update as in `check_x64_adam` (the
  discriminator's within 1e-2 x lr where its gradient is not rounding:
  1.6e-3 x lr here, from that gradient's 2.6e-6).
- In float32: the loss and parts within 1e-5 relative, the new statistics
  within 3e-5 x max(1, |v|), the network's weights after Adam as the
  flagship step's, and both packages' float32 gradients held to JAX's
  float64 ones, over all the gradients within 5e-2 in relative L2 norm:
  the network's each within 0.1 (here the port's 1.7% over all and 3.3% at
  worst, JAX's 1.2% and 1.9%), the discriminator's each within 0.25 (the
  port's 2.2% and 10.3%, JAX's 1.4% and 8.6%, both worst in `conv0`'s
  bias: a first Adam update moves every weight whose float32 gradient is
  its rounding by up to lr, where float64 leaves it, and the discriminator
  reads the network after that update).
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import optax

from test_torch_train import (
    X64_RTOL, _check_grads, _check_metrics, _check_params, _check_x64_grads, _configs,
    _flat_tree, _jax_args, _lw_vggtiny_j, _lw_vggtiny_p, _port_grads_flax, _port_trainer,
    _stats_close, _x64, as64, case_batch, case_flat, check_x64_adam,
)
from torch_parity import nest
from hyperpose_tpu.train import domainadapt as JDA
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from hyperpose_torch.utils.weights import load_flax_weights, state_dict_to_flax

HW, OUT_HW = (64, 80), (8, 10)
D_X64_RTOL = 1e-5   # the discriminator's float64 gradients (module docstring)


def _jax_dmadapt_step(cfg, jm, limbs, dtype):
    """The JAX trainer's `_build_dmadapt_step` body, jitted on one device,
    with the discriminator and the features in `dtype` (float32 in the
    trainer); it also returns both gradients."""
    targets_loss = JTR.Trainer._family_targets_loss(cfg, jm, limbs, HW, OUT_HW)
    wd, lam = cfg.train.weight_decay_factor, cfg.train.lambda_adapt
    optimizer = JTR.make_optimizer(cfg)
    d_optimizer = optax.adam(JTR.staged_lr_schedule(cfg))
    disc = JDA.Discriminator(dtype=dtype)

    def feats(p, bs, x):
        out = jm.apply({"params": p, "batch_stats": bs}, x, train=False, ret_backbone=True)
        return out["backbone_features"].astype(dtype)

    def step(params, batch_stats, opt_state, d_params, d_opt_state, images, kpts, valid,
             mask, bbxs, unlabeled):
        x_l = images.astype(jm.dtype) / 255.0
        x_u = unlabeled.astype(jm.dtype) / 255.0

        def loss_wrapped(p):
            predict, updates = jm.apply({"params": p, "batch_stats": batch_stats}, x_l,
                                        train=True, mutable=["batch_stats"])
            pd_loss, parts = targets_loss(predict, kpts, valid, mask, bbxs)
            re_loss = JTR.l2_regularization(p, wd)
            u_logits = disc.apply({"params": d_params}, feats(p, batch_stats, x_u))
            g_loss = JDA.bce_logits(u_logits, jnp.ones_like(u_logits))
            parts = dict(parts, loss_re=re_loss, pd_loss=pd_loss, g_loss=g_loss)
            return pd_loss + re_loss + lam * g_loss, (parts, updates["batch_stats"])

        (loss, (parts, new_stats)), grads = jax.value_and_grad(loss_wrapped, has_aux=True)(
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        l_f = jax.lax.stop_gradient(feats(params, new_stats, x_l))
        u_f = jax.lax.stop_gradient(feats(params, new_stats, x_u))

        def d_loss_fn(dp):
            return JDA.discriminator_losses(disc.apply({"params": dp}, l_f),
                                            disc.apply({"params": dp}, u_f))[1]

        d_loss, d_grads = jax.value_and_grad(d_loss_fn)(d_params)
        d_updates, d_opt_state = d_optimizer.update(d_grads, d_opt_state, d_params)
        d_params = optax.apply_updates(d_params, d_updates)
        return (params, new_stats, d_params, dict(parts, total_loss=loss, d_loss=d_loss),
                grads, d_grads)

    return jax.jit(step), optimizer, d_optimizer


@lru_cache(maxsize=None)
def _disc_flat() -> dict:
    """A flax init (PRNGKey(1)) of the discriminator on the flagship's
    backbone features, flat."""
    jm = _lw_vggtiny_j()
    shape = jax.eval_shape(
        lambda v: jm.apply(v, jnp.zeros((1, *HW, 3)), train=False,
                           ret_backbone=True)["backbone_features"],
        nest(case_flat("flagship"))).shape
    v = jax.jit(lambda x: JDA.Discriminator().init(jax.random.PRNGKey(1), x))(jnp.zeros(shape))
    return _flat_tree(v["params"], "params")


def _unlabeled():
    return np.random.default_rng(7).integers(0, 256, (2, *HW, 3), dtype=np.uint8)


@lru_cache(maxsize=None)
def _jax_dmadapt(x64: bool) -> dict:
    """JAX's step, in float32 or float64: the flat params, batch_stats,
    discriminator params and both gradients after it, and its metrics."""
    jcfg, _ = _configs("/nonexistent", "LightweightOpenpose", HW, OUT_HW, dmadapt=True)
    dtype = jnp.float64 if x64 else jnp.float32
    step, opt, d_opt = _jax_dmadapt_step(jcfg, _lw_vggtiny_j(dtype), COCO_TOPOLOGY.limbs,
                                         dtype)
    v, d_params = nest(case_flat("flagship")), nest(_disc_flat())["params"]
    with _x64(x64):
        params, stats = v["params"], v["batch_stats"]
        if x64:
            params, stats, d_params = as64(params), as64(stats), as64(d_params)
        jp, js, jdp, metrics, jg, jdg = step(params, stats, opt.init(params), d_params,
                                             d_opt.init(d_params),
                                             *_jax_args(case_batch("flagship", 2)),
                                             jnp.asarray(_unlabeled()))
        return {"params": _flat_tree(jp, "params"), "stats": _flat_tree(js, "batch_stats"),
                "d_params": _flat_tree(jdp, "params"), "grads": _flat_tree(jg, "params"),
                "d_grads": _flat_tree(jdg, "params"),
                "metrics": {k: np.asarray(m) for k, m in metrics.items()}}


def _port_dmadapt(tmp, x64: bool):
    """The port's step on the same weights and batches (in float64 through
    `Trainer.twin`): (trainer after it, metrics, flat gradients, flat
    discriminator gradients)."""
    _, pcfg = _configs(tmp, "LightweightOpenpose", HW, OUT_HW, dmadapt=True)
    tr = _port_trainer(pcfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, case_flat("flagship"))
    tr.init_dmadapt_state()
    load_flax_weights(tr.discriminator, _disc_flat())
    if x64:
        tr = tr.twin()
    metrics, grads, d_grads = tr.dmadapt_step(case_batch("flagship", 2), _unlabeled())
    d_flat = state_dict_to_flax({n: g for (n, _), g in
                                 zip(tr.discriminator.named_parameters(), d_grads)})
    return tr, {k: v.numpy() for k, v in metrics.items()}, _port_grads_flax(tr, grads), d_flat


def test_dmadapt_step_matches_jax(tmp_path):
    want = _jax_dmadapt(False)
    tr, metrics, _, _ = _port_dmadapt(tmp_path, False)
    _check_metrics(metrics, want["metrics"], 1e-5)
    _stats_close(state_dict_to_flax(tr.model.state_dict()), want["stats"])
    _check_params(state_dict_to_flax(tr.model.state_dict()), want["params"])


def test_dmadapt_float32_gradients_near_jax_float64(tmp_path):
    want, ref = _jax_dmadapt(False), _jax_dmadapt(True)
    _, _, grads, d_grads = _port_dmadapt(tmp_path, False)
    _check_grads(grads, want["grads"], ref["grads"], (5e-2, 5e-2))
    _check_grads(d_grads, want["d_grads"], ref["d_grads"], (5e-2, 5e-2), 0.25)


def test_dmadapt_float64_step_matches_jax_float64(tmp_path):
    want = _jax_dmadapt(True)
    tr, metrics, grads, d_grads = _port_dmadapt(tmp_path, True)
    _check_metrics(metrics, want["metrics"], 1e-5)
    _check_x64_grads(grads, want["grads"])
    _check_x64_grads(d_grads, want["d_grads"], D_X64_RTOL, "d_loss/d")
    _stats_close(state_dict_to_flax(tr.model.state_dict()), want["stats"], X64_RTOL)
    check_x64_adam(state_dict_to_flax(tr.model.state_dict()), want["params"], want["grads"])
    check_x64_adam(state_dict_to_flax(tr.discriminator.state_dict()), want["d_params"],
                   want["d_grads"], 1e-2)

