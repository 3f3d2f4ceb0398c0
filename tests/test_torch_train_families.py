"""One training step of the port's other families, and of the flagship in
bfloat16, against the JAX package's (helpers and tolerances:
tests/test_torch_train.py, whose JAX step body these reuse).

- One step of PoseProposal (Resnet18, 128x128) and PifPaf (Resnet50,
  64x64, batch 2), Adam, from the same seeded random weights, as the
  flagship's: in float64 the gradients and new statistics within 1e-6 of
  JAX's float64 step; in float32 the loss and its parts within 1e-4
  relative (PoseProposal's float32 limb sum, see test_torch_losses.py; it
  stays 4.5e-5 apart in the float64 step too, whose losses form in
  float32), the new statistics within 3e-5 x max(1, |v|), both packages'
  float32 gradients held to JAX's float64 ones, and the weights after
  Adam's update as the flagship's.
- bfloat16 compute (autocast on float32 master weights) against JAX's
  bfloat16 model from the same weights: the loss within 2%, and every
  parameter, statistic and optimizer moment of the port float32 after the
  step, although the facade built the model in bfloat16.
"""
import jax.numpy as jnp
import pytest
import torch

from test_torch_train import (
    _configs, _jax_args, _jax_step, _lw_vggtiny_j, _port_trainer, _rel_close, case_batch,
    case_flat, check_float32_grads, check_float64_step, check_step_matches_jax,
)
from torch_parity import nest
from hyperpose_torch import config as PC
from hyperpose_torch.utils.topology import COCO_TOPOLOGY

OTHER = ["ppn", "pifpaf"]


@pytest.mark.parametrize("name", OTHER)
def test_other_family_step_matches_jax(tmp_path, name):
    check_step_matches_jax(name, tmp_path, 1e-4)


@pytest.mark.parametrize("name", OTHER)
def test_other_family_float32_gradients_near_jax_float64(tmp_path, name):
    check_float32_grads(name, tmp_path)


@pytest.mark.parametrize("name", OTHER)
def test_other_family_float64_step_matches_jax_float64(tmp_path, name):
    check_float64_step(name, tmp_path, 1e-4)


def test_bf16_step_trains_float32_weights(tmp_path):
    """The config's bf16: the port's model, built in bf16 by the facade,
    trains float32 master weights under autocast; its loss is within 2% of
    the JAX bf16 model's (a flax module with dtype=bfloat16 and float32
    parameters), from the same weights."""
    from hyperpose_torch import models as PM

    jcfg, pcfg = _configs(tmp_path, "LightweightOpenpose", (64, 80), (8, 10), dtype="bfloat16")
    jstep, jopt = _jax_step(jcfg, _lw_vggtiny_j(jnp.bfloat16), COCO_TOPOLOGY.limbs)
    batch = case_batch("flagship", 3)
    variables = nest(case_flat("flagship"))
    params = variables["params"]
    _, _, _, jmet, _ = jstep(params, variables["batch_stats"], jopt.init(params),
                             *_jax_args(batch))
    pcfg.model.num_channels = 32
    pcfg.model.model_backbone = PC.BACKBONE.Vggtiny
    model = PM.get_model(pcfg)
    assert next(model.parameters()).dtype == torch.bfloat16
    tr = _port_trainer(pcfg, model, COCO_TOPOLOGY.limbs, case_flat("flagship"))
    metrics = tr.step(batch)
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    assert all(b.dtype == torch.float32 for b in tr.model.buffers() if b.is_floating_point())
    assert all(t.dtype == torch.float32 for t in tr.optimizer.mu + tr.optimizer.nu)
    _rel_close(metrics["total_loss"].float().numpy(), jmet["total_loss"], "bf16 loss", 2e-2)
