"""The port's training entry point (`python -m hyperpose_torch.tools.train`)
and end-to-end learning, on the CPU.

- The flags are the JAX package's `train.py` flags and `--device`; a run
  on two synthetic train scenes at 96x112 for two steps writes the
  checkpoint and `newest_model.npz`, which the port's model loads; without
  a GPU `--device cuda` (the default) raises.
- The facade's training half picks what JAX's picks for each family.
- Learning: a port of tests/test_learning.py. Lightweight-OpenPose heads on
  a toy stride-8 backbone overfit one synthetic 5-keypoint chain figure
  with the port's targets, loss, train-mode BatchNorm and Adam, and the
  port's own PAF decoder finds the skeleton from the trained maps: one
  person, every part, each within 5 px of the truth.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from test_learning import CHAIN_TOPOLOGY, GT_KPTS, _render_figure
import torch_parity  # noqa: F401  (one thread)
from hyperpose_torch.data.targets import openpose_targets
from hyperpose_torch.models.backbones import same_pads
from hyperpose_torch.models.openpose import LightWeightOpenPose, openpose_loss
from hyperpose_torch.ops.paf_decode import PafDecoderConfig, paf_decode_batch
from hyperpose_torch.tools import train as train_cli
from hyperpose_torch.train.init import flax_init_
from hyperpose_torch.train.optim import Optimizer
from hyperpose_torch.utils.weights import load_flax_weights

pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flags_are_the_jax_train_flags():
    sys.path.insert(0, REPO)
    import train as jax_train

    old = sys.argv
    sys.argv = ["train.py"]
    try:
        want = vars(jax_train.parse_args())
    finally:
        sys.argv = old
    got = vars(train_cli.parse_args([]))
    assert sorted(got) == sorted(list(want) + ["device"])
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"] == "cuda"


def test_cli_trains_two_steps_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model, cfg = train_cli.run([
        "--synthetic", "--synthetic_train_scenes", "2", "--input_hw", "96x112",
        "--n_step", "2", "--device", "cpu", "--dataset_path", str(tmp_path / "data"),
        "--log_interval", "1"])
    model_dir = cfg.model.model_dir
    assert os.path.isdir(os.path.join(model_dir, "ckpt"))
    assert os.listdir(os.path.join(model_dir, "ckpt")) == ["2.pt"]
    npz = os.path.join(model_dir, "newest_model.npz")
    assert os.path.abspath(model_dir).startswith(str(tmp_path)) and os.path.exists(npz)
    # The default family and backbone of the JAX CLI, trained in float32
    # master weights, load back into a fresh bf16 serving model.
    assert type(model.backbone).__name__ == "MobilenetDilated"
    serving = load_flax_weights(LightWeightOpenPose(dtype=torch.bfloat16), npz)
    assert all(p.dtype == torch.bfloat16 for p in serving.parameters())
    with np.load(npz) as data:
        assert all(np.isfinite(data[k]).all() for k in data.files)


def test_cli_refuses_cuda_without_a_gpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.run(["--n_step", "1"])


class _ToyBackbone(nn.Module):
    """The JAX test's minimal stride-8 stack: three 3x3 stride-2 SAME convs
    with bias (16, 32, 64) and ReLU."""

    out_channels = 64

    def __init__(self, scale_size: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 3
        for i, f in enumerate((16, 32, 64)):
            self.add_module(f"c{i}", nn.Conv2d(cin, f, 3, stride=2, dtype=dtype))
            cin = f

    def forward(self, x):
        for i in range(3):
            x = torch.relu(getattr(self, f"c{i}")(F.pad(x, same_pads(x.shape[-2:], 3, 2))))
        return x


def test_training_learns_decodable_poses():
    hw, out_hw, batch = (128, 128), (16, 16), 2
    images = torch.from_numpy(np.broadcast_to(_render_figure(GT_KPTS, hw),
                                              (batch, *hw, 3)).copy())
    kpts = torch.from_numpy(np.broadcast_to(GT_KPTS, (batch, 1, 5, 2)).copy())
    valid = torch.ones((batch, 1, 5), dtype=torch.bool)
    targets = openpose_targets(kpts, valid, CHAIN_TOPOLOGY.limbs, hw, out_hw, sigma=7.0)
    model = LightWeightOpenPose(backbone=_ToyBackbone, n_confmaps=6, n_pafmaps=8,
                                num_channels=32)
    flax_init_(model, torch.Generator().manual_seed(0)).train()
    params = list(model.parameters())
    opt = Optimizer(params, "adam", lambda step: 2e-3)
    first = loss = None
    for i in range(500):
        loss, _ = openpose_loss(model(images), targets["conf_map"], targets["paf_map"])
        opt.step(torch.autograd.grad(loss, params))
        first = float(loss) if first is None else first
        # Sharp maps matter as much as low loss: the decoder's crit2 margin
        # needs the PAF ridge close to saturation.
        if float(loss) < 0.004 * first and i >= 150:
            break
    assert float(loss) < 0.1 * first, f"training did not converge: {first} -> {float(loss)}"
    with torch.no_grad():
        out = model(images)     # train mode, as the JAX test decodes
    cfg = PafDecoderConfig(n_parts=5, n_limbs=4, max_peaks=8, max_candidates=16,
                           max_humans=4, upsample=2, crit1_thresh=6, label_prop_iters=6)
    dec = paf_decode_batch(out["conf_map"], out["paf_map"], cfg, topology=CHAIN_TOPOLOGY)
    assert bool(dec.valid[0, 0]), "no skeleton decoded from trained predictions"
    assert bool(dec.part_valid[0, 0].all()), f"missing parts: {dec.part_valid[0, 0]}"
    est = dec.coords[0, 0].numpy() * np.array([hw[1], hw[0]], np.float32)
    err = np.linalg.norm(est - GT_KPTS, axis=-1)
    assert (err < 5.0).all(), f"keypoint error px: {err}"
    assert int(dec.valid[0].sum()) == 1


@pytest.mark.parametrize("model_type", ["LightweightOpenpose", "PoseProposal", "Pifpaf"])
def test_facade_training_half_follows_the_config(model_type):
    """`get_loss_fn`, `get_augmentor` and `get_preprocessor` of the port pick
    what the JAX facade picks for each family, with the config's sizes and
    topology (the generators themselves: tests/test_torch_targets.py)."""
    from hyperpose_tpu import config as JC
    from hyperpose_tpu import models as JM
    from hyperpose_torch import config as PC
    from hyperpose_torch import models as PM

    cfgs = []
    for C in (JC, PC):
        C.reset()
        C.set_model_type(C.MODEL[model_type])
        cfgs.append(C.get_config(create_dirs=False))
        C.reset()
    jcfg, pcfg = cfgs
    assert PM.get_loss_fn(pcfg).__name__ == JM.get_loss_fn(jcfg).__name__
    aug_j, aug_p = JM.get_augmentor(jcfg), PM.get_augmentor(pcfg)
    assert (aug_p.hin, aug_p.win) == (aug_j.hin, aug_j.win)
    np.testing.assert_array_equal(aug_p.flip_list, aug_j.flip_list)
    pre_j, pre_p = JM.get_preprocessor(jcfg), PM.get_preprocessor(pcfg)
    assert pre_p.func.__name__ == pre_j.func.__name__
    assert sorted(pre_p.keywords) == sorted(pre_j.keywords)
    for k, v in pre_j.keywords.items():
        np.testing.assert_array_equal(np.asarray(pre_p.keywords[k]), np.asarray(v), err_msg=k)
