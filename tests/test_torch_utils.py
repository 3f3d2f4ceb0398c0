"""The port's last utilities against the JAX package on the CPU: the
training visualizer (`utils/visualize.py`, `models.get_visualizer`,
`Trainer._visualize`), `utils/examine.py` and `utils/tracing.py`
`device_profile`.

- A recording stub in place of the visualizer: the port's trainer hands it
  the same image, name and target maps as the JAX trainer's `_visualize`
  (equal; the targets within 1e-6 of their max), and the network's maps
  within 1e-4 of their max (float32 eval-mode forwards), on the same
  weights and batch. `Trainer.train` calls it every `vis_interval` steps on
  rank 0, and a visualizer that raises does not stop training.
- `Visualizer.visualize_maps` writes its PNG (matplotlib is imported when
  it draws).
- `exam_model_weights`, `exam_npz_dict_weights` and `compare_weights` give
  the JAX package's lists on the same weights.
- `device_profile` writes a Chrome trace of the block.
"""
import json
import os
import shutil

import numpy as np
import pytest

from test_torch_train import _batch, _configs, _lw_vggtiny_j, _lw_vggtiny_p
from torch_parity import nest
from hyperpose_tpu.train import trainer as JTR
from hyperpose_tpu.utils import examine as JE
from hyperpose_torch import models as PM
from hyperpose_torch.train.trainer import Trainer
from hyperpose_torch.utils import examine as PE
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from hyperpose_torch.utils.tracing import device_profile
from hyperpose_torch.utils.visualize import Visualizer
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights, save_flax_npz

HW, OUT_HW = (64, 80), (8, 10)


class Recorder:
    """A visualizer that records what it is handed."""

    def __init__(self, fail=False):
        self.calls, self.fail = [], fail

    def visualize_maps(self, image, conf, paf, name, gt_conf=None, gt_paf=None):
        if self.fail:
            raise RuntimeError("drawing failed")
        self.calls.append({"image": np.asarray(image), "conf": np.asarray(conf),
                           "paf": np.asarray(paf), "name": name,
                           "gt_conf": np.asarray(gt_conf), "gt_paf": np.asarray(gt_paf)})


def _close(got, want, rtol, name):
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, name


def test_visualizer_gets_jax_s_inputs(tmp_path):
    jcfg, pcfg = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    limbs = np.asarray(COCO_TOPOLOGY.limbs)
    tr = Trainer(pcfg, _lw_vggtiny_p(), limbs, device="cpu")
    flat = random_flax_weights(tr.model, 3)
    load_flax_weights(tr.model, flat)
    batch = _batch(4, HW, OUT_HW, 19)
    got, want = Recorder(), Recorder()
    tr._visualize(got, batch, 7)
    v = nest(flat)
    JTR.Trainer(jcfg, _lw_vggtiny_j(), limbs)._visualize(want, batch, v["params"],
                                                         v["batch_stats"], 7)
    (g,), (w,) = got.calls, want.calls
    assert g["name"] == w["name"] == "train_step_7"
    np.testing.assert_array_equal(g["image"], w["image"])
    for k, rtol in (("conf", 1e-4), ("paf", 1e-4), ("gt_conf", 1e-6), ("gt_paf", 1e-6)):
        _close(g[k], w[k], rtol, k)
    assert tr.model.training


def test_train_visualizes_every_interval_and_survives_a_failure(tmp_path):
    _, pcfg = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    pcfg.train.vis_interval = 2
    batches = [_batch(10 + i, HW, OUT_HW, 19) for i in range(4)]
    rec = Recorder()
    Trainer(pcfg, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu").train(
        batches, n_step=4, visualizer=rec)
    assert [c["name"] for c in rec.calls] == ["train_step_2", "train_step_4"]
    _, pcfg2 = _configs(tmp_path / "b", "LightweightOpenpose", HW, OUT_HW)
    pcfg2.train.vis_interval = 1
    tr = Trainer(pcfg2, _lw_vggtiny_p(), COCO_TOPOLOGY.limbs, device="cpu")
    tr.train(batches[:1], n_step=1, visualizer=Recorder(fail=True))
    assert tr.optimizer.count == 1
    shutil.rmtree(tmp_path, ignore_errors=True)   # checkpoints


def test_visualizer_writes_map_png(tmp_path):
    """`get_visualizer` gives a `Visualizer` under the config's vis_dir; its
    map grid is a PNG (with the ground truth row)."""
    pytest.importorskip("matplotlib")
    _, pcfg = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    pcfg.train.vis_dir = str(tmp_path / "vis")
    vis = PM.get_visualizer(pcfg)
    assert isinstance(vis, Visualizer) and vis.save_dir == pcfg.train.vis_dir
    rng = np.random.default_rng(0)
    path = vis.visualize_maps(rng.integers(0, 256, (*HW, 3), dtype=np.uint8),
                              rng.random((*OUT_HW, 19)), rng.random((*OUT_HW, 38)), "step_1",
                              gt_conf=rng.random((*OUT_HW, 19)),
                              gt_paf=rng.random((*OUT_HW, 38)))
    assert path == os.path.join(pcfg.train.vis_dir, "step_1_maps.png")
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_examine_lists_match_jax(tmp_path):
    model = _lw_vggtiny_p()
    flat = random_flax_weights(model, 1)
    load_flax_weights(model, flat)
    v = nest(flat)
    want = JE.exam_model_weights(v, logger=lambda *_: None)
    lines = []
    assert PE.exam_model_weights(model, logger=lines.append) == want
    assert len(lines) == len(want) and lines[0] == f"{want[0][0]}: {want[0][1]}"
    npz = str(tmp_path / "w.npz")
    save_flax_npz(model, npz)
    assert (PE.exam_npz_dict_weights(npz, logger=lambda *_: None)
            == JE.exam_npz_dict_weights(npz, logger=lambda *_: None))
    assert PE.compare_weights(model, npz) == JE.compare_weights(v, npz) == {}
    del flat["params/cpm/end/kernel"]
    flat["params/extra/kernel"] = np.zeros((1, 2), np.float32)
    np.savez(npz, **flat)
    assert PE.compare_weights(model, npz) == JE.compare_weights(v, npz) == {
        "params/cpm/end/kernel": "missing in npz", "params/extra/kernel": "unused npz entry"}


def test_device_profile_writes_a_trace(tmp_path):
    import torch

    with device_profile(str(tmp_path / "prof")) as prof:
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    path = tmp_path / "prof" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()
