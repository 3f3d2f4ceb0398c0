"""Spatial parallelism in training (`hyperpose_torch/parallel/spatial.py`,
`Trainer` with `spatial_parallel` 2) against one process and against the
JAX package's sharded steps, on the CPU.

gloo ranks (tests/torch_dist_worker.py, each with a timeout; two groups of
ranks started once for the module, each running its cases in turn) take
one Adam step in float64 (`Trainer.twin`), each on its rows of its dp
shard's images, with halo exchanges around every conv and pool, BatchNorm
over every rank, the maps gathered over "sp" and the gradients summed over
"sp" and averaged over "dp":

- the narrow flagship (64x80, batch 4; Lightweight-OpenPose on VggTiny, 32
  channels) at sp = 2 on 2 ranks and at dp = 2 x sp = 2 on 4 ranks: every
  gradient, new statistic, weight and Adam moment within 1e-9 of the
  port's one-process step (`check_ranks_equal_one_process`, the losses
  within 1e-6), and within 1e-6 of JAX's `make_sharded_train_step` on
  `make_mesh(n_devices=2, spatial=2)` and `make_mesh(n_devices=4,
  spatial=2)` under `jax.enable_x64` (optax.sgd(1), so the step returns
  the gradient; the port's L2 gradient 2 wd w taken off the kernels, as
  `test_torch_parallel.py` does at sp = 1);
- at sp = 2, against one process within 1e-9 (gradients and statistics),
  at sizes where every halo fits: PoseProposal on Resnet18 (128x128),
  PifPaf on Resnet50 (64x64, its trunk at stride 16), Lightweight-OpenPose
  on MobilenetDilated (a dilated depthwise conv, halo 2), OpenPose with its
  7x7 stages (halo 3; 96x80, one refinement; no BatchNorm),
  MobileNet-Small OpenPose (7x7 SeparableConvs at stride 4, halo 3, and a
  x2 nearest resize; 32x40, 4 rows of stride 4 a rank), Lightweight-OpenPose
  on the space-to-depth stem `VggTinyS2DStem`, and a domain-adaptation step
  (the discriminator's gradients too);
- Sync_avg at dp = 2 x sp = 2 (2 steps): each dp shard's whole local step
  on each of its sp ranks, the weights exchanged among the ranks of one sp
  index, as JAX's `make_local_step_train_fn` shards images on "dp" alone:
  within 1e-9 of one process standing for the 2 dp ranks
  (`one_process_sync_modes`), and within 1e-6 of JAX's on a (2, 2) mesh
  (the losses, float32 sums, within 1e-5), on the inputs of
  tests/test_torch_sync_modes.py. (Two Adam steps carry
  the float32 casts in both packages' float64 losses into the state, more
  on some data than on others: on batch 4 from seeds 3 and 4 the state lay
  2.8e-5 from JAX's, the ranks still within 1e-9 of one process.)
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_worker as W
from test_torch_parallel import _grads, _rel, check_ranks_equal_one_process
from test_torch_sync_modes import _adam_state, _flat
from test_torch_train import _batch, _configs, _lw_vggtiny_j, as64
from torch_parity import nest
from hyperpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpose_tpu.parallel.sync_modes import make_local_step_train_fn
from hyperpose_tpu.parallel.train_step import make_sharded_train_step
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

JAX_RTOL = 1e-6
# The losses against JAX's: float32 sums of the maps in both packages (README
# "Pretraining, ranks, ..."), here over a dp shard of 4 images, 2.1e-6 apart
# after the first Sync_avg step.
LOSS_JAX_RTOL = 1e-5
HW, OUT_HW, B = (64, 80), (8, 10), 4
FLAGSHIP = {"model": "flagship", "model_type": "LightweightOpenpose", "hw": list(HW),
            "out_hw": list(OUT_HW), "batch": B, "n_parts": 19, "tags": ["f64"],
            "record": ["grads", "params", "stats", "moments"], "spatial": 2}
FEW = {"tags": ["f64"], "record": ["grads", "stats"], "spatial": 2}
TWO = {  # on 2 ranks, sp = 2
    "flagship": FLAGSHIP,
    "ppn": dict(FEW, model="ppn", model_type="PoseProposal", hw=[128, 128], out_hw=[4, 4],
                batch=B, n_parts=18),
    "pifpaf": dict(FEW, model="pifpaf", model_type="Pifpaf", hw=[64, 64], out_hw=[8, 8],
                   batch=2, n_parts=17),
    "lw_mobilenet": dict(FEW, model="lw_mobilenet", model_type="LightweightOpenpose",
                         hw=list(HW), out_hw=list(OUT_HW), batch=2, n_parts=19),
    "openpose": dict(FEW, model="openpose", model_type="Openpose", hw=[96, 80],
                     out_hw=[12, 10], batch=2, n_parts=19),
    "dmadapt": dict(FLAGSHIP, dmadapt=True, record=["grads", "stats"]),
    "mbsmall_openpose": dict(FEW, model="mbsmall_openpose", model_type="MobilenetThinOpenpose",
                             hw=[32, 40], out_hw=[8, 10], batch=2, n_parts=19),
    "lw_s2d": dict(FEW, model="lw_s2d", model_type="LightweightOpenpose", hw=list(HW),
                   out_hw=list(OUT_HW), batch=2, n_parts=19),
}
FOUR = {  # on 4 ranks: dp = 2 x sp = 2
    "flagship_dp2": FLAGSHIP,
    # tests/test_torch_sync_modes.py's inputs (batch 8, seeds 30 and 31)
    "sync_avg": {"model": "flagship", "model_type": "LightweightOpenpose", "hw": list(HW),
                 "out_hw": list(OUT_HW), "batch": 8, "n_parts": 19, "modes": ["sync_avg"],
                 "spatial": 2, "steps": 2, "seed": 30},
}
CASE_OF = {"sync_avg": "sync_modes"}


def _inputs(spec, path):
    model, _ = W.make_model(spec["model"])
    arrays = {f"w/{k}": v for k, v in random_flax_weights(model, 5).items()}
    hw, out_hw = tuple(spec["hw"]), tuple(spec["out_hw"])
    for i in range(spec.get("steps", 1)):
        batch = _batch(spec.get("seed", 3) + i, hw, out_hw, spec["n_parts"], b=spec["batch"])
        arrays.update({f"b{i}/{k}": v for k, v in batch.items()})
    if spec.get("dmadapt"):
        arrays["u0"] = np.random.default_rng(9).integers(0, 256, (spec["batch"], *hw, 3),
                                                         dtype=np.uint8)
    W.write_inputs(path, spec, arrays)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (each rank's outputs, the one-process outputs, inputs)}: the
    two groups of ranks run their cases while this process runs the
    one-process references."""
    groups, cases = {}, {}
    for world, table in ((2, TWO), (4, FOUR)):
        top = str(tmp_path_factory.mktemp(f"spatial{world}"))
        runs_ = []
        for name, spec in table.items():
            path = os.path.join(top, name)
            cases[name] = (path, world, _inputs(spec, path))
            runs_.append([CASE_OF.get(name, "sync_sgd"), path])
        W.write_inputs(top, {"runs": runs_}, {})
        groups[world] = (top, W.start("group", world, top, timeout=300))
    refs = {}
    for name, (path, world, _) in cases.items():
        if name == "sync_avg":
            one = W.one_process_sync_modes(path, 2)      # the 2 dp ranks
            refs[name] = [one[r // 2] for r in range(world)]
        else:
            refs[name] = W.run_case("sync_sgd", path)
    for top, run in groups.values():
        W.finish(run)
    out = {name: (W.read_outputs(path, world), refs[name], arrays)
           for name, (path, world, arrays) in cases.items()}
    for top, _ in groups.values():
        shutil.rmtree(top, ignore_errors=True)    # float64 states: tens of MB a rank
    return out


def test_ranks_form_the_dp_x_sp_mesh(runs):
    """Rank r sits at (r // sp, r % sp) and holds its sp index's rows: 32
    of the 64 at sp = 2, in both groups."""
    for name, world in (("flagship", 2), ("flagship_dp2", 4)):
        ranks, ref, _ = runs[name]
        assert ref["geometry"].tolist() == [1, 1, 0, 0, 0]
        for r, out in enumerate(ranks):
            s = r % 2
            assert out["geometry"].tolist() == [world // 2, 2, s, 32 * s, 32 * (s + 1)], name


@pytest.mark.parametrize("name", sorted(TWO) + ["flagship_dp2"])
def test_sp_ranks_float64_equal_one_process(runs, name):
    ranks, ref, _ = runs[name]
    check_ranks_equal_one_process(ranks, ref, "f64", stats=name != "openpose")
    assert any("/grads/" in k for k in ref)
    if name.startswith("flagship"):
        assert any(k.startswith("f64/mu/") for k in ref)
    if name == "dmadapt":
        assert any("/d_grads/" in k for k in ref)


@pytest.mark.parametrize("name,n_devices", [("flagship", 2), ("flagship_dp2", 4)])
def test_sp_ranks_match_jax_sharded_step(runs, name, n_devices, tmp_path):
    """JAX's GSPMD step on a (n_devices / 2, 2) mesh: the images' rows split
    over "sp"; every target leaf is given a second axis of 2 copies, which
    "sp" splits, and the loss reads the first."""
    ranks, _, arrays = runs[name]
    jcfg, pcfg = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    wd = pcfg.train.weight_decay_factor
    jm = _lw_vggtiny_j(jnp.float64)
    targets_loss = JTR.Trainer._family_targets_loss(jcfg, jm, np.asarray(COCO_TOPOLOGY.limbs),
                                                    HW, OUT_HW)

    def loss_fn(predict, t):
        return targets_loss(predict, t["kpts"][:, 0], t["valid"][:, 0], t["mask"][:, 0],
                            t["bbxs"][:, 0])

    step = make_sharded_train_step(jm, loss_fn, optax.sgd(1.0),
                                   jax_make_mesh(n_devices=n_devices, spatial=2), donate=False)
    w = nest({k[2:]: v for k, v in arrays.items() if k.startswith("w/")})
    b = {k[3:]: v for k, v in arrays.items() if k.startswith("b0/")}
    with jax.enable_x64(True):
        params, stats = as64(w["params"]), as64(w["batch_stats"])
        t = {k: jnp.stack([jnp.asarray(b[k])] * 2, axis=1)
             for k in ("kpts", "valid", "mask", "bbxs")}
        images = jnp.asarray(b["images"], jnp.float64) / 255.0
        new_params, new_stats, _, metrics = step(params, stats, optax.sgd(1.0).init(params),
                                                 images, t)
        before, after = _flat(params, "params"), _flat(new_params, "params")
        jgrads = {k: before[k] - after[k] for k in before}
        jstats = _flat(new_stats, "batch_stats")
        jloss = float(metrics["total_loss"])
    for r, out in enumerate(ranks):
        got = _grads(out, "f64")
        assert sorted(got) == sorted(jgrads)
        for k, g in jgrads.items():
            mine = got[k] - (2 * wd * before[k] if k.endswith("/kernel") else 0.0)
            assert _rel(mine, g) <= JAX_RTOL, f"rank {r} d/d {k}: {_rel(mine, g)}"
        for k, s in jstats.items():
            assert _rel(out[f"f64/after/{k}"], s) <= JAX_RTOL, k
        assert abs(float(out["f64/metrics/pd_loss"]) - jloss) <= JAX_RTOL * abs(jloss)


def test_sync_avg_dp2_sp2_equals_one_process(runs):
    """Each rank (d, s) equals dp rank d of one process standing for the 2
    dp ranks within 1e-9 (the metrics within 1e-6)."""
    ranks, refs, _ = runs["sync_avg"]
    for r, (out, want) in enumerate(zip(ranks, refs)):
        keys = [k for k in want if k.startswith("sync_avg/")]
        assert keys and sorted(keys) == sorted(k for k in out if k.startswith("sync_avg/"))
        for k in keys:
            bound = 1e-6 if "/step" in k else 1e-9
            assert _rel(out[k], np.asarray(want[k], np.float64)) <= bound, (r, k)


def test_sync_avg_dp2_sp2_matches_jax_local_steps(runs, tmp_path):
    ranks, _, arrays = runs["sync_avg"]
    jcfg, _ = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    jm = _lw_vggtiny_j(jnp.float64)
    tl = JTR.Trainer._family_targets_loss(jcfg, jm, np.asarray(COCO_TOPOLOGY.limbs), HW,
                                          OUT_HW)

    def loss_fn(predict, t):
        return tl(predict, t["kpts"], t["valid"], t["mask"], t["bbxs"])

    opt = JTR.make_optimizer(jcfg)
    step = make_local_step_train_fn(jm, loss_fn, opt, jax_make_mesh(n_devices=4, spatial=2),
                                    "sync_avg",
                                    preprocess=lambda im: im.astype(jnp.float64) / 255.0)
    w = nest({k[2:]: v for k, v in arrays.items() if k.startswith("w/")})
    metrics = []
    with jax.enable_x64(True):
        params, stats = as64(w["params"]), as64(w["batch_stats"])
        state = opt.init(params)
        for i in range(2):
            b = {k[3:]: jnp.asarray(v) for k, v in arrays.items() if k.startswith(f"b{i}/")}
            tgt = {k: b[k] for k in ("kpts", "valid", "mask", "bbxs")}
            params, stats, state, m = step(params, stats, state, b["images"], tgt,
                                           jnp.int32(i))
            metrics.append({k: float(v) for k, v in m.items()})
        adam = _adam_state(state)
        want = {**{f"sync_avg/after/{k}": v for k, v in _flat(params, "params").items()},
                **{f"sync_avg/after/{k}": v for k, v in _flat(stats, "batch_stats").items()},
                **{f"sync_avg/mu/{k.split('/', 1)[1]}": v
                   for k, v in _flat(adam.mu, "mu").items()},
                **{f"sync_avg/nu/{k.split('/', 1)[1]}": v
                   for k, v in _flat(adam.nu, "nu").items()}}
    for r, out in enumerate(ranks):
        for k, v in want.items():
            assert _rel(out[k], v) <= JAX_RTOL, f"rank {r} {k}: {_rel(out[k], v)}"
        for i, m in enumerate(metrics):
            for k, v in m.items():
                got = float(out[f"sync_avg/step{i}/{k}"])
                assert abs(got - v) <= LOSS_JAX_RTOL * abs(v), (r, i, k, got, v)
