"""Sync_sgd across ranks in the port (`hyperpose_torch/parallel/`,
`Trainer` in a process group) against one process and against the JAX
package's sharded step, on the CPU.

Two gloo ranks (tests/torch_dist_worker.py, each with a timeout) take one
Adam step, each on its half of the narrow flagship's global batch (64x80,
batch 4: Lightweight-OpenPose on VggTiny, 32 channels, seeded random
weights), with BatchNorm statistics over both ranks and the gradients and
metrics averaged:

- in float64 (`Trainer.twin`), against the port's one-process float64 step
  on the whole batch: every gradient, new statistic, weight and Adam moment
  within 1e-9 of its tensor's max |value| (floored at 1e-6 of the largest
  in its collection: a conv bias before a train-mode BatchNorm, as in
  PoseProposal, has a gradient that is 0 but for rounding), the loss and
  its parts within
  1e-6 (the losses sum float32 casts of the maps in both packages, so two
  half-batch sums average to the whole one's within float32 rounding);
- in float64, against JAX's `make_sharded_train_step` on a 2-device mesh
  under `jax.enable_x64` (optax.sgd(1) so that the step returns the
  gradient as the weights' change; its loss has no L2 term, so the port's
  L2 gradient 2 wd w is taken off the kernels): every gradient, the family
  loss and the new statistics within 1e-6;
- in float32, the ranks' gradients and the one-process float32 step's held
  to the float64 step within PR 14's bounds: 0.1 per tensor and 2e-2 over
  all, in relative L2 (tests/test_torch_train.py `_check_grads`).

One PoseProposal step (128x128) and one domain-adaptation step (the
discriminator's gradients averaged too) are held to one process in float64
the same way (their gradients and statistics). The mesh helpers are checked here, the backend
`init_from_env` picks from the launcher's environment, and the CLI under
`torch.distributed.run` (2 gloo ranks, 2 steps) writes one checkpoint.
"""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from test_torch_train import _batch, _configs, _lw_vggtiny_j, as64, grad_errors
from torch_parity import REPO, nest
from hyperpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpose_tpu.parallel.train_step import make_sharded_train_step
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch.parallel import mesh
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

X64_RTOL = 1e-9          # 2 ranks against one process, float64
LOSS_RTOL = 1e-6         # the losses, formed in float32
JAX_RTOL = 1e-6          # against JAX's sharded step, float64
HW, OUT_HW, B = (64, 80), (8, 10), 4

CASES = {  # name -> spec (PoseProposal and dmadapt: float64, gradients and statistics)
    "flagship": {"model": "flagship", "model_type": "LightweightOpenpose", "hw": HW,
                 "out_hw": OUT_HW, "batch": B, "n_parts": 19},
    "ppn": {"model": "ppn", "model_type": "PoseProposal", "hw": (128, 128), "out_hw": (4, 4),
            "batch": B, "n_parts": 18, "tags": ["f64"], "record": ["grads", "stats"]},
    "dmadapt": {"model": "flagship", "model_type": "LightweightOpenpose", "hw": HW,
                "out_hw": OUT_HW, "batch": B, "n_parts": 19, "dmadapt": True, "tags": ["f64"],
                "record": ["grads", "stats"]},
}


def _inputs(name, path):
    spec = CASES[name]
    model, _ = W.make_model(spec["model"])
    arrays = {f"w/{k}": v for k, v in random_flax_weights(model, 5).items()}
    batch = _batch(3, tuple(spec["hw"]), tuple(spec["out_hw"]), spec["n_parts"], b=B)
    arrays.update({f"b0/{k}": v for k, v in batch.items()})
    if spec.get("dmadapt"):
        arrays["u0"] = np.random.default_rng(9).integers(0, 256, (B, *HW, 3), dtype=np.uint8)
    W.write_inputs(path, {k: list(v) if isinstance(v, tuple) else v for k, v in spec.items()},
                   arrays)
    return arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (the ranks' outputs, the one-process outputs, inputs)}; the
    three cases' ranks run at once, and the one-process runs here
    meanwhile."""
    out = {}
    for name in CASES:
        path = str(tmp_path_factory.mktemp(name))
        arrays = _inputs(name, path)
        out[name] = (path, arrays)
    started = {name: W.start("sync_sgd", 2, path) for name, (path, _) in out.items()}
    refs = {name: W.run_case("sync_sgd", path) for name, (path, _) in out.items()}
    done = {name: (W.finish(started[name]), refs[name], arrays)
            for name, (_, arrays) in out.items()}
    for path, _ in out.values():
        shutil.rmtree(path, ignore_errors=True)    # float64 states: tens of MB a rank
    return done


def _rel(got, want, floor=0.0) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), floor, 1e-30))


def check_ranks_equal_one_process(ranks, ref, tag, rtol=X64_RTOL, stats=True):
    """Every output under `tag` of each rank against the one-process run's
    (module docstring); `stats`: the network has BatchNorm statistics."""
    keys = [k for k in ref if k.startswith(tag + "/") and not k.endswith("/step_s")]
    assert stats == any("/after/batch_stats/" in k for k in keys)
    group_max: dict = {}
    for k in keys:
        g = k.split("/")[1]
        group_max[g] = max(group_max.get(g, 0.0), float(np.abs(ref[k]).max()))
    for r, out in enumerate(ranks):
        assert sorted(k for k in out if k.startswith(tag + "/")
                      and not k.endswith("/step_s")) == sorted(keys)
        for k in keys:
            assert out[k].dtype == ref[k].dtype, k
            tol = LOSS_RTOL if "/metrics/" in k else rtol
            e = _rel(out[k], ref[k], 1e-6 * group_max[k.split("/")[1]])
            assert e <= tol, f"rank {r} {k}: {e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_float64_equal_one_process(runs, name):
    ranks, ref, _ = runs[name]
    check_ranks_equal_one_process(ranks, ref, "f64")
    assert any("/grads/" in k for k in ref)
    if name == "dmadapt":
        assert any("/d_grads/" in k for k in ref)


def _grads(out, tag):
    p = f"{tag}/grads/"
    return {k[len(p):]: v for k, v in out.items() if k.startswith(p)}


def test_two_ranks_float32_near_float64(runs):
    """The ranks' float32 gradients and the one-process float32 ones against
    the one-process float64 step, with PR 14's bounds."""
    ranks, ref, _ = runs["flagship"]
    want = _grads(ref, "f64")
    for got in [_grads(o, "f32") for o in ranks] + [_grads(ref, "f32")]:
        per, whole = grad_errors(got, want)
        assert max(per.values()) <= 0.1, max(per.items(), key=lambda kv: kv[1])
        assert whole <= 2e-2, whole
    for k in ("total_loss", "pd_loss"):
        assert abs(float(ranks[0][f"f32/metrics/{k}"]) - float(ref[f"f64/metrics/{k}"])) \
            <= 1e-5 * abs(float(ref[f"f64/metrics/{k}"]))


def test_two_ranks_match_jax_sharded_step(runs, tmp_path):
    ranks, _, arrays = runs["flagship"]
    jcfg, pcfg = _configs(tmp_path, "LightweightOpenpose", HW, OUT_HW)
    wd = pcfg.train.weight_decay_factor
    limbs = np.asarray(COCO_TOPOLOGY.limbs)
    jm = _lw_vggtiny_j(jnp.float64)
    targets_loss = JTR.Trainer._family_targets_loss(jcfg, jm, limbs, HW, OUT_HW)

    def loss_fn(predict, t):
        return targets_loss(predict, t["kpts"], t["valid"][..., 0], t["mask"],
                            t["bbxs"][..., 0])

    import optax

    step = make_sharded_train_step(jm, loss_fn, optax.sgd(1.0), jax_make_mesh(n_devices=2),
                                   donate=False)
    w = nest({k[2:]: v for k, v in arrays.items() if k.startswith("w/")})
    b = {k[3:]: v for k, v in arrays.items() if k.startswith("b0/")}
    with jax.enable_x64(True):
        params, stats = as64(w["params"]), as64(w["batch_stats"])
        # the host batch as the JAX trainer feeds it (float32 keypoints),
        # every leaf 4-d for the batch sharding P("dp", "sp", None, None)
        t = {"kpts": jnp.asarray(b["kpts"]), "valid": jnp.asarray(b["valid"][..., None]),
             "mask": jnp.asarray(b["mask"]), "bbxs": jnp.asarray(b["bbxs"][..., None])}
        images = jnp.asarray(b["images"], jnp.float64) / 255.0
        new_params, new_stats, _, metrics = step(params, stats, optax.sgd(1.0).init(params),
                                                 images, t)
        flat = lambda tree, pre: {  # noqa: E731
            f"{pre}/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        before, after = flat(params, "params"), flat(new_params, "params")
        jgrads = {k: before[k] - after[k] for k in before}
        jstats = flat(new_stats, "batch_stats")
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


def test_mesh_helpers():
    batch = {"a": np.arange(8).reshape(8, 1), "b": np.arange(16).reshape(8, 2)}
    rows = [mesh.local_rows(batch, r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([r["a"] for r in rows]), batch["a"])
    np.testing.assert_array_equal(rows[2]["b"], batch["b"][4:6])
    with pytest.raises(ValueError):
        mesh.local_rows(batch, 0, 3)
    assert mesh.host_local_batch_size(8) == 8 and not mesh.is_distributed()
    assert mesh.group_size(None) == 1


def test_trainer_refuses_what_a_group_cannot_do(tmp_path, monkeypatch):
    """A world size that does not divide the batch, `n_devices` other than
    the world size, and a world that is not dp x sp with `spatial_parallel`
    2 raise (ROADMAP Queue 3: the JAX trainer takes the largest divisor of
    the batch instead); so does a dp that does not divide the batch. The
    dp x sp trainer that 4 ranks build with `spatial_parallel` 2 is
    tests/test_torch_spatial.py's (`test_ranks_form_the_dp_x_sp_mesh`)."""
    from hyperpose_torch.train.trainer import Trainer

    spec = dict(CASES["flagship"], batch=4)
    model, limbs = W.make_model("flagship")
    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(W.port_config(spec, str(tmp_path)), model, limbs, device="cpu")
    monkeypatch.setattr(mesh, "world_size", lambda: 1)
    cfg = W.port_config(spec, str(tmp_path))
    cfg.train.n_devices = 2
    with pytest.raises(ValueError, match="n_devices"):
        Trainer(cfg, model, limbs, device="cpu")
    cfg = W.port_config(spec, str(tmp_path))
    cfg.train.spatial_parallel = 2
    for world in (1, 3):
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        with pytest.raises(ValueError, match="not dp x sp"):
            Trainer(cfg, model, limbs, device="cpu")
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    cfg.train.batch_size = 3
    with pytest.raises(ValueError, match="not divisible by 2 ranks.*spatial_parallel 2"):
        Trainer(cfg, model, limbs, device="cpu")


@pytest.mark.parametrize("device,env,cards,asked,want", [
    ("cpu", {"WORLD_SIZE": "2"}, 0, None, "gloo"),
    ("cuda", {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 2, None, "nccl"),
    ("cuda", {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 1, None, "gloo"),
    ("cuda", {"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"}, 4, None, "nccl"),
    ("cuda", {"WORLD_SIZE": "2"}, 1, None, "gloo"),
    ("cuda", {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 1, "nccl", "nccl"),
])
def test_init_from_env_picks_the_backend(monkeypatch, device, env, cards, asked, want):
    """Under a launcher, `init_from_env` joins gloo on the CPU; on the card
    NCCL when every local rank has a card of its own (LOCAL_WORLD_SIZE, else
    WORLD_SIZE, against the cards present), else gloo, which takes several
    ranks on one card; a backend named by the caller wins. Each rank takes
    card LOCAL_RANK modulo the cards."""
    for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in dict(env, LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    joined, cards_set = [], []
    monkeypatch.setattr(mesh, "is_distributed", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["init_method"])))
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh.torch.cuda, "set_device", cards_set.append)
    assert mesh.init_from_env(asked, device) is True
    assert joined == [(want, "env://")]
    assert cards_set == ([] if device == "cpu" else [1 % cards])


def test_train_cli_under_torch_distributed_run(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    hyperpose_torch.tools.train --synthetic ... --device cpu` (gloo): 2
    steps, one checkpoint written (by rank 0) and the weights' npz."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(W.free_port()), "-m", "hyperpose_torch.tools.train",
           "--train_type", "Parallel_train", "--sync_type", "Sync_sgd", "--synthetic",
           "--synthetic_train_scenes", "2", "--input_hw", "96x112", "--model_backbone",
           "Vggtiny", "--batch_size", "2", "--n_step", "2", "--compute_dtype", "float32",
           "--device", "cpu"]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    model_dir = tmp_path / "save_dir" / "default_name" / "model_dir"
    assert sorted(os.listdir(model_dir / "ckpt")) == ["2.pt"]
    assert (model_dir / "newest_model.npz").exists()
    shutil.rmtree(tmp_path, ignore_errors=True)
