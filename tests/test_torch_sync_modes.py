"""Sync_avg and Pair_avg across ranks in the port
(`hyperpose_torch/parallel/sync_modes.py`, `Trainer.step` in a process
group) against the JAX package's `make_local_step_train_fn`, on the CPU.

Four gloo ranks (tests/torch_dist_worker.py, each with a timeout) take two
float64 steps (`Trainer.twin`; step indices 0 and 1, so Pair_avg uses both
its pairings) of the narrow flagship (64x80, Adam, seeded random weights),
each rank on its 2 rows of a global batch of 8; JAX runs its shard_map step
on a 4-device mesh under `jax.enable_x64` with the JAX trainer's loss
(`_family_targets_loss`, no L2 term) and optimizer. After the two steps
the parameters and Adam's moments (rank 0's: Pair_avg leaves the ranks'
weights apart, and JAX returns the first device's) and the BatchNorm
statistics (every rank's) are within 1e-6 of each tensor's max |value|, and
each rank's metrics of each step within 1e-6. Each rank also equals one
process standing for the four (`one_process_sync_modes`) within 1e-9, the
bound the card's ranks are held to in `chip_smoke.py`. Also: at world size 1 every sync type is the
one-process step, bit for bit; Pair_avg refuses an odd world size; the
Sync_avg / Pair_avg step has no L2 term, as JAX's.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from test_torch_train import _batch, _configs, _lw_vggtiny_j, as64
from torch_parity import nest
from hyperpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpose_tpu.parallel.sync_modes import make_local_step_train_fn
from hyperpose_tpu.train import trainer as JTR
from hyperpose_torch.parallel import mesh
from hyperpose_torch.parallel.sync_modes import pair_partner
from hyperpose_torch.utils.topology import COCO_TOPOLOGY
from hyperpose_torch.utils.weights import random_flax_weights

RTOL = 1e-6
ONE_PROCESS_RTOL = 1e-9   # ranks against one process standing for them, float64
HW, OUT_HW, B, WORLD = (64, 80), (8, 10), 8, 4
SPEC = {"model": "flagship", "model_type": "LightweightOpenpose", "hw": list(HW),
        "out_hw": list(OUT_HW), "batch": B, "modes": ["sync_avg", "pair_avg"],
        "rank0_state": True}


def _inputs():
    model, _ = W.make_model("flagship")
    arrays = {f"w/{k}": v for k, v in random_flax_weights(model, 5).items()}
    for i in range(2):
        arrays.update({f"b{i}/{k}": v for k, v in _batch(30 + i, HW, OUT_HW, 19, b=B).items()})
    return arrays


def _flat(tree, pre):
    return {f"{pre}/" + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _adam_state(state):
    """optax's ScaleByAdamState inside a chain's nested state."""
    if hasattr(state, "mu"):
        return state
    for s in state if isinstance(state, tuple) else ():
        found = _adam_state(s)
        if found is not None:
            return found
    return None


def _jax_steps(mode, arrays, tmp):
    """JAX's two steps of `mode`: (flat params, stats, mu, nu after them,
    [each step's metrics])."""
    jcfg, _ = _configs(tmp, "LightweightOpenpose", HW, OUT_HW)
    jm = _lw_vggtiny_j(jnp.float64)
    tl = JTR.Trainer._family_targets_loss(jcfg, jm, np.asarray(COCO_TOPOLOGY.limbs), HW,
                                          OUT_HW)

    def loss_fn(predict, t):
        return tl(predict, t["kpts"], t["valid"], t["mask"], t["bbxs"])

    opt = JTR.make_optimizer(jcfg)
    step = make_local_step_train_fn(jm, loss_fn, opt, jax_make_mesh(n_devices=WORLD), mode,
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
        return (_flat(params, "params"), _flat(stats, "batch_stats"), _flat(adam.mu, "mu"),
                _flat(adam.nu, "nu"), metrics)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sync_modes"))
    arrays = _inputs()
    W.write_inputs(path, SPEC, arrays)
    run = W.start("sync_modes", WORLD, path, timeout=200)
    jax_out = {mode: _jax_steps(mode, arrays, tmp_path_factory.mktemp(mode))
               for mode in SPEC["modes"]}
    outs = W.finish(run)
    one = W.one_process_sync_modes(path, WORLD)
    shutil.rmtree(path, ignore_errors=True)    # float64 states: tens of MB a rank
    return outs, jax_out, one


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("mode", SPEC["modes"])
def test_four_ranks_match_jax_local_steps(ranks, mode):
    outs, jax_out, _ = ranks
    params, stats, mu, nu, metrics = jax_out[mode]
    for r, out in enumerate(outs):
        checks = [(f"{mode}/after/{k}", v) for k, v in stats.items()]
        if r == 0:
            checks += [(f"{mode}/mu/{k.split('/', 1)[1]}", v) for k, v in mu.items()]
            checks += [(f"{mode}/nu/{k.split('/', 1)[1]}", v) for k, v in nu.items()]
            checks += [(f"{mode}/after/{k}", v) for k, v in params.items()]
        for key, want in checks:
            assert out[key].dtype == np.float64, key
            assert _rel(out[key], want) <= RTOL, f"rank {r} {key}: {_rel(out[key], want)}"
        for i, m in enumerate(metrics):
            got = {k.rsplit("/", 1)[1]: float(v) for k, v in out.items()
                   if k.startswith(f"{mode}/step{i}/")}
            # the JAX sync path's loss has no L2 term: no loss_re, pd_loss
            assert sorted(got) == sorted(m) == ["conf_loss", "paf_loss", "total_loss"]
            for k, v in m.items():
                assert abs(got[k] - v) <= RTOL * abs(v), (mode, i, k, got[k], v)


def test_sync_avg_keeps_the_ranks_equal(ranks):
    """Under Sync_avg every rank holds the same weights (each weight's sum
    and sum of squares), statistics and metrics."""
    outs = ranks[0]
    keys = [k for k in outs[0] if k.startswith("sync_avg/") and (
        "/digest/" in k or "/after/batch_stats/" in k or "/step" in k)]
    assert any("/digest/" in k for k in keys)
    for k in keys:
        for out in outs[1:]:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=k)


@pytest.mark.parametrize("mode", SPEC["modes"])
def test_four_ranks_equal_one_process_standing_for_them(ranks, mode):
    """Each gloo rank's metrics and state equal those of
    `torch_dist_worker.one_process_sync_modes` (one process, a trainer a
    rank, the exchange done in place) within ONE_PROCESS_RTOL, the metrics
    within RTOL (float32 losses averaged in another order): the collectives
    sum in another order, nothing else differs."""
    outs, _, one = ranks
    for r, (out, want) in enumerate(zip(outs, one)):
        keys = [k for k in want if k.startswith(mode + "/")]
        assert sorted(keys) == sorted(k for k in out if k.startswith(mode + "/"))
        for k in keys:
            bound = RTOL if "/step" in k else ONE_PROCESS_RTOL
            assert _rel(out[k], np.asarray(want[k], np.float64)) <= bound, (
                f"rank {r} {k}: {_rel(out[k], want[k])}")


def test_pairings_are_jax_s():
    """`pair_partner` is JAX's two involutive pairings (sync_modes.py:55-59):
    (i, i ^ 1) on even steps; (i - 1) for even i, (i + 1) for odd i, mod dp,
    on odd steps; an odd world size raises."""
    for dp in (2, 4, 6, 8):
        even = [(i, i ^ 1) for i in range(dp)]
        odd = [(i, (i + 1) % dp if i % 2 == 1 else (i - 1) % dp) for i in range(dp)]
        for step, pairs in ((0, even), (1, odd), (2, even), (7, odd)):
            for i, j in pairs:
                assert pair_partner(i, dp, step) == j and pair_partner(j, dp, step) == i
    with pytest.raises(ValueError, match="even"):
        pair_partner(0, 3, 0)


def test_trainer_refuses_pair_avg_on_odd_world(tmp_path, monkeypatch):
    from hyperpose_torch.train.trainer import Trainer

    monkeypatch.setattr(mesh, "world_size", lambda: 3)
    model, limbs = W.make_model("flagship")
    cfg = W.port_config(dict(SPEC, batch=6), str(tmp_path), "Pair_avg")
    with pytest.raises(ValueError, match="even"):
        Trainer(cfg, model, limbs, device="cpu")


@pytest.mark.parametrize("sync", ["Sync_avg", "Pair_avg"])
def test_world_of_one_is_the_one_process_step(tmp_path, sync):
    """In a gloo group of one, a Sync_avg / Pair_avg trainer takes the
    one-process Sync_sgd step (L2 included), bit for bit, as the JAX trainer
    does when dp is 1."""
    arrays = _inputs()
    batch = {k[3:]: v for k, v in arrays.items() if k.startswith("b0/")}
    ref = W._trainer(SPEC, arrays, str(tmp_path / "ref"))
    want = ref.step(batch)
    mesh.init_tcp(0, 1, W.free_port(), "gloo", timeout_s=30)
    try:
        tr = W._trainer(SPEC, arrays, str(tmp_path / sync), sync)
        assert tr.world == 1 and tr.sync_mode is None and tr.group is None
        got = tr.step(batch, None, 1)
    finally:
        torch.distributed.destroy_process_group()
    assert sorted(got) == sorted(want) and "loss_re" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, a), b in zip(tr.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), k
