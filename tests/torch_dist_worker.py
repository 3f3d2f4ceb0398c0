"""Ranks of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_sync_modes.py, test_torch_stream_shard.py, the card tests) and of
`chip_smoke.py`'s parallel phase. Imports no JAX.

    python tests/torch_dist_worker.py CASE RANK WORLD PORT DIR

joins a group of WORLD ranks at tcp://localhost:PORT (the backend in.json's
"backend", gloo by default; its "device", the CPU by default, is where the
ranks compute: every rank on cuda:0 on a one-card machine), reads
DIR/in.npz (weights under "w/", batches under "b<i>/") and DIR/in.json,
runs CASE and writes DIR/out_<RANK>.npz. `launch` (or `start`, then `finish`) starts the
WORLD ranks of a case and waits for them within a timeout, killing every
one when it runs out, so a hung rendezvous fails its test instead of
hanging the suite. `run_case`
also runs a case in the calling process with no group (WORLD 1): the
one-process reference the ranks are held to.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from hyperpose_torch import config as PC  # noqa: E402
from hyperpose_torch.parallel import mesh  # noqa: E402
from hyperpose_torch.utils.weights import load_flax_weights, state_dict_to_flax  # noqa: E402

RANK_TIMEOUT_S = 60       # the group's own timeout for a collective


# -- launching ---------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_inputs(path: str, spec: dict, arrays: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "in.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(path, "in.npz"), **arrays)


def start(case: str, world: int, path: str, timeout: float = 150) -> dict:
    """Start the `world` ranks of `case` (`finish` collects them)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(path, f"log_{r}.txt"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), case, str(r),
                               str(world), str(port), path],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    return {"case": case, "world": world, "path": path, "procs": procs, "logs": logs,
            "timeout": timeout, "deadline": time.monotonic() + timeout}


def finish(run: dict) -> list[dict]:
    """Wait for a `start`ed run until its deadline; returns each rank's
    outputs. Raises with the ranks' output if one fails or the run exceeds
    its time (every rank is killed then)."""
    procs, logs = run["procs"], run["logs"]
    try:
        for p in procs:
            p.wait(timeout=max(run["deadline"] - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
        for p in hung:
            p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode}) ---\n{f.read()[-3000:]}")
        f.close()
    if hung or any(p.returncode for p in procs):
        what = f"timed out after {run['timeout']} s" if hung else "failed"
        raise RuntimeError(f"{run['case']} on {run['world']} ranks {what}:\n" + "\n".join(text))
    outs = []
    for r in range(run["world"]):
        with np.load(os.path.join(run["path"], f"out_{r}.npz")) as data:
            outs.append({k: data[k] for k in data.files})
    return outs


def launch(case: str, world: int, path: str, timeout: float = 150) -> list[dict]:
    """Run `case` on `world` ranks (`start`, then `finish`)."""
    return finish(start(case, world, path, timeout))


def read_outputs(path: str, world: int) -> list[dict]:
    """Each rank's outputs of a case in `path` (a "group" run's)."""
    outs = []
    for r in range(world):
        with np.load(os.path.join(path, f"out_{r}.npz")) as data:
            outs.append({k: data[k] for k in data.files})
    return outs


# -- the cases -------------------------------------------------------------------

def port_config(spec: dict, tmp: str, sync_type: str = "Sync_sgd"):
    """The port's config of a case (tests/test_torch_train.py `_configs`):
    the model type and sizes, Adam at lr 1e-4, float32, the global batch
    size, the sync type, domain adaptation when asked, and in a process
    group spec "spatial" as `spatial_parallel` (one process takes the
    unsharded step)."""
    PC.reset()
    PC.set_model_type(PC.MODEL[spec["model_type"]])
    (h, w), (ho, wo) = spec["hw"], spec["out_hw"]
    PC.set_model_inout(hin=h, win=w, hout=ho, wout=wo)
    PC.set_optim_type(PC.OPTIM.Adam)
    PC.set_compute_dtype("float32")
    PC.set_learning_rate(1e-4)
    PC.set_batch_size(spec["batch"])
    PC.set_kungfu_option(PC.SYNC[sync_type])
    if spec.get("dmadapt"):
        PC.set_domainadapt_dataset(["unused.jpg"])
    PC.set_train_devices(0, spec.get("spatial", 1) if mesh.is_distributed() else 1)
    cfg = PC.get_config(create_dirs=False)
    cfg.model.model_dir = tmp
    PC.reset()
    return cfg


def make_model(name: str):
    """(model, limbs) of a case's network."""
    from hyperpose_torch.models import backbones as PB
    from hyperpose_torch.models import openpose as PO
    from hyperpose_torch.models import pose_proposal as PPP
    from hyperpose_torch.utils.topology import COCO_TOPOLOGY, PPN_TOPOLOGY

    if name == "flagship":      # narrow: 32 channels
        return PO.LightWeightOpenPose(backbone=PB.VggTiny, num_channels=32), COCO_TOPOLOGY.limbs
    if name == "flagship_full":
        return PO.LightWeightOpenPose(backbone=PB.VggTiny), COCO_TOPOLOGY.limbs
    if name == "ppn":
        return PPP.PoseProposal(hin=128, win=128), PPN_TOPOLOGY.limbs
    if name == "pifpaf":
        from hyperpose_torch.models.pifpaf import Pifpaf
        from hyperpose_torch.utils.topology import PIFPAF_TOPOLOGY

        return Pifpaf(hin=64, win=64), PIFPAF_TOPOLOGY.limbs
    if name == "lw_mobilenet":  # MobilenetDilated: a dilated depthwise conv, halo 2
        return PO.LightWeightOpenPose(num_channels=32), COCO_TOPOLOGY.limbs
    if name == "openpose":      # 7x7 stages: halo 3
        return PO.OpenPose(n_refinements=1), COCO_TOPOLOGY.limbs
    if name == "mbsmall_openpose":  # 7x7 SeparableConvs, a x2 resize
        return PO.MobilenetSmallOpenpose(), COCO_TOPOLOGY.limbs
    if name == "lw_s2d":        # the space-to-depth stem
        return (PO.LightWeightOpenPose(backbone=PB.VggTinyS2DStem, num_channels=32),
                COCO_TOPOLOGY.limbs)
    raise KeyError(name)


def _batches(arrays: dict) -> list[dict]:
    out, i = [], 0
    while f"b{i}/images" in arrays:
        out.append({k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"b{i}/")})
        i += 1
    return out


def _device(spec) -> str:
    return spec.get("device", "cpu")


def _trainer(spec, arrays, tmp, sync_type="Sync_sgd"):
    from hyperpose_torch.train.trainer import Trainer, make_optimizer

    cfg = port_config(spec, tmp, sync_type)
    model, limbs = make_model(spec["model"])
    tr = Trainer(cfg, model, limbs, device=_device(spec))
    load_flax_weights(tr.model, {k[2:]: v for k, v in arrays.items() if k.startswith("w/")})
    tr.optimizer = make_optimizer(cfg, tr.params)
    if spec.get("dmadapt"):
        tr.init_dmadapt_state()
    return tr


def _flax_grads(tr, grads) -> dict:
    return state_dict_to_flax({n: g for (n, _), g in zip(tr.model.named_parameters(), grads)})


def _record(out: dict, tag: str, tr, what, metrics=None, grads=None, d_grads=None) -> None:
    """The step's metrics and, as `what` names them, its gradients
    ("grads", the discriminator's too), the weights ("params") and
    statistics ("stats") after it, Adam's moments ("moments"), and each
    weight's sum and sum of squares ("digest"); the tests keep what they
    compare, since float64 copies of a network's state are large."""
    for k, v in (metrics or {}).items():
        out[f"{tag}/metrics/{k}"] = np.asarray(float(v))
    if "grads" in what:
        for k, v in ({} if grads is None else _flax_grads(tr, grads)).items():
            out[f"{tag}/grads/{k}"] = v
        for (n, _), g in zip(tr.discriminator.named_parameters() if d_grads else (),
                             d_grads or ()):
            out[f"{tag}/d_grads/{n}"] = g.detach().cpu().numpy()
    for k, v in state_dict_to_flax(tr.model.state_dict()).items():
        if ("params" if k.startswith("params/") else "stats") in what:
            out[f"{tag}/after/{k}"] = v
        if "digest" in what and k.startswith("params/"):
            out[f"{tag}/digest/{k}"] = np.asarray([v.sum(), (v * v).sum()])
    if "moments" in what:
        names = [n for n, _ in tr.model.named_parameters()]
        for m in ("mu", "nu"):
            for k, v in state_dict_to_flax(dict(zip(names, getattr(tr.optimizer, m)))).items():
                out[f"{tag}/{m}/{k.split('/', 1)[1]}"] = v


def _synced_s(t0: float, spec) -> float:
    if _device(spec) == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def case_sync_sgd(spec, arrays, rank, world, tmp) -> dict:
    """One Sync_sgd step (the float64 twin, then float32; spec "tags" may
    name one) on this rank's rows of the global batch "b0" (and unlabeled
    "u0" with domain adaptation): the averaged gradients and metrics, the
    weights, statistics and Adam moments after the update, and the step's
    synced wall seconds ("<tag>/step_s"); spec "record" names what
    `_record` keeps (gradients, weights and statistics by default). With
    spec "deterministic" cuDNN takes its deterministic algorithms."""
    from hyperpose_torch.parallel.train_step import sync_sgd_loss_and_grads

    torch.backends.cudnn.deterministic = bool(spec.get("deterministic"))
    tr = _trainer(spec, arrays, tmp)
    batch, unl = tr.rank_part(_batches(arrays)[0], arrays.get("u0"), rank)
    tags = spec.get("tags", ["f64", "f32"])
    what = spec.get("record", ["grads", "params", "stats"])
    out = {"geometry": np.asarray([tr.dp, tr.sp, tr.sp_index,
                                   *(tr.row_shard.rows if tr.row_shard else (0, 0))])}
    for tag, t in [(t, tr.twin() if t == "f64" else tr) for t in tags]:
        t0 = time.perf_counter()
        if spec.get("dmadapt"):
            metrics, grads, d_grads = t.dmadapt_step(batch, unl)
            out[f"{tag}/step_s"] = np.asarray(_synced_s(t0, spec))
            _record(out, tag, t, what, metrics, grads, d_grads)
            continue
        metrics, grads = sync_sgd_loss_and_grads(t, batch)
        with t._precision():
            t.optimizer.step(grads)
        out[f"{tag}/step_s"] = np.asarray(_synced_s(t0, spec))
        _record(out, tag, t, what, metrics, grads)
    return out


SYNC_TYPES = {"sync_avg": "Sync_avg", "pair_avg": "Pair_avg", "sync_sgd": "Sync_sgd"}


def _record_modes_state(out: dict, mode: str, tw, rank: int, spec) -> None:
    full = rank == 0 or not spec.get("rank0_state")
    _record(out, mode, tw, ["params", "stats", "moments", "digest"] if full
            else ["stats", "digest"])


def case_sync_modes(spec, arrays, rank, world, tmp) -> dict:
    """For each of `spec["modes"]`: the float64 twin's steps (one a batch,
    step index i) on this rank's rows, in that sync type; the metrics of
    each step and the state after the last: the weights, statistics and
    Adam's moments (the other ranks keep the statistics alone with spec
    "rank0_state"). With spec "deterministic" cuDNN takes its deterministic
    algorithms."""
    torch.backends.cudnn.deterministic = bool(spec.get("deterministic"))
    out = {}
    for mode in spec["modes"]:
        tw = _trainer(spec, arrays, os.path.join(tmp, mode), SYNC_TYPES[mode]).twin()
        for i, b in enumerate(_batches(arrays)):
            metrics = tw.step(tw.rank_part(b, None, rank)[0], None, i)
            for k, v in metrics.items():
                out[f"{mode}/step{i}/{k}"] = np.asarray(float(v))
        _record_modes_state(out, mode, tw, rank, spec)
    return out


@torch.no_grad()
def _mean_over_ranks_(per_rank: list[list[torch.Tensor]]) -> None:
    """Each rank's i-th tensor replaced by the i-th tensors' sum over the
    ranks in rank order, / the ranks (as `mesh.all_reduce_mean_`)."""
    for ts in zip(*per_rank):
        mean = torch.stack(ts).sum(0) / len(ts)
        for t in ts:
            t.copy_(mean)


def one_process_sync_modes(path: str, world: int) -> list[dict]:
    """What `case_sync_modes` gives on each of `world` ranks, computed in
    this one process with no group: one float64 trainer a rank, each on
    its rows (`Trainer.loss_and_grads` without the L2 term, then its
    optimizer's update, as `sync_modes.local_step`), the exchange done in
    place: the mean over the ranks for Sync_avg's weights, and for every
    mode's Adam moments, statistics and metrics; 0.5 * (own + partner's)
    for Pair_avg's weights. The ranks' outputs are held to these on the
    same device."""
    from hyperpose_torch.parallel.sync_modes import (
        _float_buffers, _optimizer_floats, pair_partner,
    )

    with open(os.path.join(path, "in.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(path, "in.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = bool(spec.get("deterministic"))
    outs: list[dict] = [{} for _ in range(world)]
    try:
        for mode in spec["modes"]:
            tws = [_trainer(spec, arrays, os.path.join(path, f"one_{mode}_{r}"),
                            SYNC_TYPES[mode]).twin() for r in range(world)]
            for i, b in enumerate(_batches(arrays)):
                metrics = []
                for r, tw in enumerate(tws):
                    m, grads = tw.loss_and_grads(mesh.local_rows(b, r, world), l2=False)
                    with tw._precision():
                        tw.optimizer.step(grads)
                    metrics.append(m)
                params = [[p.data for p in tw.params] for tw in tws]
                if mode == "sync_avg":
                    _mean_over_ranks_(params)
                else:
                    mixed = [[0.5 * (a + o) for a, o in zip(
                        params[r], params[pair_partner(r, world, i)])] for r in range(world)]
                    with torch.no_grad():
                        for own, new in zip(params, mixed):
                            for t, v in zip(own, new):
                                t.copy_(v)
                _mean_over_ranks_([_optimizer_floats(tw.optimizer) for tw in tws])
                _mean_over_ranks_([_float_buffers(tw.model) for tw in tws])
                for k in sorted(metrics[0]):
                    v = torch.stack([m[k].detach().reshape(()) for m in metrics]).sum() / world
                    for out in outs:
                        out[f"{mode}/step{i}/{k}"] = np.asarray(float(v))
            for r, tw in enumerate(tws):
                _record_modes_state(outs[r], mode, tw, r, spec)
    finally:
        torch.backends.cudnn.deterministic = det
    return outs


def stream_engine(spec, arrays, form: str, batch: int, device: str | None = None):
    """The flagship `PoseEngine` of a stream case on the weights "w/" at
    spec["hw"] (in spec "dtype", float32 by default), batch `batch`, in
    `form`: "plain" (VggTiny), "fused" (`VggTinyFusedStem`, the weights
    remapped) or "int8" (`quant.quantize_engine` of the plain engine,
    calibrated on every frame of "frames"), warmed up."""
    from hyperpose_torch import quant
    from hyperpose_torch.models.backbones import VggTiny, VggTinyFusedStem, remap_vggtiny_to_fused
    from hyperpose_torch.models.openpose import LightWeightOpenPose
    from hyperpose_torch.runtime.engine import PoseEngine

    weights = {k[2:]: v for k, v in arrays.items() if k.startswith("w/")}
    dtype = getattr(torch, spec.get("dtype", "float32"))
    kw = dict(input_hw=tuple(spec["hw"]), max_batch_size=batch,
              device=device or _device(spec))
    if form == "fused":
        engine = PoseEngine(LightWeightOpenPose(backbone=VggTinyFusedStem, dtype=dtype),
                            remap_vggtiny_to_fused(weights), **kw)
    else:
        engine = PoseEngine(LightWeightOpenPose(backbone=VggTiny, dtype=dtype), weights, **kw)
        if form == "int8":
            engine = quant.quantize_engine(engine, [arrays["frames"]])
    engine.warmup()
    return engine


STREAM_KERNELS = ("peak_topk", "limb_scores", "conv1_pool", "int8_conv", "int8_dwconv")


def _stream_counters() -> dict:
    from hyperpose_torch.ops.kernels.conv1_pool import conv1_pool
    from hyperpose_torch.ops.kernels.int8_gemm import int8_conv, int8_dwconv
    from hyperpose_torch.ops.kernels.line_gather import limb_scores
    from hyperpose_torch.ops.kernels.peak_topk import peak_topk

    return {"peak_topk": peak_topk, "limb_scores": limb_scores, "conv1_pool": conv1_pool,
            "int8_conv": int8_conv, "int8_dwconv": int8_dwconv}


def case_stream(spec, arrays, rank, world, tmp) -> dict:
    """`ShardedStreamEngine` (spec "spatial" sp, 1 by default: dp = world /
    sp ranks split the frames) over `stream_engine` in each of spec "forms"
    (outputs prefixed "<form>/"; without "forms", the plain engine,
    unprefixed): the global batch "frames" by `infer_global_batch` (after a
    warm-up, with the kernels' launch counts set to 0 just before and read
    just after, and its synced wall seconds) and by `infer_local_shard`,
    and the ("dp", "sp") mesh's shape."""
    from hyperpose_torch.parallel.stream_shard import ShardedStreamEngine, make_distributed_mesh

    frames = arrays["frames"]
    sp = spec.get("spatial", 1)
    n = frames.shape[0] // (world // sp)
    d = rank // sp
    counters = _stream_counters()
    out = {}
    for form in spec.get("forms", [None]):
        pre = "" if form is None else f"{form}/"
        sharded = ShardedStreamEngine(stream_engine(spec, arrays, form or "plain", n),
                                      spatial=sp)
        sharded.infer_global_batch(frames)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        dec = sharded.infer_global_batch(frames)
        out[f"{pre}global_s"] = np.asarray(_synced_s(t0, spec))
        out.update({f"{pre}launches/{k}": np.asarray(c.launches) for k, c in counters.items()})
        for tag, dec in (("global", dec),
                         ("local", sharded.infer_local_shard(frames[d * n:(d + 1) * n]))):
            for f in ("coords", "part_scores", "part_valid", "scores", "valid"):
                out[f"{pre}{tag}/{f}"] = getattr(dec, f).cpu().numpy()
    if world > 1:
        m = make_distributed_mesh(sp)
        out["mesh_shape"] = np.asarray(m.mesh.shape)
        out["mesh_dims"] = np.asarray(m.mesh_dim_names)
        out["mesh_coords"] = np.asarray(m.get_coordinate())
    return out


def case_group(spec, arrays, rank, world, tmp) -> dict:
    """Each (case, directory) of spec["runs"] in turn on these ranks, each
    writing its outputs to its own directory (one start-up for several
    cases); returns the rank's peak device memory in each case
    ("peak_bytes/<case>", 0 on the CPU), whose memory it frees after it."""
    cuda = _device(spec) == "cuda"
    peaks = {}
    for case, path in spec["runs"]:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out = run_case(case, path, rank, world)
        np.savez(os.path.join(path, f"out_{rank}.npz"), **out)
        del out
        if cuda:
            peaks[f"peak_bytes/{case}"] = np.asarray(torch.cuda.max_memory_allocated())
            torch.cuda.empty_cache()
    return peaks


CASES = {"sync_sgd": case_sync_sgd, "sync_modes": case_sync_modes, "stream": case_stream,
         "group": case_group}


def run_case(case: str, path: str, rank: int = 0, world: int = 1) -> dict:
    with open(os.path.join(path, "in.json")) as f:
        spec = json.load(f)
    with np.load(os.path.join(path, "in.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    tmp = os.path.join(path, f"work_{rank}_{world}")
    return CASES[case](spec, arrays, rank, world, tmp)


def main(argv) -> None:
    case, rank, world, port, path = argv[1], int(argv[2]), int(argv[3]), int(argv[4]), argv[5]
    with open(os.path.join(path, "in.json")) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    if _device(spec) == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh.init_tcp(rank, world, port, spec.get("backend", "gloo"), timeout_s=RANK_TIMEOUT_S)
    try:
        out = run_case(case, path, rank, world)
        np.savez(os.path.join(path, f"out_{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
