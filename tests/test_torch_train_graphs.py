"""The training step replayed as CUDA graphs (`hyperpose_torch/train/graphs.py`)
and what it stands on: the optimizer's tensor scalars (`train/optim.py`) and
the in-place BatchNorm statistics (`models/backbones.py`).

On the CPU:
- `Optimizer` with its learning rate and bias corrections as 0-d tensors
  gives bit for bit the parameters, moments and count of the same equations
  with Python numbers (the code before the tensors), over steps that cross
  a `staged_lr_schedule` boundary, in float32 and float64 (the twin's);
- `FlaxBatchNorm2d`'s in-place update gives the statistics of rebinding,
  bit for bit, and the domain-adaptation step still rebinds;
- which trainers and which hooks keep the step eager.

On the card (marker `gpu`, skipped without one; this module imports no JAX,
so there it runs as `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_train_graphs.py -q`): each family's graphed trainer against
an eager one from the same state over 6 steps across a schedule boundary
(losses, parameters, moments and statistics within 1e-6 of each tensor's
largest value: PoseProposal's and PifPaf's targets sum with atomics), a
forward hook seeing each replayed step's own maps, a new optimizer, a loaded
checkpoint and a new batch shape after a capture, and the step's spans.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from torch_train_cases import bbxs_of, crowd_mask, random_people
from hyperpose_torch import Model
from hyperpose_torch import config as PC
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.train import graphs as G
from hyperpose_torch.train import optim as O
from hyperpose_torch.train.trainer import Trainer, make_optimizer, staged_lr_schedule
from hyperpose_torch.utils import tracing

FAMILIES = {  # name -> (model type, backbone, input, keypoint rows)
    "flagship": ("LightweightOpenpose", "Vggtiny", (64, 80), 19),
    "ppn": ("PoseProposal", "Default", (128, 128), 18),
    "pifpaf": ("Pifpaf", "Default", (64, 64), 17),
}
DECAY_EVERY = 3     # the schedule's boundary falls inside the compared steps
RTOL = 1e-6


def _config(tmp, name, dtype="float32", batch=2, accum=1, dmadapt=False):
    model_type, backbone, hw, _ = FAMILIES[name]
    PC.reset()
    PC.set_model_type(PC.MODEL[model_type])
    PC.set_model_backbone(PC.BACKBONE[backbone])
    s = PC.get_config(create_dirs=False).model
    stride = s.hin // s.hout
    PC.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // stride, wout=hw[1] // stride)
    PC.set_compute_dtype(dtype)
    PC.set_batch_size(batch)
    PC.set_grad_accum_steps(accum)
    if dmadapt:
        PC.set_domainadapt_dataset(["unused.jpg"])
    cfg = PC.get_config(create_dirs=False)
    PC.reset()
    cfg.model.model_dir = str(tmp)
    cfg.train.lr_decay_every_step = DECAY_EVERY
    return cfg


def _trainer(cfg, device, graphs=True) -> Trainer:
    tr = Trainer(cfg, Model.get_model(cfg), Model.get_topology(cfg).limbs, device=device)
    tr.init_state()
    if not graphs:
        tr._graphs = None
    return tr


def _batch(cfg, name, seed, b=None) -> dict:
    hw, out_hw = (cfg.model.hin, cfg.model.win), (cfg.model.hout, cfg.model.wout)
    b = b or cfg.train.batch_size
    rows = FAMILIES[name][3]
    kpts, valid = random_people(seed, b, 4, rows, hw)
    if rows == 19:      # the OpenPose family's dead background row
        kpts[:, :, 18], valid[:, :, 18] = -1000.0, False
    rng = np.random.default_rng(seed + 100)
    return {"images": rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8), "kpts": kpts,
            "valid": valid, "mask": crowd_mask(b, out_hw), "bbxs": bbxs_of(kpts, valid)}


@pytest.fixture
def spans():
    tracing.reset()
    tracing.enable()
    yield
    tracing.enable(False)
    tracing.reset()


# -- the optimizer's tensor scalars --------------------------------------------

def _host_scalar_step(opt: O.Optimizer, grads) -> None:
    """`Optimizer.step` as it was with Python numbers for the learning rate
    and the bias corrections (no clipping, decay or MultiSteps)."""
    with torch.no_grad():
        grads = list(grads)
        if opt.kind == "sgd":
            updates = [g.clone() for g in grads]
        elif opt.kind == "rmsprop":
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(opt.nu, O.RMS_DECAY)
            torch._foreach_add_(opt.nu, torch._foreach_mul(sq, 1 - O.RMS_DECAY))
            updates = [torch.rsqrt(n + O.EPS) * g for n, g in zip(opt.nu, grads)]
        else:
            sq = torch._foreach_mul(grads, grads)
            b1, b2 = O.ADAM_B1, O.ADAM_B2
            torch._foreach_mul_(opt.mu, b1)
            torch._foreach_add_(opt.mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(opt.nu, b2)
            torch._foreach_add_(opt.nu, torch._foreach_mul(sq, 1 - b2))
            t, dt = opt.count + 1, opt.mu[0].dtype
            mu_hat = torch._foreach_div(opt.mu, O._bias_correction(b1, t, dt))
            nu_hat = torch._foreach_div(opt.nu, O._bias_correction(b2, t, dt))
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, O.EPS)
            updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -opt.learning_rate)
        torch._foreach_add_(opt.params, updates)
        opt.count += 1


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", O.KINDS)
def test_optimizer_tensor_scalars_equal_host_numbers_bit_for_bit(tmp_path, kind, dtype, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _config(tmp_path, "flagship")
    cfg.train.lr_init = 3e-3
    schedule = staged_lr_schedule(cfg)
    gen = torch.Generator().manual_seed(7)
    shapes = [(3, 4), (5,), (2, 3, 3, 1)]
    start = [torch.randn(s, generator=gen, dtype=dtype).to(device) for s in shapes]
    opts = [O.Optimizer([p.clone() for p in start], kind, schedule) for _ in range(2)]
    for step in range(2 * DECAY_EVERY + 1):
        grads = [torch.randn(s, generator=gen, dtype=dtype).to(device) for s in shapes]
        opts[0].step(grads)
        _host_scalar_step(opts[1], grads)
    assert schedule(0) != schedule(opts[0].count - 1)
    got, want = opts
    assert got.count == want.count == 2 * DECAY_EVERY + 1
    for name in ("params", "mu", "nu"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert torch.equal(a, b), name


def test_optimizer_scalars_live_beside_the_parameters():
    p = [torch.zeros(3, dtype=torch.float64)]
    opt = O.Optimizer(p, "adam", 1e-3)
    assert opt.neg_lr.dtype == torch.float64 and opt.neg_lr.device == p[0].device
    assert [c.dtype for c in opt.bias_corrections] == [torch.float64] * 2
    opt.set_scalars()
    assert float(opt.neg_lr) == -1e-3
    assert [float(c) for c in opt.bias_corrections] == [1 - 0.9, 1 - 0.999]
    assert O.Optimizer(p, "sgd", 1e-3).bias_corrections == ()


# -- BatchNorm's statistics in place --------------------------------------------

@pytest.mark.parametrize("momentum", [0.9, 0.99, 0.999])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batchnorm_in_place_statistics_equal_rebinding(momentum, dtype):
    gen = torch.Generator().manual_seed(3)
    rebind = PB.FlaxBatchNorm2d(6, momentum, dtype=dtype).train()
    with torch.no_grad():
        rebind.running_mean.copy_(torch.randn(6, generator=gen, dtype=dtype))
        rebind.running_var.uniform_(0.5, 1.5, generator=gen)
    in_place = copy.deepcopy(rebind)
    buffers = (in_place.running_mean, in_place.running_var)
    for _ in range(3):
        x = torch.randn(4, 6, 5, 7, generator=gen, dtype=dtype) * 2 + 0.3
        want = rebind(x)
        with PB.batchnorm_stats_in_place():
            got = in_place(x)
        assert torch.equal(got, want)
        assert torch.equal(in_place.running_mean, rebind.running_mean)
        assert torch.equal(in_place.running_var, rebind.running_var)
    assert in_place.running_mean is buffers[0] and in_place.running_var is buffers[1]


def test_domain_adaptation_step_still_rebinds_the_statistics(tmp_path):
    cfg = _config(tmp_path, "flagship", dmadapt=True)
    tr = _trainer(cfg, "cpu")
    tr.init_dmadapt_state()
    bn = next(m for m in tr.model.modules() if isinstance(m, PB.FlaxBatchNorm2d))
    before = bn.running_mean
    unlabeled = np.random.default_rng(2).integers(0, 256, (2, 64, 80, 3), dtype=np.uint8)
    metrics = tr.step(_batch(cfg, "flagship", 1), unlabeled)
    assert np.isfinite(float(metrics["total_loss"])) and np.isfinite(float(metrics["d_loss"]))
    assert bn.running_mean is not before and not torch.equal(bn.running_mean, before)


# -- when the step is graphed -----------------------------------------------------

@pytest.mark.parametrize("change,graphed", [
    ("cpu", False), ("cuda", True), ("sync_mode", False), ("domainadapt", False),
    ("row_shard", False), ("accum_steps", False), ("group", False), ("no_optimizer", False),
])
def test_graphs_apply_to_the_one_process_cuda_step_alone(tmp_path, change, graphed):
    """The rule reads the trainer's own state (faked here on a CPU
    trainer: nothing runs)."""
    tr = _trainer(_config(tmp_path, "flagship", accum=2 if change == "accum_steps" else 1),
                  "cpu")
    if change != "cpu":
        tr.device = torch.device("cuda")
    if change == "sync_mode":
        tr.sync_mode = "sync_avg"
    elif change == "domainadapt":
        tr.domainadapt = True
    elif change == "row_shard":
        tr.row_shard = object()
    elif change == "group":
        tr.group = object()
    elif change == "no_optimizer":
        tr.optimizer = None
    assert G.applies(tr) is graphed


@pytest.mark.parametrize("hook,in_the_way", [
    (None, False), ("forward", False), ("forward_with_kwargs", False), ("forward_pre", True),
    ("submodule_forward", True), ("full_backward", True), ("global_forward", True),
])
def test_hooks_that_keep_the_step_eager(hook, in_the_way):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU())
    noop = lambda *a: None  # noqa: E731
    handle = {
        None: lambda: None,
        "forward": lambda: model.register_forward_hook(noop),
        "forward_with_kwargs": lambda: model.register_forward_hook(noop, with_kwargs=True),
        "forward_pre": lambda: model.register_forward_pre_hook(noop),
        "submodule_forward": lambda: model[0].register_forward_hook(noop),
        "full_backward": lambda: model.register_full_backward_hook(noop),
        "global_forward": lambda: torch.nn.modules.module.register_module_forward_hook(noop),
    }[hook]()
    try:
        assert G.hooks_in_the_way(model) is in_the_way
    finally:
        if handle is not None:
            handle.remove()


def test_cpu_trainer_steps_eager_with_graphed_zero(tmp_path, spans):
    cfg = _config(tmp_path, "flagship")
    tr = _trainer(cfg, "cpu")
    for i in range(3):
        tr.step(_batch(cfg, "flagship", i))
    steps = tracing.spans(name="trainer/step")
    assert [s["counts"] for s in steps] == [{"images": 2, "graphed": 0}] * 3
    assert tr._graphs.graphs is None and tr.optimizer.count == 3


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = det


def _worst(got, want) -> float:
    """The largest gap of two tensors over the largest |value| of `want`."""
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _state_gaps(a: Trainer, b: Trainer) -> dict:
    out = {}
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        if x.is_floating_point():
            out[n] = _worst(x, y)
    for name in ("mu", "nu"):
        for i, (x, y) in enumerate(zip(getattr(a.optimizer, name), getattr(b.optimizer, name))):
            out[f"{name}/{i}"] = _worst(x, y)
    return out


def _step_flags() -> list:
    return [(s["counts"]["graphed"], s["counts"].get("captures", 0))
            for s in tracing.spans(name="trainer/step")]


def _run_pair(a, b, batches, losses=None):
    for batch in batches:
        ma, mb = a.step(batch), b.step(batch)
        assert ma.keys() == mb.keys()
        if losses is not None:
            losses.append({k: _worst(ma[k], mb[k]) for k in ma})


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", [("flagship", "bfloat16"), ("flagship", "float32"),
                                        ("ppn", "bfloat16"), ("pifpaf", "bfloat16")])
def test_graphed_steps_equal_eager_steps(cuda, tmp_path, spans, name, dtype):
    cfg = _config(tmp_path, name, dtype)
    a, b = _trainer(cfg, cuda), _trainer(cfg, cuda, graphs=False)
    losses = []
    _run_pair(a, b, [_batch(cfg, name, i % 3) for i in range(2 * DECAY_EVERY)], losses)
    flags = _step_flags()
    assert flags[0::2] == [(0, 0), (1, 1), (1, 0), (1, 0), (1, 0), (1, 0)]   # a's steps
    assert flags[1::2] == [(0, 0)] * 6                                        # b's
    assert a.optimizer.count == b.optimizer.count == 6
    gaps = _state_gaps(a, b)
    worst_loss = max(v for step in losses for v in step.values())
    print(f"{name} {dtype}: worst loss gap {worst_loss!r}, worst state gap "
          f"{max(gaps.values())!r} ({max(gaps, key=gaps.get)}), bit for bit: "
          f"{worst_loss == 0 and max(gaps.values()) == 0}")
    assert worst_loss <= RTOL
    assert max(gaps.values()) <= RTOL, {k: v for k, v in gaps.items() if v > RTOL}


@pytest.mark.gpu
def test_forward_hook_sees_each_replayed_steps_own_maps(cuda, tmp_path, spans):
    cfg = _config(tmp_path, "flagship", "bfloat16")
    a, b = _trainer(cfg, cuda), _trainer(cfg, cuda, graphs=False)
    seen = {id(a): [], id(b): []}
    for tr in (a, b):
        tr.model.register_forward_hook(
            lambda m, args, out, key=id(tr): seen[key].append(out["conf_map"]))
    _run_pair(a, b, [_batch(cfg, "flagship", i) for i in range(5)])
    assert [f for f, _ in _step_flags()[0::2]] == [0, 1, 1, 1, 1]
    got, want = seen[id(a)], seen[id(b)]
    assert len(got) == len(want) == 5
    assert len({t.data_ptr() for t in got}) == 5          # copies, not the graph's own
    for g, w in zip(got, want):
        assert _worst(g, w) <= RTOL
    assert not torch.equal(got[3], got[4])


@pytest.mark.gpu
def test_new_optimizer_and_loaded_checkpoint_are_seen(cuda, tmp_path, spans):
    cfg = _config(tmp_path, "flagship", "bfloat16")
    a, b = _trainer(cfg, cuda), _trainer(cfg, cuda, graphs=False)
    batches = [_batch(cfg, "flagship", i) for i in range(4)]
    _run_pair(a, b, batches[:1])
    saved = [copy.deepcopy(tr.state_dict(1)) for tr in (a, b)]
    _run_pair(a, b, batches[1:3])                        # a captures, then replays
    for tr in (a, b):
        tr.optimizer = make_optimizer(cfg, tr.params)
    _run_pair(a, b, batches[3:])                         # a captures anew
    for tr, state in zip((a, b), saved):
        tr.load_state_dict(copy.deepcopy(state))
    losses = []
    _run_pair(a, b, batches[1:3], losses)                # a replays on the loaded state
    assert _step_flags()[0::2] == [(0, 0), (1, 1), (1, 0), (1, 1), (1, 0), (1, 0)]
    assert a.optimizer.count == b.optimizer.count == 3
    assert max(v for step in losses for v in step.values()) <= RTOL
    assert max(_state_gaps(a, b).values()) <= RTOL


@pytest.mark.gpu
def test_a_new_batch_shape_captures_anew(cuda, tmp_path, spans):
    cfg = _config(tmp_path, "flagship", "bfloat16")
    a, b = _trainer(cfg, cuda), _trainer(cfg, cuda, graphs=False)
    sizes = [2, 2, 2, 3, 3, 3, 2, 2]
    losses = []
    _run_pair(a, b, [_batch(cfg, "flagship", i, n) for i, n in enumerate(sizes)], losses)
    assert _step_flags()[0::2] == [(0, 0), (1, 1), (1, 0), (0, 0), (1, 1), (1, 0), (1, 1),
                                   (1, 0)]
    assert max(v for step in losses for v in step.values()) <= RTOL
    assert max(_state_gaps(a, b).values()) <= RTOL


@pytest.mark.gpu
def test_replayed_steps_keep_the_phase_spans(cuda, tmp_path, spans):
    cfg = _config(tmp_path, "flagship", "bfloat16")
    tr = _trainer(cfg, cuda)
    for i in range(3):
        tr.step(_batch(cfg, "flagship", i))
    recs = tracing.spans()
    steps = [r for r in recs if r["name"] == "trainer/step"]
    assert [s["counts"] for s in steps] == [{"images": 2, "graphed": 0},
                                            {"images": 2, "graphed": 1, "captures": 1},
                                            {"images": 2, "graphed": 1}]
    for step in steps:
        phases = [r for r in recs if r["parent"] == step["id"]]
        assert [r["name"] for r in phases] == ["trainer/forward", "trainer/loss",
                                               "trainer/backward", "trainer/optimizer"]
        assert all(r["device_ms"] is not None and r["device_ms"] > 0 for r in phases)


@pytest.mark.gpu
def test_a_pre_hook_keeps_its_steps_eager(cuda, tmp_path, spans):
    cfg = _config(tmp_path, "flagship", "bfloat16")
    a, b = _trainer(cfg, cuda), _trainer(cfg, cuda, graphs=False)
    batches = [_batch(cfg, "flagship", i) for i in range(6)]
    losses = []
    _run_pair(a, b, batches[:3], losses)
    handle = a.model.backbone.register_forward_pre_hook(lambda *args: None)
    _run_pair(a, b, batches[3:4], losses)
    handle.remove()
    _run_pair(a, b, batches[4:], losses)
    assert _step_flags()[0::2] == [(0, 0), (1, 1), (1, 0), (0, 0), (1, 1), (1, 0)]
    assert max(v for step in losses for v in step.values()) <= RTOL
    assert max(_state_gaps(a, b).values()) <= RTOL
