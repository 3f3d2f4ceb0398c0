"""CMU OpenPose on VGG19 (`models/openpose.py` `OpenPose`) against the
benchmark's plain reference (`posebench/reference/openpose_vgg19.py`:
float32, no kernels), on the CPU at a small size, and the model's spans:

- the float32 model's maps of every stage equal the reference's to
  float32 rounding; the bf16 model's lie within a limit that conv operands
  rounded to float8 (e4m3) and a network one stage short both exceed;
- one forward under spans records `openpose/backbone`, then
  `openpose/stages` (counts `stages`, `frames`), both inside the engine's
  `engine/network`; with spans off nothing is recorded;
- the closed-form conv counts of the stages (the yardstick of
  `stages_mfu.vgg19`) and of the backbone add up to the count taken from a
  run of the whole reference.

The seeded weights are the benchmark cell's (`posebench/weights.py`, from
`configs/openpose-vgg19.json`): variance-kept kernels, PReLU slopes in
[0.05, 0.5], so the negative branch of every PReLU is used. No JAX here.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_parity import REPO

if REPO not in sys.path:
    sys.path.insert(0, REPO)

from hyperpose_torch.models.openpose import OpenPose  # noqa: E402
from hyperpose_torch.runtime.engine import PoseEngine  # noqa: E402
from hyperpose_torch.utils import tracing  # noqa: E402
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights  # noqa: E402
from posebench import weights as bench_weights  # noqa: E402
from posebench.reference import openpose_vgg19 as ref  # noqa: E402
from posebench.reference import openpose_vgg19_ops  # noqa: E402
from posebench.reference.common import Arith, conv_operations, to_torch  # noqa: E402

B, H, W = 2, 112, 160
# float32 against float32: the same convs in the same order (they read 0 on
# one CPU thread); 1e-5 leaves room for sums another thread count reorders.
F32_TOL = 1e-5
# The bf16 model, at every stage: bf16 reads 0.0052-0.0118 at this size; conv
# operands rounded to float8 e4m3 (the next precision below bf16) read
# 0.062-0.067 on the last stage, a network one stage short 0.94.
BF16_TOL = 0.025


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def case():
    """(flat flax weights, NHWC float32 images in [0, 1], the reference's
    outputs)."""
    with open(os.path.join(REPO, "posebench", "configs", "openpose-vgg19.json")) as f:
        cfg = json.load(f)
    flat = bench_weights.make_weights(cfg["weights"], ref.param_shapes(), 5, "cpu", REPO)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).float() / 255.0
    with torch.no_grad():
        want = ref.forward(to_torch(flat, "cpu"), x, Arith())
    return flat, x, want


def _rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def _stage_errors(out: dict, want: dict) -> list[float]:
    errs = []
    for key in ("stage_confs", "stage_pafs"):
        assert len(out[key]) == len(want[key]) == 6
        errs += [_rel(g, w) for g, w in zip(out[key], want[key])]
    return errs + [_rel(out["conf_map"], want["conf_map"]), _rel(out["paf_map"], want["paf_map"])]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)],
                         ids=["float32", "bfloat16"])
def test_every_stage_matches_the_reference(case, dtype, tol):
    flat, x, want = case
    model = load_flax_weights(OpenPose(dtype=dtype), flat).eval()
    with torch.no_grad():
        out = model(x)
    errs = _stage_errors(out, want)
    assert max(errs) < tol, errs


def test_the_bf16_limit_fails_float8_operands_and_a_stage_short(case):
    flat, x, want = case
    with torch.no_grad():
        fp8 = ref.forward(to_torch(flat, "cpu"), x, Arith(torch.float8_e4m3fn))
    assert _rel(fp8["conf_map"], want["conf_map"]) > BF16_TOL
    assert _rel(fp8["paf_map"], want["paf_map"]) > BF16_TOL
    # A network with four refinement stages on the same weights ends in the
    # fifth stage's maps.
    assert _rel(want["stage_confs"][-2], want["conf_map"]) > BF16_TOL
    assert _rel(want["stage_pafs"][-2], want["paf_map"]) > BF16_TOL


def test_spans_backbone_then_stages_inside_engine_network():
    model = OpenPose()
    eng = PoseEngine(model, random_flax_weights(model, 0), input_hw=(64, 80), max_batch_size=2,
                     device="cpu")
    frames = np.zeros(eng.input_batch_shape(), np.uint8)
    tracing.enable()
    eng.infer_batch_device(frames)
    recs = {}
    for r in tracing.spans():
        recs.setdefault(r["name"], []).append(r)
    assert set(recs) == {"engine/step", "engine/network", "engine/decode", "openpose/backbone",
                         "openpose/stages"}
    (net,), (backbone,), (stages,) = (recs[k] for k in ("engine/network", "openpose/backbone",
                                                        "openpose/stages"))
    assert backbone["parent"] == stages["parent"] == net["id"]
    assert backbone["end_ns"] <= stages["start_ns"]
    assert backbone["counts"] == {} and stages["counts"] == {"stages": 6, "frames": 2}
    assert backbone["device_ms"] is None and stages["device_ms"] is None   # no device wall on the CPU


def test_spans_off_record_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    model = OpenPose()
    with torch.no_grad():
        model(torch.zeros(1, 32, 48, 3))
    assert tracing.spans() == [] and tracing.periods() == [] and tracing.report() == {}


@pytest.mark.parametrize("hw", [(64, 80), (100, 90)], ids=["64x80", "100x90"])
def test_closed_form_counts_add_up_to_the_whole_reference(hw):
    got = openpose_vgg19_ops.stage_operations(*hw) + openpose_vgg19_ops.backbone_operations(*hw)
    assert got == conv_operations(ref.forward, ref.param_shapes(), (1, *hw, 3), "cpu")


def test_the_stage_count_at_the_cell_s_size():
    # 2 * 46 * 82 * (the stages' k^2 * cin * cout, summed): 339.2 GFLOP.
    assert openpose_vgg19_ops.stage_operations(368, 656) == 339_186_930_688
