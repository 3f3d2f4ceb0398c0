"""The plain reference against the port, both in float32 on the CPU at a
small size: the networks' maps (the flagship in its plain and fused-stem
stem form as served, OpenPose-VGG19), the decode on the same maps, and the
training steps from a fresh Adam and from a state Adam has moved. These tie the reference to the port where the arithmetic is the
same; on the card the benchmark holds the bf16 program to it."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from tiny import cell, tiny_tree
from posebench import program
from posebench.drivers import serving
from posebench.drivers import train as train_driver


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


def _maps_f32(c, frames, w):
    c.config = {**c.config, "dtype": "float32"}
    eng = program.build_engine(c.config, w, len(frames), "cpu")
    rec = serving.MapRecorder(eng.model)
    d = eng.infer_batch_device(frames)
    return rec.take(), d


@pytest.mark.parametrize("workload", ["lwopenpose-tinyvgg.offline-b32", "openpose-vgg19.live-cams"])
def test_reference_network_and_decode_match_the_port_in_float32(bench, workload):
    torch.set_num_threads(4)
    c = cell(workload, bench)
    w = serving.cell_weights(c, 7, "cpu")
    frames = serving.frame_pool(c, 7, 2)
    (conf, paf), d = _maps_f32(c, frames, w)
    ref_conf, ref_paf = serving.reference_maps(c, w, frames, "cpu")
    assert serving.maps_rel_err(conf, paf, ref_conf, ref_paf) < 2e-5
    dec = serving.decode_program_maps(conf, paf, "cpu")
    got = {f: getattr(d, f).numpy() for f in ("coords", "part_scores", "part_valid", "scores", "valid")}
    # The same arithmetic; a human's score sums its parts in an order the
    # CPU's threads may change, by a few float32 ulps.
    for j in range(len(frames)):
        assert serving.humans_gap(serving.humans_of(got, j), serving.humans_of(dec, j)) < 1e-4


def test_reference_training_steps_match_the_port_in_float32(bench):
    torch.set_num_threads(4)
    c = cell("lwopenpose-tinyvgg.train-b8", bench)
    c.config = {**c.config, "dtype": "float32"}
    from posebench import weights

    w = weights.make_weights(c.config["weights"], c.reference().param_shapes(), 7, "cpu",
                             str(c.root))
    batches = train_driver.train_batches(7, 4, 2, tuple(c.config["input_hw"]))
    tr = program.build_trainer(c.config, w, 2, "cpu", str(bench / "model_dir"))
    first = train_driver.program_steps(tr, batches, 0, 2)
    later = train_driver.program_steps(tr, batches, 2, 2)
    assert later["state"]["count"] == 2
    for prog, state, fed in ((first, None, batches[:2]), (later, later["state"], batches[2:])):
        ref = train_driver.reference_steps(c, w, state, fed, "cpu")
        got = train_driver.compare(prog, ref)
        assert abs(prog["losses"][0] - ref["losses"][0]) <= 1e-6 * abs(ref["losses"][0])
        assert got["maps_rel_err"] < 1e-5 and got["grad_rel_err"] < 1e-4, got
        assert got["update_gap"] < 1e-3, got
