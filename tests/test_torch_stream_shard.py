"""The port's `ShardedStreamEngine` (`hyperpose_torch/parallel/stream_shard.py`)
across two gloo ranks against the JAX package's on a 4-device mesh and
against one `PoseEngine` on the whole batch, on the CPU.

The flagship checkpoint at 184x216 on 4 frames (the synthetic frame, its
mirror image and two shifts of it): each rank runs its `PoseEngine` step on
its 2 frames and every rank gets the skeletons of all 4 in order, by
`infer_global_batch` and by `infer_local_shard`. Against JAX's
`ShardedStreamEngine` (tests/test_parallel.py's decoder call): `valid` and
`part_valid` equal, scores within 1e-4 and coordinates within 1e-5 (as
tests/test_parallel.py holds JAX's sharded engine to its single-device
one); against the port's own engine on the 4 frames: equal bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from torch_parity import FLAGSHIP_NPZ, SYNTH_NPZ, flagship_flat, nest
from hyperpose_tpu.models.backbones import VggTiny as JVggTiny
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JLW
from hyperpose_tpu.ops.paf_decode import PafDecoderConfig, paf_decode_batch
from hyperpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpose_tpu.parallel.stream_shard import ShardedStreamEngine as JaxSharded
from hyperpose_torch.models.backbones import VggTiny
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.parallel.stream_shard import ShardedStreamEngine, scaling_report
from hyperpose_torch.runtime.engine import PoseEngine

HW = (184, 216)
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


def _frames() -> np.ndarray:
    with np.load(SYNTH_NPZ) as data:
        f = resize_bilinear(data["rgb"], HW)
    return np.stack([f, f[:, ::-1], np.roll(f, 16, axis=1), np.roll(f, -12, axis=0)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream"))
    frames = _frames()
    arrays = {f"w/{k}": v for k, v in flagship_flat().items()}
    arrays["frames"] = frames
    W.write_inputs(path, {"hw": list(HW)}, arrays)
    run = W.start("stream", 2, path)
    one = PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=HW,
                     max_batch_size=4, device="cpu")
    single = {f: getattr(one.infer_batch_device(frames), f).numpy() for f in FIELDS}
    cfg = PafDecoderConfig()

    def decoder_call(out):
        return paf_decode_batch(out["conf_map"].astype(jnp.float32),
                                out["paf_map"].astype(jnp.float32), cfg)

    jeng = JaxSharded(JLW(backbone=JVggTiny, dtype=jnp.float32), nest(flagship_flat()),
                      decoder_call, jax_make_mesh(n_devices=4))
    jout = jeng.infer_global_batch(frames)
    jax_out = {f: np.asarray(getattr(jout, f)) for f in FIELDS}
    return W.finish(run), single, jax_out


def test_every_rank_gets_the_whole_batch_as_one_engine(runs):
    ranks, single, _ = runs
    assert single["valid"].sum() >= 4, "the frames hold people"
    for r, out in enumerate(ranks):
        for tag in ("global", "local"):
            for f in FIELDS:
                got = out[f"{tag}/{f}"]
                assert got.dtype == single[f].dtype and got.shape == single[f].shape, (tag, f)
                np.testing.assert_array_equal(got, single[f], err_msg=f"rank {r} {tag} {f}")


def test_ranks_match_jax_sharded_engine(runs):
    ranks, _, want = runs
    for out in ranks:
        np.testing.assert_array_equal(out["global/valid"], want["valid"])
        np.testing.assert_array_equal(out["global/part_valid"], want["part_valid"])
        np.testing.assert_allclose(out["global/scores"], want["scores"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["global/coords"], want["coords"], rtol=0, atol=1e-5)


def test_mesh_of_the_ranks(runs):
    ranks, _, _ = runs
    for out in ranks:
        assert tuple(out["mesh_shape"]) == (2, 1)
        assert list(out["mesh_dims"]) == ["dp", "sp"]


def test_one_process_and_refusals():
    """With no process group the engine is the one engine; a global batch
    the ranks cannot split, or shards of unequal size, raise."""
    eng = PoseEngine(LightWeightOpenPose(backbone=VggTiny), FLAGSHIP_NPZ, input_hw=(64, 72),
                     max_batch_size=2, device="cpu")
    sharded = ShardedStreamEngine(eng)
    assert sharded.group is None and sharded.ranks == 1
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 72, 3), dtype=np.uint8)
    got, want = sharded.infer_global_batch(frames), eng.infer_batch_device(frames)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="equal-size"):
        sharded.infer_local_shard(frames, global_batch=3)
    assert scaling_report(100.0, 180.0, 2)["efficiency"] == pytest.approx(0.9)
