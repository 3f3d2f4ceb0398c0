"""The port's CLI (`python -m hyperpose_torch.cli`) on the CPU: its flags
against the JAX CLI's, `build_engine` of both CLIs on one npz (the flagship
checkpoint) giving the same humans on the same images, and `main()` in the
operator and stream runtimes and with `--quantize`, as `tests/test_cli.py`
drives the JAX CLI. Tolerance: the two engines' humans equal as sets within
1e-4 (coords and scores, float32: `set_compute_dtype` is forced to float32
for this comparison, since both CLIs serve bf16 by default).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pifpaf_decode import assert_same_humans
from torch_parity import FLAGSHIP_NPZ, synth_frame_rgb
from hyperpose_torch import cli
from hyperpose_torch.ops.image import resize_bilinear

cv2 = pytest.importorskip("cv2")
FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_media")
    rng = np.random.default_rng(0)
    img_dir = root / "imgs"
    img_dir.mkdir()
    for i in range(3):
        cv2.imwrite(str(img_dir / f"f{i}.jpg"), rng.integers(0, 256, (120, 160, 3), np.uint8))
    vid = str(root / "v.mp4")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    for _ in range(10):
        w.write(rng.integers(0, 256, (120, 160, 3), np.uint8))
    w.release()
    return {"imgs": str(img_dir), "video": vid, "root": root}


def test_cli_operator_images(media):
    """Operator runtime over an image directory writes the annotated images
    and returns each image's humans."""
    prefix = str(media["root"] / "op_out")
    out = cli.run(["--source", media["imgs"], "--runtime", "operator", "--w", "112",
                   "--h", "96", "--max_batch_size", "2", "--saving_prefix", prefix,
                   "--device", "cpu"])
    assert len(os.listdir(prefix)) == 3
    assert out["images"] == 3 and len(out["humans"]) == 3
    assert out["engine"].device.type == "cpu"


def test_cli_stream_video(media):
    """Stream runtime: video in, annotated video out, frame count kept;
    `main` is the console entry point (it returns nothing)."""
    prefix = str(media["root"] / "stream_out")
    old = sys.argv
    sys.argv = ["cli", "--source", media["video"], "--runtime", "stream", "--w", "112",
                "--h", "96", "--max_batch_size", "4", "--limit", "8", "--saving_prefix",
                prefix, "--device", "cpu"]
    try:
        assert cli.main() is None
    finally:
        sys.argv = old
    cap = cv2.VideoCapture(prefix + ".mp4")
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 8


def test_cli_quantize_serves_int8(media):
    """`--quantize N` calibrates on the first N frames and serves int8: every
    conv of the default Lightweight-OpenPose (54) is an `Int8Conv2d`."""
    from hyperpose_torch import quant

    out = cli.run(["--source", media["imgs"], "--w", "64", "--h", "64", "--max_batch_size",
                   "2", "--quantize", "2", "--saving_prefix", str(media["root"] / "q_out"),
                   "--device", "cpu"])
    engine = out["engine"]
    assert len(engine.quant_scales) == 54
    assert sum(isinstance(m, quant.Int8Conv2d) for m in engine.model.modules()) == 54
    assert out["images"] == 3


def test_cli_refuses_cuda_without_a_gpu(media, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(["--source", media["imgs"], "--w", "64", "--h", "64"])


def test_cli_flags_match_jax():
    """Every flag of the JAX CLI, with its default, and `--device` (cuda)."""
    from hyperpose_tpu import cli as jcli

    argv = ["--source", "x"]
    old = sys.argv
    sys.argv = ["cli", *argv]
    try:
        want = vars(jcli.parse_args())
    finally:
        sys.argv = old
    got = vars(cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


def _f32(get_config):
    def wrapped(*args, **kwargs):
        cfg = get_config(*args, **kwargs)
        cfg.model.compute_dtype = "float32"
        return cfg
    return wrapped


def test_build_engine_matches_jax(monkeypatch):
    """Both CLIs' `build_engine` on the flagship npz (Lightweight-OpenPose on
    VggTiny) find the same people on the synthetic frame and a random one."""
    import argparse

    from hyperpose_tpu import cli as jcli
    from hyperpose_tpu import config as JConfig
    from hyperpose_torch import config as Config

    monkeypatch.setattr(JConfig, "get_config", _f32(JConfig.get_config))
    monkeypatch.setattr(Config, "get_config", _f32(Config.get_config))
    hw = (128, 152)
    args = argparse.Namespace(
        model="LightweightOpenpose", backbone="Vggtiny", h=hw[0], w=hw[1],
        weights=FLAGSHIP_NPZ, max_batch_size=2, keep_ratio=False, input_format="rgb8",
        device="cpu")
    jeng, jtopo = jcli.build_engine(args)
    teng, ttopo = cli.build_engine(args)
    np.testing.assert_array_equal(ttopo.limbs, jtopo.limbs)
    assert teng.dtype == torch.float32
    rng = np.random.default_rng(5)
    frames = np.stack([resize_bilinear(synth_frame_rgb(), hw),
                       rng.integers(0, 256, (*hw, 3), dtype=np.uint8)])
    d = jeng.infer_batch_device(jnp.asarray(frames))
    want = {f: np.asarray(getattr(d, f)) for f in FIELDS}
    d = teng.infer_batch_device(frames)
    got = {f: getattr(d, f).numpy() for f in FIELDS}
    assert got["valid"][0].sum() == 2, "degenerate decode"
    assert_same_humans(got, want)
