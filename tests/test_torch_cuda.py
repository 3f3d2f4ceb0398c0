"""The port on a CUDA device: each CUDA kernel against its plain PyTorch
version, and the decoder and engine on the card against the port on the CPU.

Every test carries the `gpu` marker and skips without a card. This module
imports no JAX (nor tests/conftest.py's fixtures), so on a machine without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: line_gather exact; peak_topk valid masks exact, xy atol 1e-4, raw
exact (the kernel repeats the plain version's float32 operations in the same
order); decode coords atol 1e-5 and human scores atol 1e-3; the engine's
coords atol 1e-4 (cuDNN and the CPU sum the f32 convs in other orders).
"""
import numpy as np
import pytest
import torch

from torch_parity import FLAGSHIP_NPZ, SYNTH_NPZ, tie_maps
from chip_smoke import TWO_PEOPLE, make_synthetic_maps
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.line_gather import line_gather, line_gather_plain
from hyperpose_torch.ops.kernels.peak_topk import peak_topk, peak_topk_plain
from hyperpose_torch.ops.paf_decode import PafDecoderConfig, paf_decode_batch
from hyperpose_torch.runtime.engine import PoseEngine
from hyperpose_torch.utils.topology import COCO_TOPOLOGY

pytestmark = pytest.mark.gpu
LIMBS = np.asarray(COCO_TOPOLOGY.limbs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _peak_maps(name):
    if name == "ties":
        return tie_maps()
    rng = np.random.default_rng(11)
    if name == "random":
        return rng.uniform(0, 1, (3, 46, 54, 18)).astype(np.float32)
    return make_synthetic_maps(TWO_PEOPLE, LIMBS)[0][None, ..., :18]


@pytest.mark.parametrize("bf16", [True, False])
def test_line_gather_matches_plain(cuda, bf16):
    rng = np.random.default_rng(5)
    b, l, h, w, m = 2, 19, 46, 54, 2560
    planes = torch.from_numpy(
        rng.standard_normal((b, l, 2, h, w)).astype(np.float32)).to(cuda)
    ly = torch.from_numpy(rng.integers(-2, h + 2, (b, l, m)).astype(np.int32)).to(cuda)
    lx = torch.from_numpy(rng.integers(-2, w + 2, (b, l, m)).astype(np.int32)).to(cuda)
    before = line_gather.launches
    got = line_gather(planes, ly, lx, bf16)
    want = line_gather_plain(planes, ly, lx, bf16)
    torch.cuda.synchronize()
    assert line_gather.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("border", ["reflect", "zero"])
@pytest.mark.parametrize("maps", ["painted", "random", "ties"])
def test_peak_topk_matches_plain(cuda, border, maps):
    full = torch.from_numpy(_peak_maps(maps)).to(cuda)
    conf = torch.cat([full, full[..., :1]], dim=-1)[..., :18]  # strided view
    before = peak_topk.launches
    got = peak_topk(conf, 16, 5, 0.75, 0.05, border)
    want = peak_topk_plain(conf, 16, 5, 0.75, 0.05, border)
    torch.cuda.synchronize()
    assert peak_topk.launches == before + 1
    assert torch.equal(got[2] > -5e29, want[2] > -5e29)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4)
    assert torch.equal(got[1], want[1])


def test_kernels_raise_on_what_they_do_not_take(cuda):
    conf = torch.zeros(1, 8, 8, 2, device=cuda)
    with pytest.raises(ValueError):
        peak_topk(conf, k=200)
    with pytest.raises(TypeError):
        peak_topk(conf.double())
    planes = torch.zeros(1, 1, 2, 4, 4, device=cuda)
    idx = torch.zeros(1, 1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        line_gather(planes.double(), idx, idx)
    with pytest.raises(TypeError):
        line_gather(planes, idx.long(), idx)


def test_decode_on_card_matches_cpu(cuda):
    conf, paf = make_synthetic_maps(TWO_PEOPLE, LIMBS)
    conf = np.repeat(conf[None], 2, axis=0)
    paf = np.repeat(paf[None], 2, axis=0)
    cfg = PafDecoderConfig()
    gpu = paf_decode_batch(torch.from_numpy(conf).to(cuda),
                           torch.from_numpy(paf).to(cuda), cfg)
    cpu = paf_decode_batch(torch.from_numpy(conf), torch.from_numpy(paf), cfg)
    assert gpu.valid.sum(dim=1).tolist() == [2, 2]
    assert torch.equal(gpu.valid.cpu(), cpu.valid)
    assert torch.equal(gpu.part_valid.cpu(), cpu.part_valid)
    torch.testing.assert_close(gpu.coords.cpu(), cpu.coords, rtol=0, atol=1e-5)
    torch.testing.assert_close(gpu.scores.cpu(), cpu.scores, rtol=0, atol=1e-3)


def test_engine_on_card_matches_cpu(cuda):
    """f32 with TF32 off: the card and the CPU decode the same skeletons."""
    batch = resize_bilinear(np.load(SYNTH_NPZ)["rgb"], (184, 216))[None]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        eng = PoseEngine(LightWeightOpenPose(), FLAGSHIP_NPZ, input_hw=(184, 216),
                         max_batch_size=1, device=dev)
        d = eng.infer_batch_device(batch)
        out[dev.type] = {f: getattr(d, f).cpu() for f in ("valid", "coords", "scores")}
    assert torch.equal(out["cuda"]["valid"], out["cpu"]["valid"])
    torch.testing.assert_close(out["cuda"]["coords"], out["cpu"]["coords"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"]["scores"], out["cpu"]["scores"],
                               rtol=0, atol=1e-3)
