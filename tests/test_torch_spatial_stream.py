"""Spatial parallelism in serving and its pieces (`hyperpose_torch/parallel/
spatial.py`, `ShardedStreamEngine(engine, spatial=2)`), on the CPU.

- Two gloo ranks (tests/torch_dist_worker.py, with a timeout) split the
  image rows of 4 frames at 184x216 (the flagship checkpoint; 23 rows at
  stride 8 split 12 / 11, so 96 and 88 input rows): each runs the network
  on its rows with the halos, the maps are gathered, each decodes the whole
  maps, and every rank returns the skeletons of the 4 frames, by
  `infer_global_batch` and `infer_local_shard`. Against one engine on the
  same frames: float32 with the plain stem and the fused stem (on
  `conv1_pool`'s plain version), the same people and parts, coordinates and
  scores within 1e-4 (each conv sums the same products, the halo's rows
  beside the rank's own; measured: equal); int8, the
  people found as `chip_smoke.find_people` finds them (an int8 rounding may
  flip where a float differs in its last place, tests/test_torch_quant_engine.py).
- The mesh: rank r of `make_distributed_mesh(2)` sits at (r // 2, r % 2),
  where JAX's `make_mesh(spatial=2)` puts its device r.
- The split: the coarsest grid of each family (8, 16 for PifPaf's trunk, 32
  for PoseProposal's), rows spread over the ranks, the first taking one
  more; a height off that grid raises, and so does a halo wider than a
  neighbour's rows, naming the layer and the rows it needs.
- Each kind of layer row-sharded in one process, the exchange standing in
  for a neighbour: float convs (3x3, dilated, 7x7, 1x1, stride 2), max
  pools, the SAME pads at stride 2, the separable conv, the x2 resize and
  the int8 convs (dense, folded, depthwise, grouped, strided), each a
  rank's rows of the layer on the whole image, bit for bit; an op whose
  rows do not split raises naming its layer, and a network of another
  package (a `model_arch`) is refused.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from chip_smoke import INT8_TOL, find_people
from test_torch_stream_shard import FIELDS, HW, _frames
from torch_parity import flagship_flat
from hyperpose_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models import openpose as PO
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.models.pose_proposal import PoseProposal
from hyperpose_torch.parallel import spatial
from hyperpose_torch.utils.human import SkeletonBatch

FORMS = ("plain", "fused", "int8")
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spatial_stream"))
    frames = _frames()
    arrays = {f"w/{k}": v for k, v in flagship_flat().items()}
    arrays["frames"] = frames
    spec = {"hw": list(HW), "spatial": 2, "forms": list(FORMS)}
    W.write_inputs(path, spec, arrays)
    run = W.start("stream", 2, path, timeout=240)
    one = {}
    for form in FORMS:
        d = W.stream_engine(spec, arrays, form, len(frames), "cpu").infer_batch_device(frames)
        one[form] = {f: getattr(d, f).numpy() for f in FIELDS}
    return W.finish(run), one


def _humans(d: dict) -> list:
    sk = SkeletonBatch(*(d[f] for f in FIELDS))
    return [sk.to_humans(i) for i in range(sk.coords.shape[0])]


@pytest.mark.parametrize("form", FORMS)
def test_row_sharded_stream_finds_one_engines_people(runs, form):
    ranks, one = runs
    want = _humans(one[form])
    assert sum(len(h) for h in want) >= 4, "the frames hold people"
    for r, out in enumerate(ranks):
        for tag in ("global", "local"):
            got = _humans({f: out[f"{form}/{tag}/{f}"] for f in FIELDS})
            for i, (w, g) in enumerate(zip(want, got)):
                assert len(w) == len(g), (r, tag, i)
                if form == "int8":
                    d = find_people(w, g)
                    assert d is not None and d <= INT8_TOL["xy"], (r, tag, i, d)
            if form == "int8":
                continue
            ref = one[form]
            for f in ("valid", "part_valid"):
                np.testing.assert_array_equal(out[f"{form}/{tag}/{f}"], ref[f])
            v = ref["part_valid"]
            for f, mask in (("coords", v), ("part_scores", v), ("scores", ref["valid"])):
                d = np.abs(out[f"{form}/{tag}/{f}"] - ref[f])[mask]
                assert d.max(initial=0.0) <= F32_TOL, (r, tag, f, d.max())


def test_mesh_coordinates_are_jax_s(runs):
    ranks, _ = runs
    jm = jax_make_mesh(n_devices=2, spatial=2)
    for r, out in enumerate(ranks):
        assert out["mesh_shape"].tolist() == [1, 2] == list(jm.devices.shape)
        assert [str(d) for d in out["mesh_dims"]] == list(jm.axis_names)
        assert out["mesh_coords"].tolist() == [r // 2, r % 2]
        assert jm.devices[r // 2, r % 2] == jm.devices.reshape(-1)[r]


def test_row_split():
    assert spatial.split_rows(184, 2, 8) == (0, 96, 184)
    assert spatial.split_rows(368, 2, 16) == (0, 192, 368)
    assert spatial.split_rows(64, 4, 8) == (0, 16, 32, 48, 64)
    with pytest.raises(ValueError, match="multiple of 16"):
        spatial.split_rows(360, 2, 16)
    with pytest.raises(ValueError, match="cannot split"):
        spatial.split_rows(16, 4, 8)
    grids = {"lw": (PO.LightWeightOpenPose(backbone=PB.VggTiny, num_channels=32), 8),
             "small": (PO.MobilenetSmallOpenpose(), 8), "pifpaf": (Pifpaf(), 16),
             "ppn": (PoseProposal(hin=128, win=128), 32)}
    for name, (model, grid) in grids.items():
        assert spatial.row_grid(model, torch.float32, "cpu") == grid, name


def test_halo_wider_than_a_neighbours_rows_raises():
    """OpenPose's 7x7 refinement convs take 3 rows of each neighbour: at 64
    input rows over 4 ranks each holds 2 rows at stride 8. The check runs
    before any exchange, so no process group is needed to see it."""
    model = PO.OpenPose(n_refinements=1)
    shard = spatial.RowShard(None, 1, spatial.split_rows(64, 4, 8),
                             {id(m): n for n, m in model.named_modules()})
    conv = model.ref0_conf.l0.conv
    x = torch.zeros((1, conv.in_channels, 2, 10))
    with spatial.row_sharded(shard), pytest.raises(
            ValueError, match=r"ref0_conf\.l0\.conv \(conv2d\): a halo of 3 rows at stride 8.*"
                              r"at least 3 rows of that layer a rank \(24 input rows\)"):
        conv(x)
    with spatial.row_sharded(shard), pytest.raises(ValueError, match="do not lie on a grid"):
        conv(torch.zeros((1, conv.in_channels, 3, 10)))


# 16 rows over 2 ranks, 8 each; the layers of the row-sharded forward
BOUNDS = (0, 8, 16)


def _int8(cin, cout, groups=1, stride=1):
    from hyperpose_torch import quant

    c = torch.nn.Conv2d(cin, cout, 3, stride=stride, padding=1, groups=groups)
    k = c.weight.detach().permute(2, 3, 1, 0).numpy()
    return quant.Int8Conv2d.from_conv(c, k, c.bias.detach().numpy(), 3.0)


def _layers():
    torch.manual_seed(0)
    sep = PO.SeparableConv(16, 8)
    for p in sep.parameters():
        torch.nn.init.normal_(p)
    return {
        "conv3x3": torch.nn.Conv2d(16, 8, 3, padding=1),
        "dilated": torch.nn.Conv2d(16, 8, 3, padding=2, dilation=2),
        "conv7x7": torch.nn.Conv2d(16, 8, 7, padding=3),
        "conv1x1": torch.nn.Conv2d(16, 8, 1),
        "strided": torch.nn.Conv2d(16, 8, 3, stride=2, padding=1),
        "max_pool3": torch.nn.MaxPool2d(3, 1, 1),
        "max_pool2": torch.nn.MaxPool2d(2, 2),
        "same_convbn": PB.ConvBN(16, 8, stride=2).eval(),
        "same_depthwise": PB.DepthwiseConv(16, stride=2),
        "same_max_pool": PB._stem_pool,
        "separable": sep,
        "upsample": lambda x: PB.jax_resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3])),
        "int8_dense": _int8(16, 8),
        "int8_folded": _int8(3, 8),
        "int8_depthwise": _int8(16, 16, groups=16),
        "int8_grouped": _int8(16, 16, groups=4),
        "int8_strided": _int8(16, 8, stride=2),
    }


def _fake_exchange(full):
    """`spatial._sendrecv` for one layer in one process: a rank receives
    its neighbours' rows of the layer's whole input `full`."""
    def sendrecv(shard, sends, recvs):
        lo, hi = shard.rows
        return [full[:, :, lo - t.shape[2]:lo] if j < shard.index else
                full[:, :, hi:hi + t.shape[2]] for t, j in recvs]
    return sendrecv


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("name", sorted(_layers()))
def test_row_sharded_layer_is_its_rows_of_the_whole_image(name, index, monkeypatch):
    """Each kind of layer of the port's networks, row-sharded (the float
    convs and pools through the torch function mode, the SAME pads at
    stride 2 through `same`, the int8 convs through `window`), on a rank's
    8 of 16 rows with its neighbour's rows as the exchange would bring them:
    that rank's rows of the layer on the whole image, bit for bit."""
    layer = _layers()[name]
    rng = np.random.default_rng(2)
    cin = 3 if name == "int8_folded" else 16
    full = torch.from_numpy(rng.normal(0, 1, (2, cin, 16, 12)).astype(np.float32))
    monkeypatch.setattr(spatial, "_sendrecv", _fake_exchange(full))
    lo, hi = BOUNDS[index], BOUNDS[index + 1]
    with torch.inference_mode():
        want = layer(full)
        with spatial.row_sharded(spatial.RowShard(None, index, BOUNDS)):
            got = layer(full[:, :, lo:hi])
    r = want.shape[2] / 16
    assert torch.equal(got, want[:, :, int(lo * r):int(hi * r)]), name


class _Unsplittable(torch.nn.Module):
    def __init__(self, op):
        super().__init__()
        self.op = op

    def forward(self, x):
        return self.op(x)


@pytest.mark.parametrize("name,op,message", [
    ("valid", torch.nn.Conv2d(4, 4, 3), "only around SAME windows"),
    ("transposed", torch.nn.ConvTranspose2d(4, 4, 2, stride=2), "conv_transpose2d"),
    ("adaptive", torch.nn.AdaptiveAvgPool2d(1), "adaptive_avg_pool2d"),
    ("avg_pool", torch.nn.AvgPool2d(3, 1, 1), "average pool"),
    ("bilinear", torch.nn.Upsample(scale_factor=2, mode="bilinear"), "bilinear"),
    ("indices", torch.nn.MaxPool2d(2, 2, return_indices=True), "indices"),
])
def test_an_op_whose_rows_do_not_split_raises_naming_the_layer(name, op, message):
    """Inside a row-sharded forward an op that would read other ranks'
    rows in a way no halo gives raises before any exchange, naming the
    module that ran it."""
    model = _Unsplittable(op)
    shard = spatial.RowShard(None, 0, BOUNDS, {id(m): n for n, m in model.named_modules()})
    with spatial.row_sharded(shard), pytest.raises(ValueError, match=rf"^op \(.*{message}"):
        model(torch.zeros((1, 4, 8, 6)))


class _UsersNet(torch.nn.Module):
    """A network of the user's own, as a `model_arch` gives it: a plain 3x3
    conv."""

    def __init__(self):
        super().__init__()
        self.conv, self.out_channels = torch.nn.Conv2d(3, 4, 3, padding=1), 4

    def forward(self, x):
        return {"conf": self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)}


@pytest.mark.parametrize("model", [_UsersNet(), torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3)),
                                   PO.LightWeightOpenPose(backbone=lambda **k: _UsersNet())])
def test_a_network_of_another_package_is_refused(model):
    """A model whose class, or any of whose modules' classes, is not the
    port's own may do what no op shows (a mean over the rows): the row
    split refuses it before any process group is asked (the trainer and the
    sharded stream engine shard through `make_shard`)."""
    with pytest.raises(ValueError, match="spatial_parallel 1"):
        spatial.make_shard(model, 64, None, torch.float32, "cpu")
    spatial.check_model(PO.LightWeightOpenPose(backbone=PB.VggTiny, num_channels=32))
