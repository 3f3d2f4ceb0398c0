"""The port's serving facade (`hyperpose_torch.config`, `hyperpose_torch.models`
`get_topology` / `get_backbone` / `get_model` / `get_postprocessor` /
`_fused_decode_for`, the backbones it adds: `VggTiny(scale_size=32)`,
`VggTinyS2D`, `BACKBONES`, the `backbone=` of PoseProposal and PifPaf)
against the JAX package's, on the CPU.

Both facades are driven by the same `set_*` calls with
`set_compute_dtype("float32")`; the networks get the same seeded flat weights
(the keys and shapes of a flax `init`, filled by `random_flax_weights`).
Tolerances: every output's max |delta| <= 1e-4 x its max |value| (float32
sums taken in other orders); decodes of painted maps equal (PAF: coordinates
within 1e-5); the fused steps' humans as sets within 1e-5 (PoseProposal) and
1e-4 (PifPaf, `assert_same_humans`).
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_paf_decode import TWO_PEOPLE, make_synthetic_maps
from test_torch_pifpaf import _assert_close, _flax_shapes
from test_torch_pifpaf_decode import assert_same_humans
from torch_parity import REPO, nest
from hyperpose_tpu import config as JConfig
from hyperpose_tpu import models as JModel
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models.pifpaf import Pifpaf as JaxPifpaf
from hyperpose_torch import Config, Model
from hyperpose_torch.models import backbones as PB
from hyperpose_torch.models.pifpaf import Pifpaf
from hyperpose_torch.utils.weights import load_flax_weights, random_flax_weights, state_dict_to_flax

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")


@pytest.fixture(autouse=True)
def _reset_configs():
    JConfig.reset()
    Config.reset()
    yield
    JConfig.reset()
    Config.reset()


def _configs(model: str, backbone: str = "Default", hw=(64, 64), stride=8, **sets):
    """The same configuration in both packages, float32."""
    cfgs = []
    for C in (JConfig, Config):
        C.reset()
        C.set_model_type(C.MODEL[model])
        C.set_model_backbone(C.BACKBONE[backbone])
        C.set_compute_dtype("float32")
        C.set_model_inout(hin=hw[0], win=hw[1], hout=hw[0] // stride, wout=hw[1] // stride)
        for name, args in sets.items():
            getattr(C, name)(**args)
        cfgs.append(C.get_config(create_dirs=False))
    return cfgs


def _hashable(jm):
    """The flax Thin / Small OpenPose hold their plans as lists, which
    `jax.eval_shape` cannot hash: the same network with tuple plans."""
    if hasattr(jm, "init_plan"):
        return jm.clone(init_plan=tuple(jm.init_plan), ref_plan=tuple(jm.ref_plan))
    return jm


def _compare(got, want, name):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), name
        for k in want:
            _compare(got[k], want[k], f"{name}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{name}[{i}]")
    else:
        g = got.detach().numpy()
        w = np.asarray(want)
        assert g.shape == w.shape, f"{name}: {g.shape} vs {w.shape}"
        _assert_close(g, w, name)


def _jax_apply(jm, flat, x):
    """The flax module's outputs on x, jitted: one XLA program compiles
    faster than the op-by-op dispatch runs on the CPU."""
    import jax

    return jax.jit(lambda v, x: jm.apply(v, x, train=False))(nest(flat), jnp.asarray(x))


def _models_agree(jm, pm, hw, seed):
    """Seeded flat weights of the flax init into both; the outputs on one
    seeded batch."""
    want_keys = _flax_shapes(jm, hw)
    assert {k: tuple(v.shape) for k, v in state_dict_to_flax(pm.state_dict()).items()} \
        == want_keys
    flat = random_flax_weights(want_keys, seed=seed)
    x = np.random.default_rng(seed + 1).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = _jax_apply(jm, flat, x)
    load_flax_weights(pm, flat).eval()
    with torch.inference_mode():
        got = pm(torch.from_numpy(x))
    _compare(got, want, type(pm).__name__)


# (model type, backbone override, input size): every model type on its default
# backbone, and the overrides JAX's get_model accepts. PoseProposal builds its
# backbone at scale 32.
GET_MODEL_CASES = [
    ("LightweightOpenpose", "Default", (64, 64)),
    ("LightweightOpenpose", "Vggtiny", (64, 64)),
    ("LightweightOpenpose", "VggtinyS2D", (64, 64)),
    ("LightweightOpenpose", "Resnet18", (64, 64)),
    ("LightweightOpenpose", "Mobilenetv2", (64, 64)),
    ("Openpose", "Default", (32, 40)),
    ("MobilenetThinOpenpose", "Default", (64, 64)),
    ("PoseProposal", "Default", (64, 64)),
    ("PoseProposal", "Vggtiny", (64, 64)),
    ("PoseProposal", "VggtinyS2D", (64, 64)),
    ("PoseProposal", "Vgg16", (64, 64)),
    ("PoseProposal", "Vgg19", (64, 64)),
    ("PoseProposal", "Mobilenetv1", (64, 64)),
    ("PoseProposal", "Mobilenetv2", (64, 64)),
    ("PoseProposal", "MobilenetDilated", (64, 64)),
    ("PoseProposal", "Resnet50", (64, 64)),
    ("Pifpaf", "Default", (64, 64)),
]


@pytest.mark.parametrize("model,backbone,hw", GET_MODEL_CASES,
                         ids=[f"{m}-{b}" for m, b, _ in GET_MODEL_CASES])
def test_get_model_matches_jax(model, backbone, hw):
    jcfg, cfg = _configs(model, backbone, hw)
    pm = Model.get_model(cfg)
    assert pm.dtype == torch.float32
    _models_agree(_hashable(JModel.get_model(jcfg)), pm, hw, seed=len(model) + len(backbone))


@pytest.mark.parametrize("backbone", ["MobilenetThin", "MobilenetSmall"])
def test_pose_proposal_refuses_what_jax_refuses(backbone):
    """MobilenetThin and MobilenetSmall cannot run at scale 32 (their concats
    join features of different strides): both packages refuse."""
    import jax

    jcfg, cfg = _configs("PoseProposal", backbone)
    x = np.zeros((1, 64, 64, 3), np.float32)
    jm = _hashable(JModel.get_model(jcfg))
    with pytest.raises(Exception):
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    with pytest.raises(Exception):
        Model.get_model(cfg)(torch.from_numpy(x))


@pytest.mark.parametrize("backbone", ["Resnet18", "Vggtiny"])
def test_pifpaf_backbone_argument_matches_jax(backbone):
    """`Pifpaf(backbone=...)` builds `backbone(scale_size=32)`, as flax's
    does (the facade, like JAX's, does not pass the configured backbone)."""
    _models_agree(JaxPifpaf(backbone=JB.BACKBONES[backbone]),
                  Pifpaf(backbone=PB.BACKBONES[backbone]), (64, 64), seed=5)


def test_vggtiny_scale32_and_s2d_match_jax():
    """VggTiny's `block_s32_*` tail (strides 2, 1, 2, SAME padding on odd
    sizes) and the trainable space-to-depth VggTinyS2D, as backbones."""
    for jm, pm, hw in ((JB.VggTiny(scale_size=32), PB.VggTiny(scale_size=32), (72, 88)),
                       (JB.VggTinyS2D(), PB.VggTinyS2D(), (64, 80)),
                       (JB.VggTinyS2D(scale_size=32), PB.VggTinyS2D(scale_size=32), (64, 64))):
        want_keys = _flax_shapes(jm, hw)
        assert {k: tuple(v.shape) for k, v in state_dict_to_flax(pm.state_dict()).items()} \
            == want_keys
        flat = random_flax_weights(want_keys, seed=3)
        x = np.random.default_rng(4).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
        want = np.asarray(_jax_apply(jm, flat, x))
        with torch.inference_mode():
            got = load_flax_weights(pm, flat).eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        _compare(got.permute(0, 2, 3, 1), want, type(pm).__name__)


def test_backbones_table_and_defaults_match_jax():
    assert sorted(PB.BACKBONES) == sorted(JB.BACKBONES)
    for name, cls in PB.BACKBONES.items():
        assert cls.__name__ == JB.BACKBONES[name].__name__
    for mt in Config.MODEL:
        jcfg, cfg = _configs(mt.name)
        assert Model.get_backbone(cfg).__name__ == JModel.get_backbone(jcfg).__name__


def _plain(value):
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if hasattr(value, "name") and hasattr(value, "value"):   # an enum member
        return (type(value).__name__, value.name)
    return value


def test_config_matches_jax():
    """The same enums, sections, defaults per model type, `set_*` functions
    and merge rules (MPII part counts) as the JAX package's config."""
    for enum in ("BACKBONE", "MODEL", "DATA", "TRAIN", "SYNC", "OPTIM"):
        assert [(m.name, m.value) for m in getattr(Config, enum)] == \
            [(m.name, m.value) for m in getattr(JConfig, enum)]
    setters = sorted(n for n in dir(JConfig) if n.startswith("set_"))
    assert sorted(n for n in dir(Config) if n.startswith("set_")) == setters
    for mt in Config.MODEL:
        got = dataclasses.asdict(Config._defaults_for(mt))
        want = dataclasses.asdict(JConfig._defaults_for(JConfig.MODEL[mt.name]))
        assert _plain(got) == _plain(want)
    for C in (Config, JConfig):
        C.reset()
        C.set_model_type(C.MODEL.PoseProposal)
        C.set_dataset_type(C.DATA.MPII)
    cfg, jcfg = Config.get_config(create_dirs=False), JConfig.get_config(create_dirs=False)
    assert (cfg.model.n_pos, cfg.model.K_size, cfg.model.L_size) == (16, 16, 15) == \
        (jcfg.model.n_pos, jcfg.model.K_size, jcfg.model.L_size)
    assert cfg.model.compute_dtype == "bfloat16"
    with pytest.raises(ValueError):
        Config.set_data_format("channels_first")
    Config.set_data_format("channels_last")
    Config.reset()
    Config._set("model", "no_such_knob", 1)
    with pytest.raises(AttributeError):
        Config.get_config(create_dirs=False)


def test_package_loads_the_facade_lazily():
    """`import hyperpose_torch` loads no submodule; `Config`, `Model` and
    `Dataset` load on first use, as the JAX package's `from hyperpose_tpu
    import Config, Model, Dataset` names them; other names raise."""
    code = ("import sys, hyperpose_torch\n"
            "assert not [m for m in sys.modules if m.startswith('hyperpose_torch.')]\n"
            "from hyperpose_torch import Config, Model, Dataset\n"
            "assert Config.__name__ == 'hyperpose_torch.config'\n"
            "assert Model.__name__ == 'hyperpose_torch.models'\n"
            "assert Dataset.__name__ == 'hyperpose_torch.data.base'\n"
            "assert 'hyperpose_tpu' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    with pytest.raises(AttributeError):
        __import__("hyperpose_torch").NoSuchModule


def test_dataset_facade_is_the_ports_data_module():
    """`Dataset.get_dataset` is the port's, with the JAX facade's public
    names (`hyperpose_tpu/__init__.py:13`)."""
    import hyperpose_tpu
    from hyperpose_torch import Dataset
    from hyperpose_torch.data import base

    assert Dataset is base
    assert Dataset.get_dataset.__module__ == "hyperpose_torch.data.base"
    public = {n for n in dir(hyperpose_tpu.Dataset) if not n.startswith("_")
              and callable(getattr(hyperpose_tpu.Dataset, n))
              and getattr(getattr(hyperpose_tpu.Dataset, n), "__module__", "").startswith(
                  "hyperpose_tpu")}
    assert public <= set(dir(Dataset)), public - set(dir(Dataset))


# -- decoders -----------------------------------------------------------------------

def _arrays(d):
    return {f: np.asarray(getattr(d, f)) for f in FIELDS}


def _paf_maps():
    conf, paf = make_synthetic_maps(TWO_PEOPLE)
    empty_conf, empty_paf = make_synthetic_maps([])
    return np.stack([conf, empty_conf]), np.stack([paf, empty_paf])


def test_paf_postprocessor_matches_jax():
    jcfg, cfg = _configs("LightweightOpenpose")
    conf, paf = _paf_maps()
    want = _arrays(JModel.get_postprocessor(jcfg)(jnp.asarray(conf), jnp.asarray(paf)))
    got = _arrays(Model.get_postprocessor(cfg)(torch.from_numpy(conf), torch.from_numpy(paf)))
    assert got["valid"][0].sum() == 2 and not got["valid"][1].any()
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5, err_msg=f)
    assert Model._fused_decode_for(cfg, None) is None


def test_custom_parts_limbs_and_postprocessor_match_jax():
    """`custom_parts` replaces the topology, `custom_limbs` its limbs; the
    PAF decoder is built for it; a `custom_postprocessor` is returned as
    it is."""
    from hyperpose_tpu.utils import topology as JT
    from hyperpose_torch.utils import topology as PT

    limbs = [[0, 1], [1, 2], [2, 3]]
    jcfg, cfg = _configs("LightweightOpenpose",
                         set_custom_parts={"parts": JT.MPII_TOPOLOGY},
                         set_custom_limbs={"limbs": limbs})
    cfg.model.custom_parts = PT.MPII_TOPOLOGY
    jt, pt = JModel.get_topology(jcfg), Model.get_topology(cfg)
    assert (pt.n_parts, pt.n_limbs) == (jt.n_parts, jt.n_limbs) == (PT.MPII_TOPOLOGY.n_parts, 3)
    np.testing.assert_array_equal(pt.limbs, jt.limbs)
    post, jpost = Model.get_postprocessor(cfg), JModel.get_postprocessor(jcfg)
    assert (post.keywords["cfg"].n_parts, post.keywords["cfg"].n_limbs) == \
        (jpost.keywords["cfg"].n_parts, jpost.keywords["cfg"].n_limbs)

    def mine(*maps):
        return "decoded"

    _, cfg = _configs("Pifpaf", set_custom_postprocessor={"postprocessor": mine})
    assert Model.get_postprocessor(cfg) is mine


def test_model_arch_replaces_the_network():
    """A module is returned as it is; any other callable is called with the
    config (JAX: a flax module or a callable)."""
    net = torch.nn.Conv2d(3, 3, 1)
    _, cfg = _configs("LightweightOpenpose", set_model_arch={"model_arch": net})
    assert Model.get_model(cfg) is net
    _, cfg = _configs("Openpose", set_model_arch={"model_arch": lambda c: c.model.model_type})
    assert Model.get_model(cfg) == Config.MODEL.Openpose


def _engines(model, hw, seed, **sets):
    """Both packages' engines on the facade's model and fused step, the same
    seeded weights."""
    from hyperpose_tpu.runtime.engine import PoseEngine as JaxPoseEngine
    from hyperpose_torch.runtime.engine import PoseEngine

    stride = 32 if model == "PoseProposal" else 8
    jcfg, cfg = _configs(model, hw=hw, stride=stride, **sets)
    jm, pm = JModel.get_model(jcfg), Model.get_model(cfg)
    flat = random_flax_weights(_flax_shapes(jm, hw), seed=seed)
    jeng = JaxPoseEngine(jm, nest(flat), input_hw=hw, max_batch_size=2,
                         topology=JModel.get_topology(jcfg),
                         fused_decode=JModel._fused_decode_for(jcfg, jm))
    teng = PoseEngine(pm, flat, input_hw=hw, max_batch_size=2, device="cpu",
                      topology=Model.get_topology(cfg),
                      fused_decode=Model._fused_decode_for(cfg, pm))
    frames = np.random.default_rng(seed + 1).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    return jeng, teng, frames


@pytest.mark.parametrize("overrides", [None, {"thresh_part_score": 0.45, "min_parts": 3}])
def test_ppn_fused_decode_matches_jax(overrides):
    """The facade's PoseProposal step (`_fused_decode_for`: the network,
    `restore_coor`, `ppn_decode_batch` with `set_ppn_decoder`'s overrides)
    against JAX's on the same frames. Random weights put every cell's
    sigmoid near 0.5, so the decode fills its proposals."""
    sets = {} if overrides is None else {"set_ppn_decoder": overrides}
    jeng, teng, frames = _engines("PoseProposal", (64, 64), 21, **sets)
    if overrides:
        assert teng.fused_decode.rebuild(teng.model) is not None
    want = _arrays(jeng.infer_batch_device(jnp.asarray(frames)))
    got = _arrays(teng.infer_batch_device(frames))
    assert got["valid"].sum() > 0, "degenerate decode"
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["part_valid"], want["part_valid"])
    for f in ("coords", "part_scores", "scores"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-5, err_msg=f)


def test_pifpaf_fused_decode_matches_jax():
    jeng, teng, frames = _engines("Pifpaf", (64, 64), 31)
    want = _arrays(jeng.infer_batch_device(jnp.asarray(frames)))
    got = _arrays(teng.infer_batch_device(frames))
    assert got["coords"].shape == (2, 32, 17, 2)
    assert_same_humans(got, want)


def test_custom_postprocessor_runs_in_the_fused_step():
    """With a `custom_postprocessor`, the PoseProposal step hands it the
    restored maps, as JAX's `_fused_decode_for` does."""
    seen = {}

    def post(pred):
        seen.update(pred)
        return Model.get_postprocessor(cfg_plain)(pred)

    _, cfg_plain = _configs("PoseProposal", hw=(64, 64), stride=32)
    _, cfg = _configs("PoseProposal", hw=(64, 64), stride=32,
                      set_custom_postprocessor={"postprocessor": post})
    pm = Model.get_model(cfg)
    load_flax_weights(pm, random_flax_weights(pm, seed=2))
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3),
                                                                dtype=np.uint8))
    got = Model._fused_decode_for(cfg, pm)(frames)
    want = Model._fused_decode_for(cfg_plain, pm)(frames)
    assert float(seen["x"].max()) > 1.0        # restored to input pixels
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


BACKBONE_NAMES = [b.name for b in Config.BACKBONE if b.name != "Default"]


@pytest.mark.parametrize("backbone", BACKBONE_NAMES)
def test_lightweight_openpose_on_every_backbone_as_in_jax(backbone):
    """`get_model` of Lightweight-OpenPose on each of the 11 backbones: the
    flat keys and shapes of a flax init of JAX's model, and outputs of the
    shapes JAX's have (the values are held per backbone family above and in
    tests/test_torch_mobilenets.py and test_torch_resnet18.py)."""
    import jax

    x = np.zeros((1, 32, 32, 3), np.float32)
    jcfg, cfg = _configs("LightweightOpenpose", backbone, (32, 32))
    jm, pm = JModel.get_model(jcfg), Model.get_model(cfg)
    want, variables = jax.eval_shape(lambda: jm.init_with_output(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    shapes = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert {k: tuple(v.shape) for k, v in state_dict_to_flax(pm.state_dict()).items()} \
        == shapes
    with torch.inference_mode():
        got = pm.eval()(torch.from_numpy(x))
    for key in ("conf_map", "paf_map"):
        assert tuple(got[key].shape) == tuple(want[key].shape), key


def test_every_model_type_builds_on_every_backbone():
    """Every model type with every backbone override builds, as JAX's
    `get_model` accepts them all (PifPaf keeps its ResNet50 in both)."""
    for mt in Config.MODEL:
        for backbone in BACKBONE_NAMES:
            _, cfg = _configs(mt.name, backbone, (64, 64))
            with torch.device("meta"):     # no weights drawn
                pm = Model.get_model(cfg)
            trunk = type(pm.backbone).__name__
            if mt == Config.MODEL.Pifpaf:
                assert trunk == "Resnet50"
            else:
                assert trunk == PB.BACKBONES[backbone].__name__
