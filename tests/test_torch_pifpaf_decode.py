"""The port's PifPaf decoder (device="cpu") against the JAX package's.

Inputs are composite fields made with numpy (tests/test_pifpaf.py
`synth_fields`, the golden test's `random_scene`, dense random fields) and
handed to both packages.

Tolerances: the growth on tables JAX prepared, atol 1e-5 on painted fields
and 1e-4 on dense random ones (the Pallas kernel in interpret mode and the
plain version take the same float32 steps, but XLA and PyTorch evaluate exp
with their own code); decodes: valid and part_valid exact, coords and scores
atol 1e-4 (the port sums the hr contributions in float64 and rounds once,
XLA in float32 in its own order). On painted fields several seeds grow the
same skeleton with exactly equal scores in JAX, and which of the equal
duplicates keeps its slot follows last-ulp differences of those sums, so
there the decodes are compared as sets of humans; on noisy fields slot by
slot. The pinned oracle is held to `test_randomized_match_rate`'s
thresholds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one thread per test worker)
from chip_smoke import human_deltas
from hyperpose_tpu.ops import pifpaf_decode as J
from hyperpose_tpu.ops.pallas.grow_kernel import fused_grow as jax_fused_grow
from hyperpose_tpu.utils.topology import PIFPAF_TOPOLOGY as JAX_TOPOLOGY
from hyperpose_torch.ops import pifpaf_decode as T
from hyperpose_torch.ops.kernels.grow import find_connection, fused_grow, fused_grow_plain
from test_pifpaf import TWO_PEOPLE, synth_fields
from test_pifpaf_golden import IN_HW, match_stats, random_scene

FIELDS = ("coords", "part_scores", "part_valid", "scores", "valid")
LIMBS = np.asarray(JAX_TOPOLOGY.limbs)
E_SRC = tuple(int(v) for v in np.concatenate([LIMBS[:, 0], LIMBS[:, 1]]))
E_DST = tuple(int(v) for v in np.concatenate([LIMBS[:, 1], LIMBS[:, 0]]))
CROWD = [
    {i: (60 + 90 * j + 8 * (i % 4), 60 + 20 * (i // 4)) for i in range(17)}
    for j in range(4)
]   # tests/test_pifpaf.py test_decode_crowded_rank_nms


def dense_random_fields(seed=7, b=2, h=24, w=28):
    """Dense random raw fields, as tests/test_pifpaf.py
    test_grow_pallas_matches_xla_random."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.normal(size=(b, h, w) + s).astype(np.float32)  # noqa: E731
    return {
        "pif_conf": n(17), "pif_vec": n(17, 2),
        "pif_bmin": np.zeros((b, h, w, 17), np.float32), "pif_scale": n(17),
        "paf_conf": n(19), "paf_src_vec": n(19, 2), "paf_dst_vec": n(19, 2),
        "paf_src_scale": n(19), "paf_dst_scale": n(19),
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_prepare(fields, cfg):
    maps = J.restore_maps(fields, 8)
    return jax.vmap(lambda m: J._prepare_one(m, cfg, LIMBS))(maps)


def _jax_decode(fields, in_hw, **cfg):
    out = J.pifpaf_decode_batch(fields, J.PifPafDecoderConfig(grow_backend="xla", **cfg),
                                8, in_hw)
    return {f: np.asarray(getattr(out, f)) for f in FIELDS}


def _port_decode(fields, in_hw, **cfg):
    out = T.pifpaf_decode_batch(fields, T.PifPafDecoderConfig(**cfg), 8, in_hw)
    return {f: getattr(out, f).numpy() for f in FIELDS}


def _assert_decodes_equal(got, want, atol=1e-4):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["part_valid"], want["part_valid"])
    for f in ("coords", "part_scores", "scores"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=atol, err_msg=f)


def assert_same_humans(got, want, atol=1e-4):
    d_xy, d_s = human_deltas(got, want)
    assert d_xy <= atol and d_s <= atol, (d_xy, d_s)


@pytest.mark.parametrize("case,atol", [("painted", 1e-5), ("dense_random", 1e-4)])
def test_fused_grow_plain_matches_pallas(case, atol):
    """Growth on the tables JAX prepared: the port's plain version against
    the Pallas kernel in interpret mode, and the wrapper on CPU tensors
    takes the plain version (no launch)."""
    fields = synth_fields(TWO_PEOPLE) if case == "painted" else dense_random_fields()
    prep = jax.device_get(_jax_prepare(fields, J.PifPafDecoderConfig()))
    rev = (np.arange(38) + 19) % 38
    tables = tuple(np.asarray(t) for t in prep["tables"])
    rev_tables = tuple(t[:, rev] for t in tables)
    want = jax_fused_grow(
        jnp.asarray(prep["seed_part"]), jnp.asarray(prep["seed_vals"]),
        tuple(map(jnp.asarray, tables)), tuple(map(jnp.asarray, rev_tables)),
        E_SRC, E_DST, 17, 8, True, interpret=True)
    tensor = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)
    args = (tensor(prep["seed_part"]), tensor(prep["seed_vals"]),
            tuple(map(tensor, tables)), tuple(map(tensor, rev_tables)),
            E_SRC, E_DST, 17, 8, True)
    got = fused_grow_plain(*args)
    before = fused_grow.launches
    via_wrapper = fused_grow(*args)
    assert fused_grow.launches == before
    assert float(np.asarray(want[0]).max()) > 0, "degenerate growth"
    for name, g, w, v in zip(("score", "x", "y", "scale"), got, want, via_wrapper):
        assert g.shape == (fields["pif_conf"].shape[0], 32, 17)
        assert torch.equal(g, v)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol,
                                   err_msg=name)


def _scene(seed, n_people):
    return random_scene(np.random.default_rng(seed), n_people)


@pytest.mark.parametrize("case", [
    "two_people", "crowd", "empty", "scene_1", "scene_3", "scene_7", "no_reverse",
])
def test_decode_matches_jax(case):
    fields = {
        "two_people": lambda: synth_fields(TWO_PEOPLE),
        "crowd": lambda: synth_fields(CROWD),
        "empty": lambda: synth_fields([]),
        "scene_1": lambda: _scene(1, 1),
        "scene_3": lambda: _scene(3, 3),
        "scene_7": lambda: _scene(7, 7),
        "no_reverse": lambda: synth_fields(TWO_PEOPLE),
    }[case]()
    cfg = {"reverse_match": False} if case == "no_reverse" else {}
    want = _jax_decode(fields, IN_HW, **cfg)
    got = _port_decode(fields, IN_HW, **cfg)
    if case.startswith("scene"):
        _assert_decodes_equal(got, want)
    else:
        assert_same_humans(got, want)
    expected = {"two_people": 2, "crowd": 4, "empty": 0, "no_reverse": 2}
    if case in expected:
        assert int(got["valid"].sum()) == expected[case]


def test_decode_dense_random_matches_jax():
    """A batch of two dense random images at another size (24x28 fields,
    192x224 input): every stage runs at its bounds, images independent."""
    fields = dense_random_fields()
    want = _jax_decode(fields, (192, 224))
    got = _port_decode(fields, (192, 224))
    _assert_decodes_equal(got, want)
    one = _port_decode({k: v[1:] for k, v in fields.items()}, (192, 224))
    for f in FIELDS:
        np.testing.assert_array_equal(one[f][0], got[f][1])


def test_decode_without_component_picks_matches_jax():
    fields = synth_fields(CROWD)
    assert_same_humans(_port_decode(fields, IN_HW, component_picks=False),
                       _jax_decode(fields, IN_HW, component_picks=False))


def test_port_meets_the_pinned_oracle_thresholds():
    """`test_randomized_match_rate` with the port's decoder in place of the
    JAX one, on the same 32 scenes and the pinned oracle humans."""
    from golden_pifpaf_fixture import golden_scenes, load_oracle

    def port_humans(fields):
        out = _port_decode(fields, IN_HW)
        humans = []
        for hid in np.nonzero(out["valid"][0])[0]:
            humans.append({
                int(k): (float(out["part_scores"][0, hid, k]),
                         float(out["coords"][0, hid, k, 0] * IN_HW[1]),
                         float(out["coords"][0, hid, k, 1] * IN_HW[0]))
                for k in np.nonzero(out["part_valid"][0, hid])[0]
            })
        return humans

    oracle = load_oracle()
    total = matched = crowd_total = crowd_matched = agree = n = 0
    for s, crowded, fields in golden_scenes(random_scene):
        ours = port_humans(fields)
        t, m = match_stats(oracle[s], ours)
        total, matched, n = total + t, matched + m, n + 1
        if crowded:
            crowd_total, crowd_matched = crowd_total + t, crowd_matched + m
        agree += int(len(oracle[s]) == len(ours))
    assert total > 1500
    assert matched / total >= 0.98, f"{matched}/{total}"
    assert crowd_matched / crowd_total >= 0.95, f"{crowd_matched}/{crowd_total}"
    assert agree >= int(0.90 * n), f"{agree}/{n}"


def test_restore_maps_matches_jax():
    """Grid orientation (x along W) and softplus at large inputs."""
    fields = dense_random_fields(seed=3, b=1, h=6, w=9)
    fields["pif_scale"][0, 0, 0, 0] = 40.0        # F.softplus would be linear
    want = jax.device_get(J.restore_maps(fields, 8))
    got = T.restore_maps({k: torch.from_numpy(v) for k, v in fields.items()}, 8)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-5,
                                   err_msg=k)


def test_bounded_select_matches_jax():
    """Below capacity, at capacity with overflow (the first kept, as
    tests/test_pifpaf.py:341), and empty rows."""
    rng = np.random.default_rng(3)
    vals = rng.random((5, 200)).astype(np.float32)
    vals[vals < 0.9] = 0.0
    vals[4] = 0.0
    fields = np.stack([vals, vals * 2.0 + 1.0], axis=-1)
    for cap in (32, 8):
        want = np.asarray(J._bounded_select(jnp.asarray(vals) > 0.5,
                                            jnp.asarray(fields), cap))
        got = T._bounded_select(torch.from_numpy(vals) > 0.5,
                                torch.from_numpy(fields), cap).numpy()
        np.testing.assert_array_equal(got, want)
    ramp = np.arange(1, 11, dtype=np.float32)[None]
    got = T._bounded_select(torch.from_numpy(ramp) > 0,
                            torch.from_numpy(ramp[..., None]), 4)
    np.testing.assert_array_equal(got[0, :, 0].numpy(), [1, 2, 3, 4])


def test_pairwise_rank_matches_jax():
    rng = np.random.default_rng(7)
    v = rng.integers(0, 5, size=(3, 50)).astype(np.float32)    # many ties
    v[2, :10] = -1e30
    want = np.asarray(jax.vmap(J._pairwise_rank)(jnp.asarray(v)))
    got = T._pairwise_rank(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got[0], np.argsort(np.argsort(-v[0], kind="stable"), kind="stable"))


def test_find_connection_matches_jax():
    """The port's `find_connection`, given JAX's validity mask as a zero
    score, against JAX `_find_connection`: random trials as
    tests/test_pifpaf.py:239, plus exact ties (two equal best candidates:
    the lower index wins) and the empty case."""
    rng = np.random.default_rng(0)
    k = 24
    for trial in range(40):
        mx, my = rng.uniform(0, 100, (2, k)).astype(np.float32)
        ms = rng.uniform(0, 1, k).astype(np.float32)
        mv = rng.random(k) > 0.3
        ox, oy = rng.uniform(0, 100, (2, k)).astype(np.float32)
        osc = rng.uniform(1, 10, k).astype(np.float32)
        x, y = rng.uniform(20, 80, 2).astype(np.float32)
        scale = np.float32(rng.uniform(2, 12))
        if trial % 4 == 1:                       # two identical best candidates
            mx[[3, 9]], my[[3, 9]], ms[[3, 9]], mv[[3, 9]] = x, y, 0.9, True
        if trial % 4 == 2:
            mv[:] = False
        want = J._find_connection(*map(jnp.asarray, (mx, my, ms, mv, ox, oy, osc)),
                                  jnp.float32(x), jnp.float32(y), jnp.float32(scale))
        got = find_connection(*map(torch.from_numpy, (mx, my, np.where(mv, ms, 0),
                                                       ox, oy, osc)),
                              *(torch.tensor(v) for v in (x, y, scale)))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=0, atol=1e-5)


def test_grow_backend_is_checked():
    with pytest.raises(ValueError, match="grow_backend"):
        T.pifpaf_decode_batch(synth_fields([]), T.PifPafDecoderConfig(grow_backend="x"))
