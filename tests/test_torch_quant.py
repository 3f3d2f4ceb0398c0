"""The port's int8 quantization (`hyperpose_torch/quant.py`) and its GEMM
(`ops/kernels/int8_gemm.py`) against the JAX package's `quant.py` and the
TPU probe `scripts/probe_int8_pallas.py`, on the CPU.

Tolerances:
- `int8_gemm_plain` s8 equals the probe's int32 product exactly; bf16 lies
  within what two float32 sums of the same K products in any order can
  differ by (torch_measures.sum_order(K) times the sum of their magnitudes).
- `Int8Conv2d`: its s32 sums equal JAX's int8 conv exactly; its output lies
  within 1 float32 ulp of `_quantized_conv`'s (bf16: within 1 bf16 ulp).
- `calibrate`: the same keys as JAX, values within 1e-5 relative (float32
  activations of the same network summed in another order).
- every int8 conv of the plain f32 flagship on the input JAX gave it:
  equal to JAX's output bit for bit;
- the float BatchNorm against flax's on the same input: within 2 float32
  ulps of the map's largest value;
- quantized networks on the same scale table, where float noise in the
  layers between the convs may flip an int8 rounding, relative to the maps'
  largest value (JAX's own int8-vs-float bound is 0.15,
  tests/test_quant.py:53): 0.1 (measured values in the test).
- artifacts: keys, w_q and s_w equal; re-quantized outputs within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from jax import lax

from torch_measures import bf16_ulps, sum_order
from torch_parity import FLAGSHIP_NPZ, flagship_flat, nest, synth_frame_rgb
from hyperpose_tpu import quant as jquant
from hyperpose_tpu.models import backbones as JB
from hyperpose_tpu.models.openpose import LightWeightOpenPose as JaxLwOpenPose
from hyperpose_torch import quant
from hyperpose_torch.models.backbones import (
    DepthwiseConv, VggTiny, VggTinyFusedStem, VggTinyS2DStem, remap_vggtiny_to_fused,
    remap_vggtiny_to_s2d, same_pads,
)
from hyperpose_torch.models.openpose import LightWeightOpenPose
from hyperpose_torch.ops.image import resize_bilinear
from hyperpose_torch.ops.kernels.int8_gemm import (
    int8_conv_sums_plain, int8_dwconv, int8_dwconv_fused_plain, int8_dwconv_plain,
    int8_dwconv_sums_plain, int8_gemm, int8_gemm_plain, int8_quantize_plain,
)
from hyperpose_torch.utils.weights import load_flax_weights

HW = (64, 80)   # tests/test_quant.py's size


# -- the GEMM's plain version against the probe's formulas -------------------------

@pytest.mark.parametrize("m,k,n", [(64, 1792, 256), (17, 32, 19), (5, 3456, 38)])
def test_int8_gemm_plain_matches_probe_formula(m, k, n):
    """s8: `jnp.dot(a.astype(int32), b.astype(int32))`
    (probe_int8_pallas.py:91), exactly."""
    rng = np.random.default_rng(m + k)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jnp.dot(jnp.asarray(a).astype(jnp.int32),
                              jnp.asarray(b).astype(jnp.int32)))
    got = int8_gemm_plain(torch.from_numpy(a), torch.from_numpy(b.T.copy()))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_gemm_plain_is_exact_at_its_largest_sums():
    """|sum| = K * 127^2 at the flagship's deepest conv (K = 3456), both
    signs, and a row chunking that splits M."""
    k = 3456
    a = torch.full((3, k), 127, dtype=torch.int8)
    a[1] = -127
    bt = torch.full((2, k), 127, dtype=torch.int8)
    bt[1, ::2] = -127
    got = int8_gemm_plain(a, bt)
    big = k * 127 * 127
    assert got.tolist() == [[big, 0], [-big, 0], [big, 0]]


@pytest.mark.parametrize("m,k,n", [(64, 1792, 256), (9, 16, 19)])
def test_int8_gemm_plain_bf16_matches_probe_formula(m, k, n):
    """bf16 -> f32: `jnp.dot(a, b, preferred_element_type=float32)`
    (probe_int8_pallas.py:35-36), within float32 sum-order slack at depth K."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).bfloat16()
    bt = torch.from_numpy(rng.normal(0, 1, (n, k)).astype(np.float32)).bfloat16()
    want = np.asarray(jnp.dot(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                              jnp.asarray(bt.float().numpy().T, jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    got = int8_gemm_plain(a, bt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    slack = sum_order(k) * torch.matmul(a.float().abs(), bt.float().abs().T)
    assert bool(((got - torch.from_numpy(want.copy())).abs() <= slack).all())


def test_int8_gemm_cpu_takes_the_plain_version():
    a = torch.ones(4, 32, dtype=torch.int8)
    bt = torch.ones(3, 32, dtype=torch.int8)
    before = int8_gemm.launches
    assert torch.equal(int8_gemm(a, bt), int8_gemm_plain(a, bt))
    assert int8_gemm.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        int8_gemm(a.to("meta"), bt.to("meta"))


# -- Int8Conv2d against _quantized_conv ----------------------------------------------

class _OneConv(fnn.Module):
    features: int
    kernel: tuple
    strides: int = 1
    dilation: int = 1
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(self.features, self.kernel, strides=self.strides,
                        kernel_dilation=self.dilation, padding="SAME", dtype=self.dtype,
                        name="conv")(x)


class _PortOneConv(torch.nn.Module):
    """One conv with XLA's SAME padding: padded in float first at stride 2,
    as the port's ConvBN does."""

    def __init__(self, cin, cout, k, stride, dilation, dtype):
        super().__init__()
        self.span, self.stride = dilation * (k - 1) + 1, stride
        self.conv = torch.nn.Conv2d(cin, cout, k, stride=stride, dilation=dilation,
                                    padding=self.span // 2 if stride == 1 else 0, dtype=dtype)

    def forward(self, x):
        if self.stride > 1:
            x = F.pad(x, same_pads(x.shape[-2:], self.span, self.stride))
        return self.conv(x)


CONV_CASES = {   # cin, cout, kernel, stride, input dtype, dilation, batch, (H, W)
    "3x3": (16, 24, 3, 1, "float32", 1, 2, HW),
    "1x1": (64, 19, 1, 1, "float32", 1, 2, HW),
    "3x3_cin3": (3, 32, 3, 1, "float32", 1, 2, HW),         # K = 27 -> 9 taps of 32
    "1x1_cin185": (185, 128, 1, 1, "float32", 1, 2, HW),    # Cp = 192 (ref_b0.init)
    "7x7_stride2": (3, 64, 7, 2, "float32", 1, 2, HW),      # the ResNet50 stem: pads 2, 3
    "3x3_bf16": (32, 40, 3, 1, "bfloat16", 1, 2, HW),
    # The padded layouts (Cp = 32, 192, 224; Np = 24, 40, 64) over odd sizes,
    # both strides, dilation 2 and batch 1:
    "1x1_cin3_cout19_stride2": (3, 19, 1, 2, "float32", 1, 1, (37, 45)),
    "3x3_cin185_cout38_dil2": (185, 38, 3, 1, "float32", 2, 2, (23, 29)),
    "7x7_cin200_cout64_stride2": (200, 64, 7, 2, "float32", 1, 1, (31, 27)),
    "3x3_cin3_cout64_stride2_dil2": (3, 64, 3, 2, "float32", 2, 2, (33, 41)),
    "7x7_cin185_cout19_dil2_bf16": (185, 19, 7, 1, "bfloat16", 2, 1, (19, 25)),
    "1x1_cin200_cout38": (200, 38, 1, 1, "float32", 1, 2, (21, 23)),
    "3x3_cin200_cout19_stride2_bf16": (200, 19, 3, 2, "bfloat16", 1, 2, (25, 21)),
    "7x7_cin3_cout38_dil2": (3, 38, 7, 1, "float32", 2, 1, (29, 33)),
    "1x1_cin185_cout64_stride2_dil2_bf16": (185, 64, 1, 2, "bfloat16", 2, 1, (27, 35)),
}


def _conv_run(case):
    cin, cout, k, stride, dt, dil, batch, hw = CONV_CASES[case]
    rng = np.random.default_rng(cin * 7 + k)
    x = rng.normal(0, 1, (batch, *hw, cin)).astype(np.float32)
    kernel = (rng.normal(0, 1, (k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    s_abs = float(jnp.max(jnp.abs(xj.astype(jnp.float32))))
    variables = {"params": {"conv": {"kernel": kernel, "bias": bias}}}
    jmod = _OneConv(cout, (k, k), stride, dil, jdt)
    want = jquant.quantized_apply(jmod, {"conv": s_abs})(variables, xj)
    # JAX's s32 sums, from _quantized_conv's own formulas (quant.py:130-153).
    s_in = s_abs / 127.0
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-8) / 127.0
    w_q = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(xj.astype(jnp.float32) * (1.0 / s_in)), -127, 127
                   ).astype(jnp.int8)
    dn = lax.conv_dimension_numbers(x_q.shape, w_q.shape, ("NHWC", "HWIO", "NHWC"))
    acc_want = lax.conv_general_dilated(x_q, w_q, (stride, stride), "SAME",
                                        rhs_dilation=(dil, dil), dimension_numbers=dn,
                                        preferred_element_type=jnp.int32)

    tdt = getattr(torch, dt)
    model = _PortOneConv(cin, cout, k, stride, dil, tdt).eval()
    quant.quantize_model(model, {"conv": s_abs},
                         weights={"params/conv/kernel": kernel, "params/conv/bias": bias})
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = model(xt)
        q = model.conv
        xin = F.pad(xt, same_pads(xt.shape[-2:], model.span, stride)) if stride > 1 else xt
        acc = int8_conv_sums_plain(q.quantize(xin), q.w_taps, *q.taps_geometry)[:, :cout]
    return q, got, np.asarray(want.astype(jnp.float32)), acc, np.asarray(acc_want)


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_int8_conv_matches_jax_quantized_conv(case):
    """Through the padded layouts: the weights [Np, kh, kw, Cp] with Np a
    multiple of 8 and Cp of 32, the quantized buffer [B, H, W, Cp] without
    spatial padding, and `int8_conv_plain`'s dequantize."""
    q, got, want, acc, acc_want = _conv_run(case)
    assert isinstance(q, quant.Int8Conv2d)
    assert q.w_taps.shape[0] % 8 == 0 and q.w_taps.shape[3] % 32 == 0
    b, ho, wo, cout = acc_want.shape
    np.testing.assert_array_equal(acc.numpy().reshape(b, ho, wo, cout), acc_want)
    got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bfloat16:
        assert bf16_ulps(got, torch.from_numpy(want).bfloat16()) <= 1
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("s_in", [0.5, 0.0123])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_plain_matches_jax(dtype, s_in):
    """`int8_quantize_plain` equals JAX's x_q (`quant.py:139-141`) on a
    channels-last input: exact .5 ties (x = n / 2 * s_in, so x * inv_s lands
    on halves), values beyond +-127 s_in, and zeros in channels >= C."""
    rng = np.random.default_rng(17)
    c = 37
    x = (rng.integers(-600, 601, (2, 5, 7, c)) / 4 * (2 * s_in)).astype(np.float32)
    x[0, 0, 0, :8] = np.array([0.25, -0.25, 0.75, -0.75, 63.25, -63.75, 100, -1e3]) * 2 * s_in
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    want = np.asarray(jnp.clip(jnp.round(xj.astype(jnp.float32) * (1.0 / s_in)), -127, 127
                               ).astype(jnp.int8))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = int8_quantize_plain(xt.permute(0, 3, 1, 2), float(np.float32(1.0 / s_in)), 64)
    assert got.dtype == torch.int8 and tuple(got.shape) == (2, 5, 7, 64)
    np.testing.assert_array_equal(got[..., :c].numpy(), want)
    assert not got[..., c:].any()
    v = np.asarray(xj.astype(jnp.float32)) * np.float32(1.0 / s_in)
    assert (np.abs(want) == 127).any()
    assert s_in != 0.5 or (np.abs(v - np.trunc(v)) == 0.5).any()


def test_int8_conv_output_is_a_channels_last_view():
    """The NCHW result is the [M, cout] GEMM output seen through a permute:
    no transposing copy."""
    q, got, *_ = _conv_run("3x3")
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.permute(0, 2, 3, 1).is_contiguous()


class _OneGroupedConv(fnn.Module):
    features: int
    kernel: int
    groups: int
    strides: int = 1
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(self.features, (self.kernel, self.kernel), strides=self.strides,
                        padding="SAME", feature_group_count=self.groups, dtype=self.dtype,
                        name="conv")(x)


GROUPED_CASES = [(g, k, s) for g in (2, 4) for k in (1, 3) for s in (1, 2)]


@pytest.mark.parametrize("groups,k,stride", GROUPED_CASES)
def test_grouped_int8_conv_raises(groups, k, stride):
    """A grouped conv (1 < groups < channels) quantizes as JAX's
    `_quantized_conv` with `feature_group_count` does: one dense int8 conv a
    group (`parts`) on its channel slice, the layer's s_in, each output
    channel's weight scale. Its s32 sums equal JAX's exactly and its output
    lies within 1 float32 ulp; the stages of a grouped conv raise (it runs
    its groups' stages), and so does an input of the wrong width."""
    cin, cout, hw = 8 * groups, 6 * groups, (13, 17)
    rng = np.random.default_rng(groups * 10 + k + stride)
    x = rng.normal(0, 1, (2, *hw, cin)).astype(np.float32)
    kernel = (rng.normal(0, 1, (k, k, cin // groups, cout)) / k).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    s_abs = float(np.abs(x).max()) * 0.8          # some inputs clip at +-127
    variables = {"params": {"conv": {"kernel": kernel, "bias": bias}}}
    want = np.asarray(jquant.quantized_apply(_OneGroupedConv(cout, k, groups, stride),
                                             {"conv": s_abs})(variables, jnp.asarray(x)))
    s_in = s_abs / 127.0
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-8) / 127.0
    w_q = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / s_in)), -127, 127).astype(jnp.int8)
    dn = lax.conv_dimension_numbers(x_q.shape, w_q.shape, ("NHWC", "HWIO", "NHWC"))
    acc_want = np.asarray(lax.conv_general_dilated(
        x_q, w_q, (stride, stride), "SAME", dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32))

    model = _PortOneConv(cin, cout, k, stride, 1, torch.float32)
    model.conv = torch.nn.Conv2d(cin, cout, k, stride=stride, groups=groups,
                                 padding=k // 2 if stride == 1 else 0)
    quant.quantize_model(model, {"conv": s_abs},
                         weights={"params/conv/kernel": kernel, "params/conv/bias": bias})
    q = model.conv
    assert isinstance(q, quant.Int8Conv2d) and q.groups == groups and len(q.parts) == groups
    assert all(p.w_taps.shape[-1] % 32 == 0 for p in q.parts)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = model(xt).permute(0, 2, 3, 1).numpy()
        xin = F.pad(xt, same_pads(xt.shape[-2:], k, stride)) if stride > 1 else xt
        n = cin // groups
        acc = torch.cat([int8_conv_sums_plain(p.quantize(xin[:, g * n:(g + 1) * n]), p.w_taps,
                                              *p.taps_geometry)[:, :cout // groups]
                         for g, p in enumerate(q.parts)], dim=1)
    np.testing.assert_array_equal(acc.numpy().reshape(acc_want.shape), acc_want)
    assert got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    for stage in (lambda: q.quantize(xt), lambda: q.conv(None, torch.float32),
                  lambda: q.conv_plain(None, torch.float32)):
        with pytest.raises(TypeError, match="grouped"):
            stage()
    with pytest.raises(ValueError, match="input channels"):
        q(xt[:, :cin - 1])


class _GroupedNet(torch.nn.Module):
    """A small PAF-family network with a grouped conv (no built-in model has
    one; a user's `model_arch` can): NHWC in, NHWC conf / PAF maps out."""

    def __init__(self):
        super().__init__()
        self.dtype = torch.float32
        self.conv0 = torch.nn.Conv2d(3, 16, 3, padding=1)
        self.gconv = torch.nn.Conv2d(16, 16, 3, padding=1, groups=4)
        self.conf = torch.nn.Conv2d(16, 19, 1)
        self.paf = torch.nn.Conv2d(16, 38, 1)

    def forward(self, x):
        y = torch.relu(self.gconv(torch.relu(self.conv0(x.permute(0, 3, 1, 2)))))
        return {"conf_map": self.conf(y).permute(0, 2, 3, 1),
                "paf_map": self.paf(y).permute(0, 2, 3, 1)}


class _JaxGroupedNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        y = jax.nn.relu(fnn.Conv(16, (3, 3), padding="SAME", name="conv0")(x))
        y = jax.nn.relu(fnn.Conv(16, (3, 3), padding="SAME", feature_group_count=4,
                                 name="gconv")(y))
        return {"conf_map": fnn.Conv(19, (1, 1), name="conf")(y),
                "paf_map": fnn.Conv(38, (1, 1), name="paf")(y)}


def test_quantize_engine_takes_a_grouped_conv():
    """`quantize_engine` on a network with a 4-group conv: every conv in
    int8, the grouped one as 4 dense parts; the int8 maps against JAX's
    `quantized_apply` on the same scale table within the networks' bound
    (module docstring), and the int8 engine decodes."""
    from hyperpose_torch.runtime.engine import PoseEngine
    from hyperpose_torch.utils.weights import random_flax_weights

    hw = (24, 32)
    flat = random_flax_weights(_GroupedNet(), 3)
    frames = np.random.default_rng(4).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    eng = PoseEngine(_GroupedNet(), flat, input_hw=hw, max_batch_size=2, device="cpu")
    qeng = quant.quantize_engine(eng, [frames])
    g = qeng.model.gconv
    assert isinstance(g, quant.Int8Conv2d) and g.groups == 4 and len(g.parts) == 4
    assert sorted(qeng.quant_scales) == ["conf", "conv0", "gconv", "paf"]
    x = frames.astype(np.float32) / 255.0
    want = jquant.quantized_apply(_JaxGroupedNet(), qeng.quant_scales)(
        nest(flat), jnp.asarray(x))
    with torch.inference_mode():
        got = qeng.model(torch.from_numpy(x))
    for k in ("conf_map", "paf_map"):
        w = np.asarray(want[k])
        assert np.abs(got[k].numpy() - w).max() <= 0.1 * np.abs(w).max(), k
    d = qeng.infer_batch_device(frames)
    assert tuple(d.coords.shape[:1]) == (2,)


# -- the depthwise Int8Conv2d against _quantized_conv(feature_group_count=C) -----------

class _OneDwConv(fnn.Module):
    kernel: int
    strides: int = 1
    dilation: int = 1
    use_bias: bool = False
    dtype: jnp.dtype = jnp.float32

    @fnn.compact
    def __call__(self, x):
        c = x.shape[-1]
        return fnn.Conv(c, (self.kernel, self.kernel), strides=self.strides,
                        kernel_dilation=self.dilation, padding="SAME", feature_group_count=c,
                        use_bias=self.use_bias, dtype=self.dtype, name="dwconv")(x)


DW_CASES = {   # channels, kernel, stride, dilation, input dtype, bias, batch, (H, W)
    "3x3_c32": (32, 3, 1, 1, "float32", False, 2, HW),
    "3x3_c64_stride2": (64, 3, 2, 1, "float32", False, 2, HW),     # pads 0 and 1
    "3x3_c48_stride2_odd": (48, 3, 2, 1, "bfloat16", False, 1, (37, 45)),
    "3x3_c512_dil2": (512, 3, 1, 2, "float32", False, 1, (23, 29)),  # MobilenetDilated.sep_6
    "1x1_c128": (128, 1, 1, 1, "float32", False, 2, HW),           # a thin stage's out block
    "1x1_c19_bias": (19, 1, 1, 1, "float32", True, 2, (9, 11)),
    "3x3_c1209_bf16": (1209, 3, 1, 1, "bfloat16", False, 1, (11, 13)),  # Cp = 1216
    "3x3_c1152": (1152, 3, 1, 1, "float32", False, 1, (9, 11)),
    "3x3_c185_stride2_dil2_bias_bf16": (185, 3, 2, 2, "bfloat16", True, 2, (19, 25)),
    "3x3_c1209_bias": (1209, 3, 1, 1, "float32", True, 1, (7, 9)),   # Thin's refinement l0
    "1x1_c1209_bf16": (1209, 1, 1, 1, "bfloat16", True, 1, (5, 7)),
}
# The input's memory layout, channels-last unless named here (the port's
# networks run channels-last; the kernel reads any strides).
DW_NCHW = {"3x3_c96_bf16_nchw": (96, 3, 1, 1, "bfloat16", True, 2, (13, 17))}
DW_CASES.update(DW_NCHW)


def _dw_run(case):
    c, k, stride, dil, dt, use_bias, batch, hw = DW_CASES[case]
    rng = np.random.default_rng(c * 5 + k + stride)
    x = rng.normal(0, 1, (batch, *hw, c)).astype(np.float32)
    kernel = (rng.normal(0, 1, (k, k, 1, c)) / k).astype(np.float32)
    params = {"kernel": kernel}
    if use_bias:
        params["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    s_abs = float(jnp.max(jnp.abs(xj.astype(jnp.float32))))
    jmod = _OneDwConv(k, stride, dil, use_bias, jdt)
    want = jquant.quantized_apply(jmod, {"dwconv": s_abs})({"params": {"dwconv": params}}, xj)
    # JAX's s32 sums, from _quantized_conv's own formulas (quant.py:130-153).
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-8) / 127.0
    w_q = jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)
    x_q = jnp.clip(jnp.round(xj.astype(jnp.float32) * (1.0 / (s_abs / 127.0))), -127, 127
                   ).astype(jnp.int8)
    dn = lax.conv_dimension_numbers(x_q.shape, w_q.shape, ("NHWC", "HWIO", "NHWC"))
    acc_want = lax.conv_general_dilated(x_q, w_q, (stride, stride), "SAME",
                                        rhs_dilation=(dil, dil), dimension_numbers=dn,
                                        feature_group_count=c,
                                        preferred_element_type=jnp.int32)
    tdt = getattr(torch, dt)
    model = DepthwiseConv(c, k, stride, dil, tdt).eval()
    if use_bias:
        model.dwconv.bias = torch.nn.Parameter(torch.zeros(c, dtype=tdt))
    quant.quantize_model(model, {"dwconv": s_abs},
                         weights={f"params/dwconv/{n}": v for n, v in params.items()})
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    if case in DW_NCHW:
        xt = xt.contiguous()
    with torch.inference_mode():
        got = model(xt)
        q = model.dwconv
        span = dil * (k - 1) + 1
        xin = F.pad(xt, same_pads(xt.shape[-2:], span, stride)) if stride > 1 else xt
        acc = int8_dwconv_sums_plain(q.quantize(xin), q.w_taps, *q.taps_geometry)[:, :c]
    return q, got, np.asarray(want.astype(jnp.float32)), acc, np.asarray(acc_want)


@pytest.mark.parametrize("case", list(DW_CASES))
def test_int8_dwconv_matches_jax_quantized_conv(case):
    """A depthwise `Int8Conv2d` (taps [kh, kw, Cp], Cp = C rounded up to
    32): its s32 sums equal JAX's int8 conv with feature_group_count = C
    exactly, and its output (the fused `int8_dwconv`'s plain version through
    `quantized_apply`) equals `_quantized_conv`'s bit for bit; 3x3 and 1x1
    taps, stride 1 and 2 (padded first, as `DepthwiseConv` pads), dilation
    2, channel counts that are not multiples of 32 (1209 among them), a
    bias, and an NCHW-contiguous bf16 input beside the channels-last ones."""
    q, got, want, acc, acc_want = _dw_run(case)
    assert isinstance(q, quant.Int8Conv2d) and q.depthwise and not q.folded
    c = q.out_channels
    assert q.w_taps.shape == (*q.kernel_size, -(-c // 32) * 32)
    b, ho, wo, _ = acc_want.shape
    np.testing.assert_array_equal(acc.numpy().reshape(b, ho, wo, c), acc_want)
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int8_dwconv_weight_scales_are_per_channel():
    """`weight_scales` of a [kh, kw, 1, C] kernel: JAX's s_w, the max over
    axes 0, 1 and 2, one scale a channel."""
    k = np.random.default_rng(21).normal(0, 1, (3, 3, 1, 40)).astype(np.float32)
    w_q, s_w = quant.weight_scales(k)
    want = jnp.maximum(jnp.max(jnp.abs(k), axis=(0, 1, 2)), 1e-8) / 127.0
    assert s_w.shape == (40,) and w_q.shape == k.shape
    np.testing.assert_array_equal(s_w, np.asarray(want))


@pytest.mark.parametrize("name", ["hp_int8_gemm", "hp_int8_quantize", "hp_int8_conv",
                                  "hp_int8_dwconv"])
def test_ctypes_signatures_match_the_sources(name):
    """Each entry point's ctypes argument list has one entry per parameter
    of its C declaration in its library's source, pointers where the
    source has pointers (ctypes would pass a pointer given as an int as 32
    bits)."""
    import ctypes
    import re

    from hyperpose_torch.ops.kernels import build
    from hyperpose_torch.ops.kernels.int8_gemm import _SIGS

    lib, argtypes = _SIGS[name]
    src = (build.CSRC / f"{lib}.cu").read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1).split(",")
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)


def test_int8_dwconv_cpu_takes_the_plain_version():
    """On CPU tensors the fused wrapper is its plain version (the quantize's
    and the conv's plain versions in turn) and counts no launch; the plain
    sums equal a float64 grouped conv of the same integers."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(0, 1, (2, 50, 9, 11)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64), dtype=np.int8))
    dq = torch.from_numpy(rng.uniform(1e-4, 1e-3, 50).astype(np.float32))
    inv_s = float(np.float32(127 / 2.5))
    geom = ((2, 1), (1, 1), (1, 2))
    before = int8_dwconv.launches
    got = int8_dwconv(x, inv_s, w, dq, None, *geom)
    assert int8_dwconv.launches == before
    xq = int8_quantize_plain(x, inv_s, 64)
    assert torch.equal(got, int8_dwconv_fused_plain(x, inv_s, w, dq, None, *geom))
    assert torch.equal(got, int8_dwconv_plain(xq, w, dq, None, *geom, torch.float32))
    ref = F.conv2d(xq.permute(0, 3, 1, 2).double(), w.permute(2, 0, 1)[:, None].double(),
                   stride=geom[0], padding=geom[1], dilation=geom[2], groups=64)
    sums = int8_dwconv_sums_plain(xq, w, *geom)
    assert got.shape == (2 * ref.shape[2] * ref.shape[3], 50) and got.dtype == x.dtype
    assert torch.equal(sums, ref.permute(0, 2, 3, 1).reshape(-1, 64).to(torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        int8_dwconv(x.to("meta"), inv_s, w.to("meta"), dq.to("meta"), None, *geom)


# -- calibration ---------------------------------------------------------------------

FORMS = {  # port backbone, port remap, JAX backbone, JAX remap
    "plain": (VggTiny, None, JB.VggTiny, None),
    "s2d": (VggTinyS2DStem, remap_vggtiny_to_s2d, JB.VggTinyS2DStem,
            JB.remap_vggtiny_to_s2d),
    "fused": (VggTinyFusedStem, remap_vggtiny_to_fused,
              lambda **kw: JB.VggTinyFusedStem(interpret=True, **kw),
              JB.remap_vggtiny_to_fused),
}


def _form(form, dtype=torch.float32):
    """(port model, its flat weights, JAX model, its variables) of the
    flagship in one serving form."""
    port_bb, port_remap, jax_bb, jax_remap = FORMS[form]
    flat = flagship_flat()
    pflat = flat if port_remap is None else port_remap(flat)
    jvars = nest(flat) if jax_remap is None else jax_remap(nest(flat))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    model = load_flax_weights(LightWeightOpenPose(backbone=port_bb, dtype=dtype), pflat)
    return model.eval(), pflat, JaxLwOpenPose(backbone=jax_bb, dtype=jdt), jvars


def _images(seed=1, n=2):
    return np.random.default_rng(seed).random((n, *HW, 3), np.float32)


@pytest.mark.parametrize("form", list(FORMS))
def test_calibrate_covers_all_convs_as_jax_does(form):
    model, _, jmodel, jvars = _form(form)
    x = _images()
    want = jquant.calibrate(jmodel, jvars, [jnp.asarray(x)], train=False)
    got = quant.calibrate(model, [torch.from_numpy(x)])
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert len(got) == n_convs == (39 if form == "fused" else 40)
    assert list(got) == list(want)
    assert all(v > 0 for v in got.values())
    np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                               rtol=1e-5, atol=0)


# -- quantized networks ----------------------------------------------------------------

def jax_int8_convs(jmodel, jvars, x, scales) -> dict:
    """{conv path: (its input, its output)} of every conv of JAX's
    `quantized_apply` on x, run eagerly, captured by a flax interceptor
    around `make_interceptor`'s (NHWC numpy arrays)."""
    inner = jquant.make_interceptor(scales)
    seen = {}

    def outer(next_fun, args, kwargs, context):
        out = inner(next_fun, args, kwargs, context)
        m = context.module
        if isinstance(m, fnn.Conv) and context.method_name == "__call__":
            seen["/".join(m.path)] = (np.asarray(args[0]), np.asarray(out))
        return out

    with fnn.intercept_methods(outer):
        jmodel.apply(jvars, jnp.asarray(x), train=False)
    return seen


def assert_convs_exact_on_jax_inputs(model, seen) -> None:
    """Each `Int8Conv2d` of the port's quantized `model`, fed the input JAX's
    conv of the same path was given, returns JAX's output bit for bit. A
    strided conv is padded first (`same_pads`), as the port's ConvBN pads
    before its conv; the zeros quantize to zero."""
    for path, (xin, want) in seen.items():
        conv = model.get_submodule(path.replace("/", "."))
        assert isinstance(conv, quant.Int8Conv2d), path
        x = torch.from_numpy(np.array(xin)).permute(0, 3, 1, 2)
        if conv.stride != (1, 1):
            span = conv.dilation[0] * (conv.kernel_size[0] - 1) + 1
            x = F.pad(x, same_pads(x.shape[-2:], span, conv.stride[0]))
        with torch.inference_mode():
            got = conv(x).permute(0, 2, 3, 1).float().numpy()
        want = want.astype(np.float32)
        assert got.shape == want.shape, path
        n_diff = int((got != want).sum())
        assert n_diff == 0, f"{path}: {n_diff} values differ, by up to {np.abs(got - want).max()}"


def _synth_input():
    return resize_bilinear(synth_frame_rgb(), HW)[None].astype(np.float32) / 255.0


def test_int8_convs_exact_on_jax_captured_inputs():
    """Every one of the 40 int8 convs of the plain f32 flagship, on the very
    input JAX's `quantized_apply` gave the conv of the same path (the
    synthetic frame, JAX's scale table), equals JAX's `_quantized_conv`
    output bit for bit: quantize, s32 sums, dequantize and bias."""
    model, pflat, jmodel, jvars = _form("plain")
    x = _synth_input()
    scales = jquant.calibrate(jmodel, jvars, [jnp.asarray(x)], train=False)
    seen = jax_int8_convs(jmodel, jvars, x, scales)
    assert len(seen) == len(scales) == 40
    quant.quantize_model(model, scales, weights=pflat)
    assert_convs_exact_on_jax_inputs(model, seen)


def test_float_batchnorm_within_two_ulps_of_flax():
    """The port's float BatchNorm (`nn.BatchNorm2d`: x * a + (bias - mean * a),
    a = scale / sqrt(var + eps)) and flax's ((x - mean) * (scale *
    rsqrt(var + eps)) + bias) on the same input, flagship block_0 on the
    synthetic frame: within 2 float32 ulps of the map's largest |value|.
    The two formulas round differently, and XLA's CPU rsqrt is an
    approximation whose last place depends on the CPU's vector ISA
    (measured on one AMD EPYC host: it differed from torch.rsqrt in 14 of 32
    channels, and the maps by up to 1 such ulp in 110,109 of 163,840
    values; on another host they agreed). This is why the int8 networks
    below are held to a tolerance, not to an ulp."""
    model, _, jmodel, jvars = _form("plain")
    x = _synth_input()
    seen = {}

    def observer(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        path = "/".join(context.module.path)
        if context.method_name == "__call__" and path.startswith("backbone/block_0/"):
            seen[path.rsplit("/", 1)[1]] = np.asarray(out)
        return out

    with fnn.intercept_methods(observer):
        jmodel.apply(jvars, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = model.backbone.block_0.bn(torch.from_numpy(np.array(seen["conv"])).permute(0, 3, 1, 2))
    want = seen["bn"]
    ulp = np.spacing(np.abs(want).max())
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 2 * ulp


TOL = 0.1


@pytest.mark.parametrize("form,dtype", [  # the ids are the names these cases had
    pytest.param("plain", torch.float32, id="plain-dtype0-None"),
    pytest.param("fused", torch.float32, id="fused-dtype1-0.1"),
    pytest.param("plain", torch.bfloat16, id="plain-dtype2-0.1")])
def test_quantize_model_matches_jax_quantized_apply(form, dtype):
    """JAX's scale table on the same weights and image (the synthetic
    frame): the port's int8 network against `quantized_apply`, every map
    within `TOL` of its largest |value| (JAX's own int8-vs-float bound is
    0.15, tests/test_quant.py:53). Each int8 conv is bit-exact alone
    (`test_int8_convs_exact_on_jax_captured_inputs`); between them the two
    packages' elementwise float ops (BatchNorm's formula and XLA's rsqrt,
    bf16 roundings) differ in the last place (and the fused stem's float32
    block_1 sums run in another order), which now and then flips an int8
    rounding, and the flips grow through the network. Measured max |d| /
    max |v| (conf, paf): f32 plain 0.030 and 0.028 on a host whose XLA rsqrt
    rounds as torch's does not (0 and 0 where it does); f32 fused 0.031
    and 0.048; bf16 0.035 and 0.051, where the two packages' float bf16
    networks already differ by up to 0.043. With a uniform-random second
    image in the batch the f32 maps differ by up to 0.023 (conf) and 0.20
    (its paf, whose values are small)."""
    model, pflat, jmodel, jvars = _form(form, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x = _synth_input()
    scales = jquant.calibrate(jmodel, jvars, [jnp.asarray(x, jdt)], train=False)
    want = jquant.quantized_apply(jmodel, scales)(jvars, jnp.asarray(x, jdt), train=False)
    quant.quantize_model(model, scales, weights=pflat)
    assert sum(isinstance(m, quant.Int8Conv2d) for m in model.modules()) == len(scales)
    assert not any(type(m) is torch.nn.Conv2d for m in model.modules())
    with torch.inference_mode():
        got = model(torch.from_numpy(x).to(dtype))
    for key in ("conf_map", "paf_map"):
        w = np.asarray(want[key].astype(jnp.float32))
        g = got[key].float().numpy()
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= TOL, f"{key}: max |d| / max |v| = {rel}"


def test_skip_all_keeps_the_float_model():
    model, pflat, *_ = _form("plain")
    x = torch.from_numpy(_images(seed=3))
    with torch.inference_mode():
        ref = model(x)["conf_map"]
    scales = quant.calibrate(model, [x])
    quant.quantize_model(model, scales, skip=lambda p: True, weights=pflat)
    assert not any(isinstance(m, quant.Int8Conv2d) for m in model.modules())
    with torch.inference_mode():
        assert torch.equal(model(x)["conf_map"], ref)


def test_bf16_model_quantizes_the_float32_weights():
    """A bf16 model holds rounded weights: with the float32 checkpoint the
    int8 weights are those of the checkpoint; without it, quantizing
    raises."""
    model, pflat, *_ = _form("plain", torch.bfloat16)
    scales = {"backbone/block_2/conv": 1.5, "cpm/init": 2.0}
    with pytest.raises(ValueError, match="float32"):
        quant.quantize_model(model, scales)
    quant.quantize_model(model, scales, weights=pflat)
    q = model.backbone.block_2.conv
    w_q, s_w = quant.weight_scales(pflat["params/backbone/block_2/conv/kernel"])
    cin, cout = w_q.shape[2:]
    assert torch.equal(q.w_taps[:cout, :, :, :cin], torch.from_numpy(w_q.transpose(3, 0, 1, 2)))
    assert torch.equal(q.s_w, torch.from_numpy(s_w))
    assert torch.equal(model.cpm.init.bias,
                       torch.from_numpy(pflat["params/cpm/init/bias"]))


# -- the int8 artifact, both directions ---------------------------------------------------

def _assert_same_artifact(a, b):
    (sa, ta), (sb, tb) = a, b
    assert sa == pytest.approx(sb, rel=0, abs=0)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_jax_artifact_loads_in_the_port(tmp_path):
    model, pflat, jmodel, jvars = _form("plain")
    x = _images(seed=4)
    scales = jquant.calibrate(jmodel, jvars, [jnp.asarray(x)], train=False)
    path = str(tmp_path / "jax_int8.npz")
    jquant.export_quantized(jmodel, jvars, scales, path)
    _assert_same_artifact(quant.load_quantized(path), jquant.load_quantized(path))
    loaded_scales, tensors = quant.load_quantized(path)
    deq = quant.dequantized_params(FLAGSHIP_NPZ, tensors)
    want = jax.device_get(jquant.dequantized_params(jvars, tensors))
    flat_want = {"/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(v)
                 for kp, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(deq) == sorted(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(deq[k], v, err_msg=k)
    # Re-quantizing the dequantized weights gives the same int8 network.
    xt = torch.from_numpy(x)
    outs = []
    for w in (pflat, deq):
        m = load_flax_weights(LightWeightOpenPose(backbone=VggTiny), w).eval()
        quant.quantize_model(m, loaded_scales, weights=w)
        with torch.inference_mode():
            outs.append(m(xt)["conf_map"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-6)


def test_port_artifact_loads_in_jax(tmp_path):
    model, pflat, jmodel, jvars = _form("plain")
    x = _images(seed=5)
    scales = quant.calibrate(model, [torch.from_numpy(x)])
    ours, theirs = str(tmp_path / "port_int8.npz"), str(tmp_path / "jax_int8.npz")
    quant.export_quantized(FLAGSHIP_NPZ, scales, ours)
    jquant.export_quantized(jmodel, jvars, scales, theirs)
    _assert_same_artifact(jquant.load_quantized(ours), jquant.load_quantized(theirs))
    assert any(k.startswith("f::['batch_stats']") for k in jquant.load_quantized(ours)[1])
    loaded_scales, tensors = jquant.load_quantized(ours)
    deq = jquant.dequantized_params(jvars, tensors)
    q_apply = jquant.quantized_apply(jmodel, loaded_scales)
    a = np.asarray(q_apply(jvars, jnp.asarray(x), train=False)["conf_map"])
    b = np.asarray(q_apply(deq, jnp.asarray(x), train=False)["conf_map"])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
