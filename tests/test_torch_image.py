"""The port's image ops against `hyperpose_tpu.ops.image` (device ops) and
OpenCV (host resize and colour conversion)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (single-threaded torch)
from hyperpose_tpu.ops import image as jimg
from hyperpose_torch.ops import image as timg

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("ksize,sigma", [(5, 0.75), (17, 3.0), (1, 1.0)])
def test_gaussian_smooth_matches_jax(ksize, sigma):
    """Reflect-101 borders and cv2's kernel; atol 1e-6 on values in [0, 1)
    (the two sum the taps in another order)."""
    x = np.random.default_rng(ksize).uniform(0, 1, (2, 20, 24, 5)).astype(np.float32)
    want = np.asarray(jimg.gaussian_smooth_nhwc(jnp.asarray(x), ksize, sigma))
    got = timg.gaussian_smooth_nhwc(torch.from_numpy(x), ksize, sigma).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_gaussian_kernel_matches_cv2():
    for ksize, sigma in ((5, 0.75), (17, 3.0)):
        ref = cv2.getGaussianKernel(ksize, sigma).ravel()
        np.testing.assert_allclose(timg._gaussian_kernel_1d(ksize, sigma), ref,
                                   rtol=0, atol=1e-7)


def test_same_max_pool_matches_jax():
    """-inf padding: negative maps must not see a zero border (exact)."""
    x = np.random.default_rng(1).uniform(-2, -1, (2, 9, 11, 3)).astype(np.float32)
    want = np.asarray(jimg.same_max_pool_3x3_nhwc(jnp.asarray(x)))
    got = timg.same_max_pool_3x3_nhwc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_yuv420_to_rgb_matches_jax():
    """atol 1e-4 on values in 0..255, i.e. a few float32 ulps: XLA may fuse
    the colour matrix's multiply-adds."""
    yuv = np.random.default_rng(2).integers(0, 256, (2, 48, 40), np.uint8)
    want = np.asarray(jimg.yuv420_to_rgb(jnp.asarray(yuv)))
    got = timg.yuv420_to_rgb(torch.from_numpy(yuv)).numpy()
    assert got.shape == (2, 32, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_yuv420_rejects_odd_sizes():
    with pytest.raises(ValueError):
        timg.yuv420_to_rgb(torch.zeros(1, 15, 9, dtype=torch.uint8))


def test_rgb_to_yuv420_near_cv2():
    """The numpy encoder stays within 2 code values of cv2's I420, the
    bound the JAX package holds its own numpy fallback to."""
    rgb = np.random.default_rng(3).integers(0, 256, (32, 48, 3), np.uint8)
    got = timg.rgb_to_yuv420(rgb)
    ref = cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)
    assert got.shape == ref.shape == (48, 48)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((427, 640), (368, 432)),   # the synthetic frame to the serving size
    ((50, 70), (368, 432)),     # upscale
    ((37, 91), (16, 24)),       # downscale, odd sizes
])
def test_resize_within_one_level_of_cv2(src_hw, dst_hw):
    img = np.random.default_rng(sum(src_hw)).integers(0, 256, (*src_hw, 3), np.uint8)
    got = timg.resize_bilinear(img, dst_hw)
    ref = cv2.resize(img, (dst_hw[1], dst_hw[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_resize_same_size_is_identity():
    img = np.random.default_rng(0).integers(0, 256, (23, 31, 3), np.uint8)
    np.testing.assert_array_equal(timg.resize_bilinear(img, (23, 31)), img)


@pytest.mark.parametrize("keep_ratio", [False, True])
def test_resize_matches_jax_native_runtime(keep_ratio):
    """Bit-exact with the JAX package's native resize (the bytes its
    engine feeds the network), plain and letterboxed."""
    from hyperpose_tpu.runtime import native

    if native.get_lib() is None:
        pytest.skip("the JAX package's native runtime did not build here")
    img = np.random.default_rng(5).integers(0, 256, (427, 640, 3), np.uint8)
    batch = np.zeros((1, 368, 432, 3), np.uint8)
    rx, ry = native.resize_into_batch(img, batch, 0, keep_ratio=keep_ratio)
    if keep_ratio:
        got, grx, gry = timg.letterbox_resize(img, (368, 432))
        assert (grx, gry) == pytest.approx((rx, ry), abs=1e-6)
    else:
        got = timg.resize_bilinear(img, (368, 432))
    np.testing.assert_array_equal(got, batch[0])


def test_letterbox_matches_jax_ratios():
    img = np.random.default_rng(6).integers(0, 256, (300, 200, 3), np.uint8)
    want, wrx, wry = jimg.letterbox_resize(img, (368, 432))
    got, rx, ry = timg.letterbox_resize(img, (368, 432))
    assert (rx, ry) == (wrx, wry)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
