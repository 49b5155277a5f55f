"""PyTorch port of the tracking features against the JAX package (CPU).

Seeded numpy inputs go through ``shrimpy_tpu/ops/features.py`` and
``shrimpy_tpu_torch/ops/features.py``. Tolerances: the blur within 1e-6 of
JAX's (float32 taps summed in another order) and 1e-3 of scipy's float64
``gaussian_filter(mode="reflect")`` (the JAX test's budget); histogram counts,
percentiles and multi-Otsu thresholds equal, bin for bin and bit for bit;
multi-Otsu against the float64 brute-force oracle within 1e-3; centres of
mass within 1e-4 px of JAX's (float32 sums in another order).
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from shrimpy_tpu.io.synthetic import gaussian_blob
from shrimpy_tpu.ops import features as jf
from shrimpy_tpu_torch.ops import features as tf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
BLUR_RTOL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _volume(seed: int, shape=(8, 20, 24)) -> np.ndarray:
    r = np.random.default_rng(seed)
    return (r.random(shape) * r.uniform(1, 1000) - r.uniform(0, 50)).astype(np.float32)


@pytest.mark.parametrize("shape,sigma", [
    ((10, 24, 24), (1.5, 2.0, 2.0)),
    ((8, 20, 17), 5.0),  # radius 20: past every axis
    ((6, 30, 9), (0.0, 3.0, 0.7)),
    ((40, 33), (2.5, 0.0)),
])
def test_blur_matches_jax_and_scipy(shape, sigma):
    vol = np.random.default_rng(1).random(shape, dtype=np.float32) * 10.0
    ours = tf.gaussian_blur(vol, sigma, device="cpu")
    assert ours.dtype == torch.float32 and tuple(ours.shape) == shape
    assert _rel(ours.numpy(), np.asarray(jf.gaussian_blur(vol, sigma))) <= BLUR_RTOL
    oracle = ndimage.gaussian_filter(vol.astype(np.float64), sigma, mode="reflect", truncate=4.0)
    assert _rel(ours.numpy(), oracle) <= 1e-3
    # The float64 path is scipy's within float64 roundoff of the float32 taps.
    ours64 = tf.gaussian_blur(vol, sigma, device="cpu", dtype=torch.float64)
    assert ours64.dtype == torch.float64 and _rel(ours64.numpy(), ours.numpy()) <= BLUR_RTOL


def test_blur_zero_sigma_is_identity():
    vol = np.random.default_rng(2).random((6, 16, 16), dtype=np.float32)
    torch.testing.assert_close(tf.gaussian_blur(vol, 0.0, device="cpu"), torch.from_numpy(vol))


def test_gaussian_kernel_is_the_original():
    """``_gaussian_kernel`` is a copy: the same statements, the same taps."""
    def fn(path):
        tree = ast.parse(path.read_text())
        node = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                    and n.name == "_gaussian_kernel")
        node.body = node.body[1:]  # the docstring
        return ast.dump(node)

    assert fn(REPO / "shrimpy_tpu_torch/ops/features.py") == fn(REPO / "shrimpy_tpu/ops/features.py")
    for s in (0.3, 1.0, 5.0):
        np.testing.assert_array_equal(tf._gaussian_kernel(s), jf._gaussian_kernel(s))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("bins", [256, 4096])
def test_histogram_counts_equal_jax(seed, bins):
    vol = _volume(seed)
    lo, span, counts = jf._histogram(jnp.asarray(vol).ravel(), bins)
    tlo, tspan, tcounts = tf._histogram(torch.from_numpy(vol).reshape(-1), bins)
    assert tcounts.dtype == torch.int32
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    assert float(tlo) == float(lo) and float(tspan) == float(span)


@pytest.mark.parametrize("seed", range(8))
def test_percentile_and_multi_otsu_equal_jax(seed):
    vol = _volume(seed)
    for q in (5.0, 37.5, 50.0, 99.0, 99.99):
        ours = tf.histogram_percentile(vol, q, device="cpu")
        assert ours.dim() == 0
        assert ours.numpy() == np.asarray(jf.histogram_percentile(vol, q)), q
    ours = tf.multi_otsu(vol, device="cpu").numpy()
    np.testing.assert_array_equal(ours, np.asarray(jf.multi_otsu(vol)))


def test_percentile_brackets_the_order_statistic():
    vol = np.random.default_rng(3).normal(100.0, 15.0, size=(16, 64, 64)).astype(np.float32)
    span = vol.max() - vol.min()
    for q in (50.0, 99.0, 99.99):
        ours = float(tf.histogram_percentile(vol, q, device="cpu"))
        oracle = float(np.percentile(vol, q, method="higher"))
        assert abs(ours - oracle) <= span / 4096 + 1e-3 * span


def test_multi_otsu_matches_bruteforce():
    rng = np.random.default_rng(4)
    vol = np.concatenate([rng.normal(10, 2, 4000), rng.normal(100, 5, 2000),
                          rng.normal(200, 8, 1000)]).astype(np.float32)
    ours = tf.multi_otsu(vol, bins=64, device="cpu").numpy()
    np.testing.assert_allclose(ours, tf.multi_otsu_reference(vol, bins=64), atol=1e-3)
    np.testing.assert_array_equal(tf.multi_otsu_reference(vol, bins=64),
                                  jf.multi_otsu_reference(vol, bins=64))
    assert 10 < ours[0] < 100 < ours[1] < 200
    with pytest.raises(NotImplementedError, match="classes=3"):
        tf.multi_otsu(vol, classes=4, device="cpu")


@pytest.mark.parametrize("case", ["blob", "noise", "zero"])
def test_center_of_mass_matches_jax(case):
    if case == "blob":
        vol = gaussian_blob((16, 32, 32), (5.0, 20.0, 12.0), (1.5, 2.0, 2.0))
    elif case == "noise":
        vol = _volume(5, (9, 31, 40))
    else:
        vol = np.zeros((8, 16, 16), np.float32)
    ours = tf.center_of_mass(vol, device="cpu").numpy()
    np.testing.assert_allclose(ours, np.asarray(jf.center_of_mass(vol)), rtol=0, atol=1e-4)
    if case == "zero":
        np.testing.assert_array_equal(ours, [3.5, 7.5, 7.5])
    if case == "blob":
        np.testing.assert_allclose(ours, [5.0, 20.0, 12.0], atol=0.1)


@pytest.mark.parametrize("component", [0, 1])
def test_otsu_component_mask_matches_jax(component):
    rng = np.random.default_rng(6)
    vol = gaussian_blob((12, 32, 32), (6.0, 16.0, 16.0), (2.0, 3.0, 3.0), 200.0)
    vol += gaussian_blob((12, 32, 32), (4.0, 8.0, 24.0), (1.0, 2.0, 2.0), 90.0)
    vol += rng.normal(0, 1.0, vol.shape).astype(np.float32)
    mask, blurred = tf.otsu_component_mask(vol, component=component, sigma=1.0, device="cpu")
    jmask, jblurred = jf.otsu_component_mask(vol, component=component, sigma=1.0)
    assert _rel(blurred.numpy(), np.asarray(jblurred)) <= BLUR_RTOL
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask[6, 16, 16] == 1.0 and mask[0, 0, 0] == 0.0
    simple = tf.binary_mask(vol, 100.0, device="cpu")
    assert simple.dtype == torch.float32
    np.testing.assert_array_equal(simple.numpy(), np.asarray(jf.binary_mask(vol, 100.0)))


@pytest.mark.parametrize("component", [-1, 2])
def test_otsu_component_out_of_range_raises(component):
    vol = _volume(7)
    with pytest.raises(ValueError, match="otsu_component must be 0"):
        tf.otsu_component_mask(vol, component=component, device="cpu")
