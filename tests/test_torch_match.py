"""PyTorch port of NCC template matching against the JAX package (CPU).

``shrimpy_tpu_torch/ops/match.py`` against ``shrimpy_tpu/ops/match.py``
on seeded numpy inputs: the NCC surface within 1e-4 (absolute, on values
in [-1, 1]) in 3-D and 2-D, and against the float64 direct formula of
``tests/test_match.py`` within 2e-4 (that test's budget); flat windows give
0; the integral images equal the direct window sums within float32
roundoff; ``template_match_shift`` gives JAX's shift exactly; the bound
errors are raised as JAX raises them.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu.ops import match as jmatch
from shrimpy_tpu_torch.ops import match as tmatch

torch.set_num_threads(1)

NCC_ATOL = 1e-4


def ncc_oracle(mov: np.ndarray, tmpl: np.ndarray) -> np.ndarray:
    """The direct float64 NCC per displacement (``tests/test_match.py``)."""
    mov = mov.astype(np.float64)
    tmpl = tmpl.astype(np.float64)
    tz = tmpl - tmpl.mean()
    ssd = float((tz * tz).sum())
    out_shape = tuple(m - t + 1 for m, t in zip(mov.shape, tmpl.shape))
    out = np.zeros(out_shape)
    for idx in np.ndindex(out_shape):
        win = mov[tuple(slice(i, i + t) for i, t in zip(idx, tmpl.shape))]
        var = float(((win - win.mean()) ** 2).sum())
        denom = np.sqrt(var * ssd)
        out[idx] = float((win * tz).sum()) / denom if denom > 1e-10 else 0.0
    return out


@pytest.mark.parametrize("transform", ["auto", "xla", "matmul"])
@pytest.mark.parametrize("shape,window", [
    ((8, 12, 10), (slice(2, 5), slice(3, 7), slice(1, 6))),
    ((11, 17, 23), (slice(0, 11), slice(4, 9), slice(20, 23))),
])
def test_ncc_surface_3d_matches_jax(transform, shape, window):
    rng = np.random.default_rng(10)
    mov = rng.normal(size=shape).astype(np.float32) * 10 + 50
    tmpl = mov[window].copy()
    ours = tmatch.match_template(mov, tmpl, transform=transform, device="cpu")
    want = jmatch.match_template(mov, tmpl, transform=transform)
    assert tuple(ours.shape) == want.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=NCC_ATOL)
    np.testing.assert_allclose(ours.numpy(), ncc_oracle(mov, tmpl), rtol=0, atol=2e-4)
    ours64 = tmatch.match_template(mov, tmpl, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(ours64.numpy(), ncc_oracle(mov, tmpl), rtol=0, atol=1e-10)
    start = tuple(s.start for s in window)
    peak = np.unravel_index(int(torch.argmax(ours)), tuple(ours.shape))
    assert peak == start and float(ours[peak]) == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("transform", ["xla", "matmul"])
def test_ncc_surface_2d_matches_jax(transform):
    rng = np.random.default_rng(11)
    mov = rng.normal(size=(24, 17)).astype(np.float32)
    tmpl = rng.normal(size=(5, 6)).astype(np.float32)
    ours = tmatch.match_template(mov, tmpl, transform=transform, device="cpu").numpy()
    np.testing.assert_allclose(ours, jmatch.match_template(mov, tmpl, transform=transform),
                               rtol=0, atol=NCC_ATOL)
    np.testing.assert_allclose(ours, ncc_oracle(mov, tmpl), rtol=0, atol=2e-4)


def test_flat_windows_get_zero_ncc():
    rng = np.random.default_rng(12)
    mov = np.zeros((6, 8, 8), np.float32)
    mov[3:, 4:, 4:] = rng.normal(size=(3, 4, 4))
    tmpl = mov[3:5, 4:6, 4:6].copy()
    ours = tmatch.match_template(mov, tmpl, device="cpu")
    assert float(ours[0, 0, 0]) == 0.0
    np.testing.assert_array_equal(ours.numpy() == 0.0, jmatch.match_template(mov, tmpl) == 0.0)
    flat = tmatch.match_template(mov, np.ones((2, 2, 2), np.float32), device="cpu")
    assert not bool(flat.any())  # a flat template carries no signal anywhere


@pytest.mark.parametrize("win", [(1, 1, 1), (3, 2, 5), (7, 9, 4)])
def test_window_sums_are_direct_sums(win):
    x = np.random.default_rng(13).random((7, 9, 11)).astype(np.float64)
    ours = tmatch._window_sums(torch.from_numpy(x), win).numpy()
    out_shape = tuple(n - w + 1 for n, w in zip(x.shape, win))
    direct = np.array([x[tuple(slice(i, i + w) for i, w in zip(idx, win))].sum()
                       for idx in np.ndindex(out_shape)]).reshape(out_shape)
    np.testing.assert_allclose(ours, direct, rtol=1e-12)


@pytest.mark.parametrize("shift,sl", [
    ((1, -3, 4), ((3, 7), (10, 22), (8, 24))),
    ((0, 5, -2), ((0, 10), (0, 12), (20, 32))),
])
def test_template_match_shift_equals_jax(shift, sl):
    rng = np.random.default_rng(14)
    ref = rng.normal(size=(10, 32, 32)).astype(np.float32)
    mov = np.roll(ref, shift, axis=(0, 1, 2))
    want = jmatch.template_match_shift(ref, mov, sl)
    for r in (ref, torch.from_numpy(ref)):  # the reference may stay on the host
        got = tmatch.template_match_shift(r, mov, sl, device="cpu")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, shift)


def test_bound_errors():
    ref = np.random.default_rng(15).normal(size=(4, 8, 8)).astype(np.float32)
    for bad in (((0, 5), (0, 4), (0, 4)), ((2, 2), (0, 4), (0, 4)), ((-1, 2), (0, 4), (0, 4))):
        with pytest.raises(ValueError, match="out of bounds"):
            jmatch.template_match_shift(ref, ref, bad)
        with pytest.raises(ValueError, match="out of bounds"):
            tmatch.template_match_shift(ref, ref, bad, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        jmatch.template_match_shift(ref, ref[:2], ((0, 3), (0, 4), (0, 4)))
    with pytest.raises(ValueError, match="does not fit"):
        tmatch.template_match_shift(ref, ref[:2], ((0, 3), (0, 4), (0, 4)), device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        tmatch.match_template(ref, ref[0, :2, :2], device="cpu")
    with pytest.raises(ValueError, match="transform"):
        tmatch.match_template(ref, ref, transform="dft", device="cpu")
