"""PyTorch port: the FFT sizing and shape helpers and the phase
cross-correlation, against the JAX package (CPU).

``utils/fft.py``'s copies give JAX's sizes and arrays exactly (pads and
crops move values, they compute none). The shifts agree within 1e-4 px:
integer shifts exactly, the parabolic and DFT sub-pixel steps to float32
rounding of the same correlation surface (``torch.fft`` against
``jnp.fft``, both float32/complex64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimpy_tpu.io.synthetic import gaussian_blob
from shrimpy_tpu.ops.pcc import phase_cross_correlation as jax_pcc
from shrimpy_tpu.utils import fft as jfft
from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
from shrimpy_tpu_torch.utils import fft as tfft

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

SHIFT_ATOL = 1e-4


def test_next_fast_len_equals_jax_up_to_5000():
    assert [tfft.next_fast_len(n) for n in range(5001)] == [
        jfft.next_fast_len(n) for n in range(5001)]


@pytest.mark.parametrize("shape", [(128, 2888, 1600), (64, 256, 256), (12, 31, 7), (1, 97)])
@pytest.mark.parametrize("maximum_shift", [1.0, 1.5, 0.5])
def test_fast_fft_shape_equals_jax(shape, maximum_shift):
    assert tfft.fast_fft_shape(shape, maximum_shift) == jfft.fast_fft_shape(shape, maximum_shift)


def test_tpu_lane_rule_is_not_ported():
    """The PCC's ``tpu_lanes`` grid is not ported; ``next_fast_len_tpu``
    is (the FFT RL's grid keeps JAX's rule) and equals the original."""
    with pytest.raises(NotImplementedError, match="tpu_lanes"):
        tfft.fast_fft_shape((8, 8), tpu_lanes=True)
    assert [tfft.next_fast_len_tpu(n) for n in range(5001)] == [
        jfft.next_fast_len_tpu(n) for n in range(5001)]


@pytest.mark.parametrize("mode", ["reflect", "constant"])
@pytest.mark.parametrize("src,dst", [
    ((6, 9, 5), (10, 9, 5)),     # pad z
    ((6, 9, 5), (4, 7, 3)),      # crop every axis
    ((6, 9, 5), (8, 5, 11)),     # pad and crop mixed
    ((3, 9, 2), (11, 9, 9)),     # pads wider than their axis
    ((1, 4, 4), (5, 4, 4)),      # a single plane
])
def test_match_shape_equals_jax(src, dst, mode):
    x = np.random.default_rng(4).random(src).astype(np.float32)
    want = np.asarray(jfft.match_shape(jnp.asarray(x), dst, mode=mode))
    got = tfft.match_shape(torch.from_numpy(x), dst, mode=mode)
    assert tuple(got.shape) == dst
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["reflect", "edge", "symmetric", "wrap"])
def test_pad_reflects_past_the_axis_as_jnp_pad(mode):
    """The index pad takes a reflection wider than its axis as numpy and
    ``jnp.pad`` do (``torch.nn.functional.pad`` refuses it)."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    width = ((7, 5), (2, 9))
    want = np.asarray(jnp.pad(jnp.asarray(x), width, mode=mode))
    np.testing.assert_array_equal(tfft._pad(torch.from_numpy(x), width, mode).numpy(), want)


def test_center_crop_and_pad_refuse_wrong_shapes():
    x = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="smaller"):
        tfft.center_crop(x, (5, 5))
    with pytest.raises(ValueError, match="larger"):
        tfft.pad_to_shape(x, (3, 5))


def _blob_pair(shape, shift):
    center = tuple(s / 2 for s in shape)
    ref = gaussian_blob(shape, center, (2.0, 4.0, 4.0), amplitude=100.0)
    mov = gaussian_blob(shape, tuple(c + d for c, d in zip(center, shift)), (2.0, 4.0, 4.0),
                        amplitude=100.0)
    noise = np.random.default_rng(9).normal(0.0, 0.5, (2, *shape)).astype(np.float32)
    return ref + noise[0], mov + noise[1]


@pytest.mark.parametrize("maximum_shift", [1.0, 1.5])
@pytest.mark.parametrize("upsample", [None, "parabolic", "dft"])
@pytest.mark.parametrize("shift", [(1.3, -4.6, 2.2), (-2.0, 3.0, 0.0)])
def test_pcc_equals_jax(shift, upsample, maximum_shift):
    ref, mov = _blob_pair((16, 48, 40), shift)
    want = jax_pcc(ref, mov, maximum_shift, upsample=upsample, upsample_factor=20,
                   transform="xla")
    got = phase_cross_correlation(ref, mov, maximum_shift, upsample=upsample,
                                  upsample_factor=20, device="cpu")
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHIFT_ATOL)
    np.testing.assert_allclose(got, shift, atol=0.6 if upsample is None else 0.2)


@pytest.mark.parametrize("upsample", [None, "parabolic", "dft"])
def test_pcc_2d_rolled_and_mismatched_shapes_equal_jax(upsample):
    rng = np.random.default_rng(7)
    ref = rng.random((30, 40), dtype=np.float32)
    mov = np.roll(ref, (4, -6), axis=(0, 1))[:28, :40]
    want = jax_pcc(ref, mov, upsample=upsample, transform="xla")
    got = phase_cross_correlation(ref, mov, upsample=upsample, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=SHIFT_ATOL)
    assert got[1] == -6.0 or upsample is not None


def test_pcc_transforms_all_map_to_torch_fft():
    ref, mov = _blob_pair((12, 32, 24), (1.4, -2.2, 3.1))
    runs = [phase_cross_correlation(ref, mov, upsample="dft", transform=t, device="cpu")
            for t in ("auto", "xla", "matmul")]
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
    with pytest.raises(ValueError, match="transform"):
        phase_cross_correlation(ref, mov, transform="dft2z", device="cpu")
    with pytest.raises(ValueError, match="upsample"):
        phase_cross_correlation(ref, mov, upsample="cubic", device="cpu")


def test_pcc_rim_peak_keeps_the_integer_estimate():
    """A peak on the rim of an axis takes no parabolic step on it."""
    ref = np.zeros((8, 8), np.float32)
    ref[1, 2] = 1.0
    mov = np.roll(ref, (4, 1), axis=(0, 1))  # the peak lands on index 0 of axis 0
    want = jax_pcc(ref, mov, upsample="parabolic", transform="xla")
    got = phase_cross_correlation(ref, mov, upsample="parabolic", device="cpu")
    np.testing.assert_allclose(got, want, atol=SHIFT_ATOL)
    assert got[0] == 4.0
