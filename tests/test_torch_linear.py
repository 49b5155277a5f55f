"""PyTorch port: the ``linear_pallas`` backend against the JAX package (CPU).

The plain versions of its convolution — ``convzy_linear_plain`` (z, then
y taps) and ``x_toeplitz_plain`` (the dense banded-Toeplitz x product
of ``_rl_sep_linear``) — against the dense fp64 zero-boundary oracle of
``tests/test_rl_fused.py``; whole RL runs against JAX
``richardson_lucy(separable_backend="linear_pallas")`` (Pallas interpret
mode; Biggs through the generic loop on both sides) and the port's
``fused`` backend at relative error 1e-4, and against
``richardson_lucy_reference_separable(boundary="zero")`` at 1e-3.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops.conv3_cuda import (
    conv3_half_step,
    conv3_half_step_plain,
    convzy_linear,
    convzy_linear_cuda,
    circulant,
    toeplitz_banded,
    x_toeplitz_plain,
)
from shrimpy_tpu_torch.ops.rl_fused import Stencil, half_step_plain
from tests.test_deconv_separable import asymmetric_psf
from tests.test_rl_fused import _oracle_conv3
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

PSF = jdeconv.gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _asym_terms():
    """Two terms with asymmetric taps (an asymmetric PSF of rank 2)."""
    rng = np.random.default_rng(11)
    return [tuple(rng.random(k).astype(np.float32) for k in (5, 9, 9)) for _ in range(2)]


@pytest.mark.parametrize("n", [1, 9, 40, 131])
@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_toeplitz_banded_equals_original(n, k):
    taps = np.random.default_rng(n * k).random(k).astype(np.float32)
    np.testing.assert_array_equal(toeplitz_banded(n, taps).astype(np.float32),
                                  jdeconv._toeplitz_banded(n, taps))


def _numpy_band(n: int, taps, wrap: bool) -> np.ndarray:
    """The numpy build of :func:`toeplitz_banded` (``wrap`` False) and
    :func:`circulant` before they could build on a device."""
    taps = np.asarray(taps, np.float64)
    r = len(taps) // 2
    mat = np.zeros((n, n), np.float64)
    rows = np.arange(n)
    for i, k in enumerate(taps):
        cols = rows - (i - r)
        if wrap:
            mat[rows, cols % n] += k
        else:
            ok = (cols >= 0) & (cols < n)
            mat[rows[ok], cols[ok]] += k
    return mat


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("n,k", [(1, 3), (9, 13), (40, 7), (131, 13), (60, 37)])
def test_band_matrices_on_a_device_equal_the_numpy_build(n, k, wrap):
    """Built as numpy arrays or as float64 tensors on a device, the x pass's
    dense matrices are the numpy build's bit for bit, taps that wrap onto
    one column included."""
    taps = np.random.default_rng(n + k).random(k).astype(np.float32)
    build = circulant if wrap else toeplitz_banded
    want = _numpy_band(n, taps, wrap)
    np.testing.assert_array_equal(build(n, taps), want)
    got = build(n, taps, torch.device("cpu"))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_linear_conv3_matches_zero_boundary_oracle(flip, dtype):
    """convzy_linear_plain then x_toeplitz_plain, summed over the terms
    of an asymmetric PSF, both tap orders: catches a flipped or shifted
    tap on any axis."""
    terms = _asym_terms()
    grid = (11, 23, 19)
    vol = np.random.default_rng(4).random(grid) * 10.0
    st = Stencil(terms, flip=flip)
    v = torch.from_numpy(vol).to(dtype)
    out = sum(x_toeplitz_plain(convzy_linear(v, wz, wy), wx) for wz, wy, wx in st.host)
    ref = _oracle_conv3(vol, terms, grid, flip)
    assert _rel(out.numpy(), ref) <= (1e-6 if dtype == torch.float32 else 1e-12)
    half = conv3_half_step(v, None, st, "plain", boundary="zero")
    torch.testing.assert_close(half, out, rtol=1e-12, atol=0)
    # The same convolution as the fused route's plain half-step.
    assert _rel(half.numpy(), half_step_plain(v, None, st, "plain").numpy()) <= 1e-6


def test_linear_half_step_epilogues_and_guards():
    terms = _asym_terms()
    rng = np.random.default_rng(8)
    vol = torch.from_numpy((rng.random((10, 30, 26)) * 10 + 0.5).astype(np.float32))
    aux = torch.from_numpy((rng.random((10, 30, 26)) * 5).astype(np.float32))
    conv, adj = Stencil(terms), Stencil(terms, flip=True)
    c = conv3_half_step(vol, aux, conv, "plain", boundary="zero")
    torch.testing.assert_close(conv3_half_step(vol, aux, conv, "ratio", 1e-6, boundary="zero"),
                               aux / torch.clamp_min(c, 1e-6), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(conv3_half_step(vol, aux, adj, "mult", boundary="zero"),
                               aux * conv3_half_step(vol, None, adj, "plain", boundary="zero"),
                               rtol=1e-6, atol=1e-7)
    before = convzy_linear_cuda.launches
    conv3_half_step(vol, aux, conv, "ratio", boundary="zero")
    assert convzy_linear_cuda.launches == before
    with pytest.raises(ValueError, match="mode"):
        conv3_half_step_plain(vol, aux, conv, "ratio_accel", boundary="zero")
    with pytest.raises(ValueError, match="CUDA tensor"):
        convzy_linear_cuda(vol, terms[0][0], terms[0][1])


@pytest.mark.parametrize("acceleration", ["none", "biggs"])
def test_linear_rl_matches_jax_linear_pallas(acceleration):
    """RL-5 at (10, 32, 32) against JAX's linear_pallas (interpret mode);
    Biggs runs the generic loop on both sides."""
    img = _blurred((10, 32, 32), PSF, seed=5)
    s = DeconvolveSettings(algorithm="separable", separable_backend="linear_pallas",
                           iterations=5, acceleration=acceleration)
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(PSF, s.psf_crop_tol))
    terms = jdeconv.plan_separable_terms(psf_w, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, s))
    ours = tdeconv.richardson_lucy(img, PSF, s, terms=terms, device="cpu").numpy()
    err = _rel(ours, ref)
    assert err <= 1e-4, f"rel err {err:.2e}"


@pytest.mark.parametrize("psf_name", ["gaussian", "asymmetric"])
def test_linear_rl_matches_fused_backend(psf_name):
    psf = PSF if psf_name == "gaussian" else asymmetric_psf((5, 9, 9))
    img = _blurred((14, 90, 100), psf, seed=6)
    lin = tdeconv.richardson_lucy(img, psf, deconvolve_settings(
        iterations=6, separable_backend="linear_pallas", separable_tol=1e-6), device="cpu")
    fused = tdeconv.richardson_lucy(img, psf, deconvolve_settings(
        iterations=6, separable_tol=1e-6), device="cpu")
    err = _rel(lin.numpy(), fused.numpy())
    assert err <= 1e-4, f"rel err {err:.2e}"


@pytest.mark.parametrize("pad_mode", ["reflect", "constant"])
def test_linear_rl_matches_zero_boundary_oracle(pad_mode):
    psf = asymmetric_psf((5, 9, 9))
    img = _blurred((12, 40, 36), psf, seed=7)
    s = DeconvolveSettings(iterations=4, pad_mode=pad_mode, separable_tol=1e-6,
                           separable_backend="linear_pallas")
    ours = tdeconv.richardson_lucy(img, psf, s, device="cpu").numpy()
    psf_w = tdeconv.prepare_psf(psf, s)
    oracle = jdeconv.richardson_lucy_reference_separable(
        img, psf, iterations=4, pad_mode=pad_mode, terms=tdeconv.plan_terms(psf_w, s),
        pads=tuple((k // 2, k // 2) for k in psf_w.shape), boundary="zero",
    )
    assert _rel(ours, oracle) <= 1e-3
    ours64 = tdeconv.richardson_lucy(img, psf, s, plain=True, dtype=torch.float64, device="cpu")
    assert _rel(ours64.numpy(), oracle) <= 1e-6
