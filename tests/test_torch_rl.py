"""PyTorch port of separable Richardson-Lucy against the JAX package (CPU).

The host copies (PSF cropping/padding, separable planning) are pinned to
their originals; the half-step's plain version (what a CPU tensor runs)
is held against the dense fp64 zero-boundary oracle of
``tests/test_rl_fused.py``; whole RL runs against
``richardson_lucy_reference_separable(boundary="zero")`` (relative
error 1e-3) and, once, against JAX ``richardson_lucy`` with the fused
Pallas backend in interpret mode (relative error 1e-4).
"""

import logging

import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.io.synthetic import gaussian_blob
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu_torch.config import DECONVOLVE_DEFAULTS, deconvolve_settings
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops.rl_fused import (
    Stencil,
    half_step,
    half_step_cuda,
    half_step_plain,
    rl_fused,
)
from tests.test_deconv_separable import asymmetric_psf
from tests.test_rl_fused import _oracle_conv3

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)


def _rank2_psf(shape=(7, 11, 11)):
    a = jdeconv.gaussian_psf(shape, (1.0, 1.5, 2.0)).astype(np.float64)
    b = jdeconv.gaussian_psf(shape, (2.0, 3.0, 1.2)).astype(np.float64)
    return (a + 0.4 * b).astype(np.float32)


def _noisy_psf(shape=(9, 15, 15), noise=1e-3, seed=0):
    psf = jdeconv.gaussian_psf(shape, (1.5, 2.5, 2.5)).astype(np.float64)
    rng = np.random.default_rng(seed)
    return (psf + noise * psf.max() * rng.standard_normal(shape)).astype(np.float32)


def _ring_psf(shape=(9, 15, 15)):
    z, y, x = np.meshgrid(*[np.arange(n) - n // 2 for n in shape], indexing="ij")
    r = np.sqrt((y / 2.0) ** 2 + (x / 2.0) ** 2 + (z / 1.5) ** 2)
    return (np.exp(-((r - 2.5) ** 2)) + 0.01).astype(np.float32)


PSFS = {
    "gaussian": lambda: jdeconv.gaussian_psf((9, 21, 21), (1.5, 3.0, 3.0)),
    "asymmetric": lambda: asymmetric_psf((5, 9, 9)),
    "rank2": _rank2_psf,
    "noisy": _noisy_psf,
    "ring": _ring_psf,
}
SETTINGS = {
    "default": DeconvolveSettings(),
    "tight-extended": DeconvolveSettings(max_separable_terms=1, max_extended_terms=8),
    "denoise-off": DeconvolveSettings(psf_denoise="off"),
    "loose": DeconvolveSettings(separable_tol=1e-2, psf_denoise_max_residual=0.3),
}


def _assert_terms_equal(ours, ref):
    assert (ours is None) == (ref is None)
    if ref is None:
        return
    assert len(ours) == len(ref)
    for t_ours, t_ref in zip(ours, ref):
        for a, b in zip(t_ours, t_ref):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("psf_name", sorted(PSFS))
@pytest.mark.parametrize("settings_name", sorted(SETTINGS))
def test_plan_separable_terms_equals_original(psf_name, settings_name, caplog):
    s = SETTINGS[settings_name]
    psf = PSFS[psf_name]()
    with caplog.at_level(logging.WARNING):
        ref = jdeconv.plan_separable_terms(psf, s)
        jax_levels = [r.levelno for r in caplog.records]
        caplog.clear()
        ours = tdeconv.plan_separable_terms(psf, s)
        ours_levels = [r.levelno for r in caplog.records]
    _assert_terms_equal(ours, ref)
    assert ours_levels == jax_levels


def test_decompose_and_truncate_equal_originals():
    psf = _noisy_psf().astype(np.float64)
    psf /= psf.sum()
    for tol, k in ((1e-4, 6), (1e-2, 3), (0.2, 2)):
        _assert_terms_equal(tdeconv.separable_decompose(psf, tol, k),
                            jdeconv.separable_decompose(psf, tol, k))
    for kw in ({}, {"plateau_rtol": 0.08}, {"plateau_rtol": 0.08, "stop_below": 0.05}):
        ours, r_ours = tdeconv.separable_truncate(psf, 8, **kw)
        ref, r_ref = jdeconv.separable_truncate(psf, 8, **kw)
        _assert_terms_equal(ours, ref)
        assert r_ours == pytest.approx(r_ref, rel=0, abs=1e-12)


@pytest.mark.parametrize("shape", [(9, 21, 21), (8, 20, 15), (31, 41, 41), (5, 6, 7)])
@pytest.mark.parametrize("tol", [0.0, 1e-5, 1e-3])
def test_psf_support_helpers_equal_originals(shape, tol):
    rng = np.random.default_rng(sum(shape))
    psf = jdeconv.gaussian_psf(shape, (1.0, 2.0, 2.5)) - 1e-4 * rng.random(shape).astype(
        np.float32
    )
    np.testing.assert_array_equal(tdeconv._crop_psf_support(psf, tol),
                                  jdeconv._crop_psf_support(psf, tol))
    np.testing.assert_array_equal(tdeconv._pad_psf_to_odd(psf), jdeconv._pad_psf_to_odd(psf))
    np.testing.assert_array_equal(
        tdeconv.gaussian_psf(shape, (1.0, 2.0, 2.5)),
        jdeconv.gaussian_psf(shape, (1.0, 2.0, 2.5)),
    )


def test_deconvolve_defaults_equal_schema():
    schema = DeconvolveSettings()
    for field, value in DECONVOLVE_DEFAULTS.items():
        assert getattr(schema, field) == value, field


def _terms_for(psf):
    return jdeconv.separable_decompose(psf / psf.sum())


@pytest.mark.parametrize("psf_name", ["asymmetric", "rank2"])
@pytest.mark.parametrize("flip", [False, True])
def test_plain_half_step_matches_zero_boundary_oracle(psf_name, flip):
    """``plain`` mode both ways (conv and its adjoint) against the dense
    fp64 Toeplitz oracle: catches a flipped (correlation) or shifted tap."""
    psf = PSFS[psf_name]()
    terms = _terms_for(psf) if psf_name == "asymmetric" else jdeconv.separable_decompose(
        psf / psf.sum(), tol=1e-6, max_terms=6
    )
    grid = (11, 23, 19)
    vol = np.random.default_rng(4).random(grid) * 10.0
    out = half_step(torch.from_numpy(vol.astype(np.float32)), None,
                    Stencil(terms, flip=flip), "plain").numpy()
    ref = _oracle_conv3(vol, terms, grid, flip)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-6
    # The float64 plain version is the oracle to round-off.
    out64 = half_step_plain(torch.from_numpy(vol), None, Stencil(terms, flip=flip), "plain")
    np.testing.assert_allclose(out64.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_epilogues_match_identities():
    """ratio = aux / max(conv, eps), mult = aux * conv (the epilogue
    identities of tests/test_rl_fused.py), on the exact G grid."""
    terms = _terms_for(asymmetric_psf((5, 9, 9)))
    rng = np.random.default_rng(8)
    vol = torch.from_numpy((rng.random((10, 30, 26)) * 10 + 0.5).astype(np.float32))
    aux = torch.from_numpy((rng.random((10, 30, 26)) * 5).astype(np.float32))
    conv, adj = Stencil(terms), Stencil(terms, flip=True)
    c = half_step(vol, aux, conv, "plain")
    f = half_step(vol, aux, adj, "plain")
    torch.testing.assert_close(half_step(vol, aux, conv, "ratio", 1e-6),
                               aux / torch.clamp_min(c, 1e-6), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(half_step(vol, aux, adj, "mult", 1e-6), aux * f,
                               rtol=1e-6, atol=1e-7)
    # A conv that falls below eps is clamped, not divided by.
    zero = torch.zeros_like(vol)
    torch.testing.assert_close(half_step(zero, aux, conv, "ratio", 1e-3), aux / 1e-3)


def _blurred(shape, psf, seed=0):
    rng = np.random.default_rng(seed)
    truth = gaussian_blob(shape, tuple(n / 2 for n in shape),
                          (1.5, shape[1] / 10, shape[2] / 10), amplitude=400.0)
    return np.clip(fftconvolve(truth, psf, mode="same") + rng.normal(0, 0.2, shape),
                   0, None).astype(np.float32)


@pytest.mark.parametrize("psf_name", ["gaussian", "asymmetric", "rank2"])
@pytest.mark.parametrize("pad_mode", ["reflect", "edge", "constant"])
def test_rl_matches_zero_boundary_oracle(psf_name, pad_mode):
    psf = PSFS[psf_name]()
    shape = (14, 48, 44)
    img = _blurred(shape, psf)
    s = DeconvolveSettings(iterations=4, pad_mode=pad_mode, separable_tol=1e-6)
    ours = tdeconv.richardson_lucy(img, psf, s, device="cpu").numpy()
    psf_w = tdeconv.prepare_psf(psf, s)
    terms = tdeconv.plan_terms(psf_w, s)
    oracle = jdeconv.richardson_lucy_reference_separable(
        img, psf, iterations=4, pad_mode=pad_mode, terms=terms,
        pads=tuple((k // 2, k // 2) for k in psf_w.shape), boundary="zero",
    )
    err = np.abs(ours - oracle).max() / np.abs(oracle).max()
    assert err <= 1e-3, f"rel err {err:.2e}"
    # The float64 plain path (the on-card reference) is the oracle.
    ours64 = tdeconv.richardson_lucy(img, psf, s, plain=True, dtype=torch.float64, device="cpu")
    assert ours64.dtype == torch.float64
    err64 = np.abs(ours64.numpy() - oracle).max() / np.abs(oracle).max()
    assert err64 <= 1e-6, f"rel err {err64:.2e}"


def test_rl_matches_jax_fused_backend():
    """Against JAX ``richardson_lucy(separable_backend="fused")`` (Pallas
    interpret mode) at tests/test_rl_fused.py's SHAPE, 2 iterations,
    with JAX's planned terms fed to both packages."""
    shape, psf = (12, 280, 650), jdeconv.gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    img = _blurred(shape, psf, seed=1)
    s = DeconvolveSettings(algorithm="separable", separable_backend="fused", iterations=2)
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol))
    terms = jdeconv.plan_separable_terms(psf_w, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, f"rel err {err:.2e}"


def test_rl_settings_by_namespace_equal_pydantic():
    psf = PSFS["asymmetric"]()
    img = _blurred((10, 30, 28), psf)
    a = tdeconv.richardson_lucy(img, psf, DeconvolveSettings(iterations=3), device="cpu")
    b = tdeconv.richardson_lucy(img, psf, deconvolve_settings(iterations=3), device="cpu")
    c = tdeconv.richardson_lucy(img, psf, iterations=3, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("update,exc,match", [
    ({"acceleration": "biggs"}, None, "runs"),
    ({"algorithm": "fft"}, None, "runs"),
    ({"algorithm": "hybrid", "separable_backend": "matmul"}, None, "runs"),
    ({"fused_low_precision_iters": 2}, NotImplementedError, "float32"),
    ({"donate_input": True}, None, "runs"),
    ({"separable_backend": "matmul"}, None, "runs"),
    ({"separable_backend": "linear_pallas"}, None, "runs"),
    ({"separable_backend": "zy_pallas"}, None, "runs"),
    ({"separable_backend": "fused_iter"}, None, "runs"),
])
def test_unported_settings_raise(update, exc, match):
    """Settings the port does not run raise naming their ROADMAP item;
    those it has come to run (``exc`` None) give a finite result, and the
    FFT and hybrid algorithms JAX's within 1e-5 of the scale (the hybrid's
    warm phase on ``matmul`` on both sides)."""
    s = DeconvolveSettings(iterations=3).model_copy(update=update)
    img = np.ones((6, 20, 20), np.float32)
    if exc is None:
        if "algorithm" in update:
            img = _blurred((6, 20, 20), PSFS["asymmetric"](), seed=9)
        out = tdeconv.richardson_lucy(img, PSFS["asymmetric"](), s, device="cpu")
        assert out.shape == img.shape and bool(torch.isfinite(out).all())
        if "algorithm" in update:
            ref = np.asarray(jdeconv.richardson_lucy(img, PSFS["asymmetric"](), s))
            assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() <= 1e-5
        return
    with pytest.raises(exc, match=match):
        tdeconv.richardson_lucy(img, PSFS["asymmetric"](), s, device="cpu")


def _gauss(shape, sigma):
    grids = np.meshgrid(*(np.arange(n) - n // 2 for n in shape), indexing="ij")
    g = np.exp(-sum(x**2 for x in grids) / (2 * sigma**2)).astype(np.float32)
    return g / g.sum()


@pytest.mark.parametrize("algorithm,shape,psf_shape,exc,match", [
    ("auto", (20, 24), (5, 7), None, None),
    ("auto", (40,), (7,), None, None),
    ("separable", (20, 24), (5, 7), ValueError, "3-D"),
])
def test_not_3d_follows_jax(algorithm, shape, psf_shape, exc, match):
    """An image and PSF that are not 3-D: under ``auto`` both packages
    run their FFT RL (within 1e-5 of the scale); under ``separable`` both
    raise ValueError."""
    img = (np.random.default_rng(11).random(shape) * 50 + 1).astype(np.float32)
    psf = _gauss(psf_shape, 1.2)
    s = DeconvolveSettings(iterations=2, algorithm=algorithm)
    if exc is ValueError:
        with pytest.raises(ValueError, match=match):
            jdeconv.richardson_lucy(img, psf, s)
        with pytest.raises(exc, match=match):
            tdeconv.richardson_lucy(img, psf, s, device="cpu")
        return
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    out = tdeconv.richardson_lucy(img, psf, s, device="cpu").numpy()
    assert out.shape == shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-5


def test_non_separable_psf_raises():
    psf = _ring_psf()
    img = np.ones((10, 30, 30), np.float32)
    strict = DeconvolveSettings(algorithm="separable", psf_denoise="off",
                                max_extended_terms=6, iterations=1)
    with pytest.raises(ValueError, match="not separable"):
        tdeconv.richardson_lucy(img, psf, strict, device="cpu")
    # Under auto both packages run the FFT RL for it.
    auto = DeconvolveSettings(psf_denoise="off", max_extended_terms=6, iterations=1)
    img = _blurred((10, 30, 30), psf, seed=4)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, auto))
    out = tdeconv.richardson_lucy(img, psf, auto, device="cpu").numpy()
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-5


def test_stencil_and_kernel_guards():
    terms = _terms_for(asymmetric_psf((5, 9, 9)))
    with pytest.raises(ValueError, match="at least one"):
        Stencil([])
    with pytest.raises(ValueError, match="odd"):
        Stencil([(np.ones(4), np.ones(5), np.ones(5))])
    with pytest.raises(ValueError, match="share"):
        Stencil([terms[0], (np.ones(3), np.ones(9), np.ones(9))])
    vol = torch.ones((6, 20, 20))
    before = half_step_cuda.launches
    half_step(vol, vol, Stencil(terms), "ratio")
    assert half_step_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        half_step_cuda(vol, vol, Stencil(terms), "ratio")
    with pytest.raises(ValueError, match="mode"):
        half_step_plain(vol, vol, Stencil(terms), "ratio_bf16")
    with pytest.raises(ValueError, match="radii"):
        rl_fused(vol, np.ones((3, 9, 9), np.float32), terms, deconvolve_settings(), 1)


def test_delta_psf_is_identity_and_input_untouched():
    """A 1x1x1 PSF gives zero radii, so the G grid is the image itself:
    RL must return the image and leave the caller's tensor unchanged."""
    img = torch.from_numpy(np.random.default_rng(3).random((6, 10, 12)).astype(np.float32)) - 0.2
    before = img.clone()
    out = tdeconv.richardson_lucy(img, np.ones((1, 1, 1), np.float32),
                                  deconvolve_settings(iterations=3), device="cpu")
    torch.testing.assert_close(img, before, rtol=0, atol=0)
    # Negative voxels: data 0, est eps -> ratio 0 -> 0.
    torch.testing.assert_close(out, torch.clamp_min(before, 0.0), rtol=1e-6, atol=0)
