"""PyTorch port: the circulant ``matmul`` backend and ``auto``'s choice
of backend against the JAX package (CPU).

Every host helper copied from ``shrimpy_tpu/ops/deconv.py`` equals its
original (``np.array_equal``; ``==`` for pads). ``apply_axis`` against
``_apply_axis`` (dense and block-banded, precision ``highest``) at
relative error ``max|a-b| / max|b|`` <= 1e-5. Whole RL runs against JAX
``richardson_lucy(separable_backend="matmul")`` at 1e-4 and against
``richardson_lucy_reference_separable`` (its default ``_sep_pads`` grid)
at 1e-3, the float64 run at 1e-6; Biggs against JAX's by the two-tier
gate of ``tests/test_torch_biggs.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import rl_matmul as tm
from shrimpy_tpu_torch.ops.conv3_cuda import convzy_circular_cuda, convzy_linear_cuda
from shrimpy_tpu_torch.ops.rl_fused import half_step_cuda
from tests.test_deconv_separable import asymmetric_psf
from tests.test_torch_biggs import _two_tier
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

PSF = jdeconv.gaussian_psf((7, 13, 13), (1.2, 2.0, 2.0))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _small_blocks(monkeypatch):
    """Blocks of 8 past 24 rows in both packages (test_deconv_separable.py:
    160-175), so small grids take the banded scheme."""
    for mod in (jdeconv, tm):
        monkeypatch.setattr(mod, "_BLOCK", 8)
        monkeypatch.setattr(mod, "_DENSE_MAX", 24)


def test_constants_equal_originals():
    assert (tm._BLOCK, tm._DENSE_MAX) == (jdeconv._BLOCK, jdeconv._DENSE_MAX)


@pytest.mark.parametrize("k", [1, 7, 21, 257])
@pytest.mark.parametrize("block", [None, 8, 128])
def test_banded_stencil_equals_original(k, block):
    if block is not None and k // 2 > block:
        with pytest.raises(ValueError, match="exceeds one block"):
            tm._banded_stencil(np.ones(k, np.float32), block)
        return
    taps = np.random.default_rng(k).random(k).astype(np.float32)
    np.testing.assert_array_equal(tm._banded_stencil(taps, block).astype(np.float32),
                                  jdeconv._banded_stencil(taps, block))


def test_axis_is_banded_and_sep_pads_equal_originals():
    for n in (1, 1536, 1537, 1664, 2944, 5000):
        for radius in (0, 10, 128, 129):
            assert tm._axis_is_banded(n, radius) == jdeconv._axis_is_banded(n, radius)
    for image, psf in (((128, 2888, 1600), (9, 21, 21)), ((10, 32, 32), (7, 13, 13)),
                       ((7, 1530, 1517), (5, 15, 1)), ((1700, 3, 2000), (301, 1, 257)),
                       ((3, 1601, 9), (1, 3, 1))):
        assert tm._sep_pads(image, psf) == jdeconv._sep_pads(image, psf)
    # The production grid: y and x banded, asymmetric pads.
    assert tm._sep_pads((128, 2888, 1600), (9, 21, 21)) == ((4, 4), (28, 28), (32, 32))


@pytest.mark.parametrize("grid,radii,small", [
    ((9, 40, 40), (2, 4, 4), False),
    ((9, 40, 40), (2, 4, 4), True),   # y and x banded at block 8
    ((7, 48, 21), (3, 8, 5), True),   # y banded at radius == block, x dense
])
def test_sep_matrices_equal_original(grid, radii, small, monkeypatch):
    if small:
        _small_blocks(monkeypatch)
    rng = np.random.default_rng(sum(grid))
    terms = [tuple(rng.random(2 * r + 1).astype(np.float32) for r in radii) for _ in range(2)]
    ours, ref = tm._sep_matrices(terms, grid, radii), jdeconv._sep_matrices(terms, grid, radii)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a.astype(np.float32), b)


@pytest.mark.parametrize("shape,axis,radius", [
    ((12, 10, 9), 0, 3),
    ((5, 14, 9), 1, 4),
    ((5, 6, 17), 2, 5),
    ((4, 1664, 12), 1, 10),   # banded: y past _DENSE_MAX, 13 blocks
    ((4, 12, 1664), 2, 10),
    ((1664, 3, 4), 0, 10),
    ((4, 1664, 12), 1, 0),    # radius 0: the full-block fallback
])
def test_apply_axis_matches_jax(shape, axis, radius):
    rng = np.random.default_rng(sum(shape) + axis)
    v = rng.random(shape).astype(np.float32)
    taps = rng.random(2 * max(radius, 3) + 1).astype(np.float32)
    if radius == 0:
        taps = rng.random(21).astype(np.float32)
    n = shape[axis]
    r_true = len(taps) // 2
    mat = (jdeconv._banded_stencil(taps) if jdeconv._axis_is_banded(n, r_true)
           else jdeconv._circulant(n, taps))
    ref = np.asarray(jdeconv._apply_axis(jnp.asarray(v), jnp.asarray(mat), axis,
                                         jdeconv._PRECISIONS["highest"], radius))
    ours = tm.apply_axis(torch.from_numpy(v), torch.from_numpy(mat), axis, radius)
    assert ours.shape == shape
    assert _rel(ours.numpy(), ref) <= 1e-5


def _jax_terms(psf, s):
    return jdeconv.plan_separable_terms(
        jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol)), s)


@pytest.mark.parametrize("psf_name", ["gaussian", "asymmetric"])
def test_matmul_rl_matches_jax_matmul_and_oracle(psf_name):
    psf = PSF if psf_name == "gaussian" else asymmetric_psf()
    img = _blurred((12, 36, 36), psf, seed=11)
    s = DeconvolveSettings(algorithm="separable", separable_backend="matmul", iterations=5)
    terms = _jax_terms(psf, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    assert _rel(ours, ref) <= 1e-4
    oracle = jdeconv.richardson_lucy_reference_separable(img, psf, iterations=5, terms=terms)
    assert _rel(ours, oracle) <= 1e-3
    ours64 = tdeconv.richardson_lucy(img, psf, s, terms=terms, dtype=torch.float64, device="cpu")
    assert ours64.dtype == torch.float64
    assert _rel(ours64.numpy(), oracle) <= 1e-6


@pytest.mark.parametrize("shape", [(7, 19, 23), (9, 33, 17), (12, 40, 40)])
def test_matmul_rl_odd_shapes(shape):
    psf = jdeconv.gaussian_psf((5, 7, 7), (1.0, 1.2, 1.2))
    vol = (np.random.default_rng(sum(shape)).random(shape, dtype=np.float32) * 50 + 1.0)
    s = DeconvolveSettings(algorithm="separable", separable_backend="matmul", iterations=3)
    ours = tdeconv.richardson_lucy(vol, psf, s, device="cpu").numpy()
    assert ours.shape == shape and np.isfinite(ours).all() and (ours >= 0).all()
    oracle = jdeconv.richardson_lucy_reference_separable(vol, psf, iterations=3)
    assert _rel(ours, oracle) <= 1e-3


@pytest.mark.parametrize("pad_mode", ["reflect", "edge"])
def test_matmul_rl_banded_asymmetric_pads(pad_mode, monkeypatch):
    """test_deconv_separable.py:160-175 with blocks of 8: y and x banded
    with radius 8 == block, and the grid rounded up with pads that differ
    low and high (reflect pads longer than the image on x)."""
    _small_blocks(monkeypatch)
    psf = jdeconv.gaussian_psf((7, 17, 17), (1.2, 2.2, 2.2))
    img = _blurred((12, 39, 5), psf, seed=12)
    pads = jdeconv._sep_pads(img.shape, psf.shape)
    assert pads[1] != (8, 8) and pads[1][0] != pads[1][1] and pads[2][1] > 5
    s = DeconvolveSettings(algorithm="separable", separable_backend="matmul", iterations=4,
                           pad_mode=pad_mode)
    ours = tdeconv.richardson_lucy(img, psf, s, device="cpu").numpy()
    oracle = jdeconv.richardson_lucy_reference_separable(img, psf, iterations=4,
                                                         pad_mode=pad_mode)
    assert _rel(ours, oracle) <= 1e-3
    assert _rel(ours, np.asarray(jdeconv.richardson_lucy(img, psf, s))) <= 1e-4


def test_matmul_biggs_matches_jax_matmul_biggs():
    img = _blurred((10, 32, 32), PSF, seed=13)
    s = DeconvolveSettings(algorithm="separable", separable_backend="matmul", iterations=6,
                           acceleration="biggs")
    terms = _jax_terms(PSF, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, s))
    ours = tdeconv.richardson_lucy(img, PSF, s, terms=terms, device="cpu").numpy()
    _two_tier(ours, ref)
    plain = tdeconv.richardson_lucy(img, PSF, s.model_copy(update={"acceleration": "none"}),
                                    terms=terms, device="cpu").numpy()
    assert np.abs(plain - ref).max() > 1e-3 * np.abs(ref).max()


def test_matmul_precision_tf32_and_operator_cache(monkeypatch):
    """Every matmul_precision is the same float32 product; an unknown one
    raises, and so does TF32 switched on; the operators are cached (LRU,
    8 entries) and launch no kernel of the repository."""
    img = _blurred((8, 24, 20), PSF, seed=14)
    outs = [tdeconv.richardson_lucy(img, PSF, deconvolve_settings(
        iterations=2, separable_backend="matmul", matmul_precision=p), device="cpu") for p in tm.PRECISIONS]
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="matmul_precision"):
        tdeconv.richardson_lucy(img, PSF, deconvolve_settings(
            separable_backend="matmul", matmul_precision="bf16"), device="cpu")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tdeconv.richardson_lucy(img, PSF, deconvolve_settings(separable_backend="matmul"), device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(tm, "_OPERATORS", type(tm._OPERATORS)())
    terms = [(np.ones(3), np.ones(5), np.ones(5))]
    first = tm.sep_operators(terms, (5, 9, 9), (1, 2, 2), "cpu", torch.float32)
    assert tm.sep_operators(terms, (5, 9, 9), (1, 2, 2), "cpu", torch.float32) is first
    for n in range(10, 20):
        tm.sep_operators(terms, (5, 9, n), (1, 2, 2), "cpu", torch.float64)
    assert len(tm._OPERATORS) == 8
    before = (half_step_cuda.launches, convzy_linear_cuda.launches,
              convzy_circular_cuda.launches)
    tdeconv.richardson_lucy(img, PSF, deconvolve_settings(iterations=1,
                                                          separable_backend="matmul"), device="cpu")
    assert (half_step_cuda.launches, convzy_linear_cuda.launches,
            convzy_circular_cuda.launches) == before


def _wide_y_psf():
    """(1, 425, 1): y radius 212, one past the fused kernels' bound, with
    mass at both ends so that psf_crop_tol keeps all of it."""
    taps = 1.0 + np.cos(np.linspace(0.0, 2.0 * np.pi, 425))
    return (taps / taps.sum()).astype(np.float32)[None, :, None]


def test_auto_resolves_from_geometry_alone():
    """``auto`` is ``fused`` where the half-step kernels take the radii,
    else ``matmul`` (no bound), on every device: a y radius past
    the kernels' shared memory runs matmul on the CPU too, and the run is
    finite and the same as asking for matmul."""
    resolve = tdeconv.resolve_separable_backend
    assert resolve("auto", (128, 2888, 1600), (9, 21, 21)) == "fused"
    assert resolve("auto", (8, 20, 20), (1, 423, 1)) == "fused"
    assert resolve("auto", (8, 20, 20), (1, 425, 1)) == "matmul"
    assert resolve("auto", (8, 20, 60000), (1, 1, 3)) == "fused"  # a long x row, in pieces
    assert resolve("auto", (8, 20, 200), (1, 1, 58001)) == "matmul"  # x radius past a piece
    assert resolve("zy_pallas", (8, 20, 60000), (1, 1, 3)) == "zy_pallas"
    assert resolve("fused_iter", (8, 20, 20), (1, 3, 1)) == "fused_iter"  # named, never auto's
    with pytest.raises(ValueError, match="unknown"):
        resolve("fft", (8, 20, 20), (1, 3, 1))
    psf = _wide_y_psf()
    s = deconvolve_settings(iterations=2)
    assert tdeconv.prepare_psf(psf, s).shape == (1, 425, 1)
    img = _blurred((3, 16, 12), jdeconv.gaussian_psf((1, 3, 3), (1.0, 1.0, 1.0)), seed=15)
    out = tdeconv.richardson_lucy(img, psf, s, device="cpu")
    assert out.shape == img.shape and bool(torch.isfinite(out).all())
    want = tdeconv.richardson_lucy(img, psf, deconvolve_settings(iterations=2,
                                                                 separable_backend="matmul"), device="cpu")
    torch.testing.assert_close(out, want, rtol=0, atol=0)
