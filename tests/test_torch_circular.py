"""PyTorch port: the circular convolutions and the ``zy_pallas`` backend
against the JAX package (CPU).

The plain versions of ``convzy_circular`` (z, then y taps, wrapped) and
``conv3_circular`` (all three axes) against JAX ``convzy_circular_pallas``
and ``conv3_circular_pallas`` in Pallas interpret mode, as
``tests/test_conv3_pallas.py`` runs them, at relative error
``max|a-b| / max|b|`` <= 1e-5 (float32 sums in another order); their
float64 runs against the dense fp64 circulant chain at 1e-12.
``circulant`` and ``x_circulant_plain`` against ``deconv.py::_circulant``
and its einsum. Whole RL runs on ``zy_pallas`` against JAX
``richardson_lucy(separable_backend="zy_pallas")`` (interpret mode) at
1e-4 and against ``richardson_lucy_reference_separable`` on the
half-PSF grid at 1e-3; Biggs against JAX's Biggs on the same backend by
the two-tier gate of ``tests/test_torch_biggs.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.ops.conv3_pallas import conv3_circular_pallas, convzy_circular_pallas
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import rl_fused as trl
from shrimpy_tpu_torch.ops.conv3_cuda import (
    circulant,
    conv3_circular,
    conv3_circular_cuda,
    conv3_circular_route,
    conv3_half_step,
    conv3_one_launch,
    convzy_circular,
    convzy_circular_cuda,
    device_taps,
    x_circulant_plain,
)
from shrimpy_tpu_torch.ops.rl_fused import Stencil, half_layout, half_smem_bytes
from tests.test_deconv_separable import asymmetric_psf
from tests.test_torch_biggs import _two_tier
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

PSF = jdeconv.gaussian_psf((7, 13, 13), (1.2, 2.0, 2.0))
ODD_PSF = jdeconv.gaussian_psf((5, 7, 7), (1.0, 1.2, 1.2))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _taps(lengths, seed, n_terms=1):
    """Asymmetric taps: a flipped or shifted tap shows on every axis."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.random(k).astype(np.float32) + 0.1 for k in lengths)
            for _ in range(n_terms)]


def _dense(vol, terms, axes, flip):
    """The fp64 circulant chain over ``axes`` summed over the terms
    (``circulant``, the float64 ``_circulant``: where taps wrap onto one
    column the float32 original rounds their sum)."""
    out = np.zeros(vol.shape)
    for term in terms:
        w = vol.astype(np.float64)
        for axis in axes:
            taps = np.asarray(term[axis], np.float64)
            mat = circulant(vol.shape[axis], taps[::-1] if flip else taps)
            w = np.moveaxis(np.tensordot(mat, w, axes=(1, axis)), 0, axis)
        out += w
    return out


# (shape, tap lengths): tests/test_conv3_pallas.py's sizes, and a grid
# smaller than its radii (gz = 3 < rz = 4, gy = 9 < ry = 10): taps wrap
# more than once and add up.
ZY_CASES = [((12, 40, 40), (5, 9, 9)), ((7, 37, 53), (3, 5, 5)), ((3, 9, 40), (9, 21, 21))]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape,lengths", ZY_CASES)
def test_convzy_circular_plain_matches_pallas(shape, lengths, flip):
    (wz, wy, wx), = _taps(lengths, seed=sum(shape))
    vol = np.random.default_rng(1).random(shape, dtype=np.float32)
    ref = np.asarray(convzy_circular_pallas(vol, wz, wy, flip=flip, interpret=True))
    ours = convzy_circular(torch.from_numpy(vol), wz, wy, flip=flip)
    assert ours.shape == shape and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) <= 1e-5
    ours64 = convzy_circular(torch.from_numpy(vol.astype(np.float64)), wz, wy, flip=flip)
    np.testing.assert_allclose(ours64.numpy(), _dense(vol, [(wz, wy, wx)], (0, 1), flip),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape,lengths,n_terms", [
    ((12, 40, 40), (5, 9, 9), 1),
    ((7, 37, 53), (3, 5, 7), 2),
    ((3, 9, 40), (9, 21, 21), 1),
])
def test_conv3_circular_plain_matches_pallas(shape, lengths, n_terms, flip):
    terms = _taps(lengths, seed=n_terms, n_terms=n_terms)
    vol = np.random.default_rng(2).random(shape, dtype=np.float32)
    ref = np.asarray(conv3_circular_pallas(vol, terms, flip=flip, interpret=True))
    ours = conv3_circular(torch.from_numpy(vol), terms, flip=flip)
    assert _rel(ours.numpy(), ref) <= 1e-5
    ours64 = conv3_circular(torch.from_numpy(vol.astype(np.float64)), terms, flip=flip)
    np.testing.assert_allclose(ours64.numpy(), _dense(vol, terms, (0, 1, 2), flip),
                               rtol=1e-12, atol=1e-12)
    # The RL route's plain convolution (dense x product) is the same one.
    route = conv3_half_step(torch.from_numpy(vol), None, Stencil(terms, flip=flip), "plain",
                            boundary="circular")
    assert _rel(route.numpy(), ref) <= 1e-5


def test_conv3_circular_refuses_mismatched_taps_and_cpu_launch():
    vol = np.random.default_rng(3).random((6, 20, 20), dtype=np.float32)
    terms = [_taps((3, 5, 5), 0)[0], _taps((3, 7, 5), 1)[0]]
    with pytest.raises(ValueError, match="tap lengths"):
        conv3_circular_pallas(vol, terms, interpret=True)
    with pytest.raises(ValueError, match="share"):
        conv3_circular(torch.from_numpy(vol), terms)
    before = (conv3_circular_cuda.launches, convzy_circular_cuda.launches,
              conv3_one_launch.launches)
    conv3_circular(torch.from_numpy(vol), terms[:1])
    assert (conv3_circular_cuda.launches, convzy_circular_cuda.launches,
            conv3_one_launch.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        convzy_circular_cuda(torch.from_numpy(vol), terms[0][0], terms[0][1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv3_one_launch(torch.from_numpy(vol), Stencil(terms[:1]))
    # Reversed (adjoint) numpy taps, one tap included, become tensors.
    for taps in (np.arange(5.0)[::-1], np.ones(1)[::-1]):
        got = device_taps(taps, "cpu")
        assert got.dtype == torch.float32 and got.tolist() == taps.tolist()


PRODUCTION_CARRY = (136, 2908, 1620)  # the G grid of the deskewed volume, PSF (9, 21, 21)


@pytest.mark.parametrize("n_terms", [1, 2])
def test_conv3_circular_route_takes_the_production_carry_in_one_launch(n_terms):
    """The production carry with the (9, 21, 21) PSF runs as one launch of
    rl_half.cu's circular build: its ring and planes fit the 232,448-byte
    block on the first tile, (32, 64), one term or two."""
    radii = (4, 10, 10)
    assert conv3_circular_route(PRODUCTION_CARRY, radii, n_terms) == "one_launch"
    layout = half_layout(PRODUCTION_CARRY, radii, n_terms)
    assert layout["tile"] == (32, 64) and layout["blocks"] == 91 * 26
    assert layout["smem_bytes"] == half_smem_bytes((32, 64), radii, n_terms)
    assert layout["smem_bytes"] <= trl._SMEM_BYTES == 232448


@pytest.mark.parametrize("radii", [(4, 100, 1), (40, 10, 10), (4, 10, 130)])
def test_conv3_circular_route_past_the_block_is_zy_then_x(radii):
    """A PSF whose ring fits no tile of the one-launch kernel's block (a y
    radius of 100: TWO_PASS_PSF of chip_smoke.py; a z radius of 40; an x
    radius past a slab's 256 columns) takes the two-launch route."""
    assert half_layout(PRODUCTION_CARRY, radii) is None
    assert conv3_circular_route(PRODUCTION_CARRY, radii) == "zy_then_x"
    assert conv3_circular_route((6, 210, 20), radii) == "zy_then_x"


@settings(max_examples=60, deadline=None)
@given(rz=st.integers(0, 14), ry=st.integers(0, 70), rx=st.integers(0, 70),
       n_terms=st.integers(1, 3), gy=st.sampled_from([9, 300, 2908]))
def test_conv3_circular_route_reads_the_shapes_alone(rz, ry, rx, n_terms, gy):
    """The route is a function of (shape, radii, terms): one launch exactly
    where half_layout finds a tile, the same answer on every call, from
    plain tuples with no tensor and no device."""
    shape = (40, gy, 400)
    route = conv3_circular_route(shape, (rz, ry, rx), n_terms)
    assert route in ("one_launch", "zy_then_x")
    assert (route == "one_launch") == (half_layout(shape, (rz, ry, rx), n_terms) is not None)
    assert conv3_circular_route(list(shape), [rz, ry, rx], n_terms) == route


@pytest.mark.parametrize("n", [1, 9, 40, 131])
@pytest.mark.parametrize("k", [1, 3, 7, 13])
def test_circulant_equals_original(n, k):
    """Equal to ``_circulant``; where more taps than rows wrap onto one
    column, the float64 sum is within one float32 rounding of its
    float32 one."""
    taps = np.random.default_rng(n * k).random(k).astype(np.float32)
    ours, ref = circulant(n, taps), jdeconv._circulant(n, taps)
    if k <= n:
        np.testing.assert_array_equal(ours.astype(np.float32), ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_x_circulant_plain_equals_jax_einsum(dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    h = rng.random((4, 6, 37)).astype(np.float32)
    kx = rng.random(13).astype(np.float32)
    ref = np.asarray(jnp.einsum("ab,zyb->zya", jdeconv._circulant(37, kx), h,
                                precision="highest"))
    ours = x_circulant_plain(torch.from_numpy(h).to(dtype), kx)
    assert ours.dtype == dtype
    assert _rel(ours.numpy(), ref) <= 1e-6


def _jax_terms(psf, s):
    return jdeconv.plan_separable_terms(
        jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol)), s)


def _half_pads(psf_w):
    return tuple((k // 2, k // 2) for k in psf_w.shape)


@pytest.mark.parametrize("psf_name", ["gaussian", "asymmetric"])
def test_zy_rl_matches_jax_zy_pallas_and_oracle(psf_name):
    """RL-5 at (10, 32, 32) (test_deconv_separable.py:179-192 and
    :269-295) against JAX's zy_pallas (interpret mode), JAX's planned
    terms fed to both, and against the fp64 circulant oracle on the
    half-PSF grid."""
    psf = PSF if psf_name == "gaussian" else asymmetric_psf()
    img = _blurred((10, 32, 32), psf, seed=8)
    s = DeconvolveSettings(algorithm="separable", separable_backend="zy_pallas", iterations=5)
    terms = _jax_terms(psf, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    assert _rel(ours, ref) <= 1e-4
    psf_w = tdeconv.prepare_psf(psf, s)
    oracle = jdeconv.richardson_lucy_reference_separable(
        img, psf, iterations=5, pads=_half_pads(psf_w), terms=terms)
    assert _rel(ours, oracle) <= 1e-3
    ours64 = tdeconv.richardson_lucy(img, psf, s, terms=terms, plain=True, dtype=torch.float64, device="cpu")
    assert _rel(ours64.numpy(), oracle) <= 1e-6


@pytest.mark.parametrize("shape", [(7, 19, 23), (9, 33, 17), (12, 40, 40)])
def test_zy_rl_odd_shapes(shape):
    """test_deconv_separable.py:298-325 on zy_pallas: odd extents track
    the oracle on the half-PSF grid."""
    vol = (np.random.default_rng(sum(shape)).random(shape, dtype=np.float32) * 50 + 1.0)
    s = DeconvolveSettings(algorithm="separable", separable_backend="zy_pallas", iterations=3)
    ours = tdeconv.richardson_lucy(vol, ODD_PSF, s, device="cpu").numpy()
    assert ours.shape == shape and np.isfinite(ours).all() and (ours >= 0).all()
    psf_w = tdeconv.prepare_psf(ODD_PSF, s)
    oracle = jdeconv.richardson_lucy_reference_separable(
        vol, ODD_PSF, iterations=3, pads=_half_pads(psf_w), terms=tdeconv.plan_terms(psf_w, s))
    assert _rel(ours, oracle) <= 1e-3


def test_zy_rl_agrees_with_matmul_where_grids_coincide():
    """test_deconv_separable.py:218-231: at (10, 32, 32) the matmul grid
    is the half-PSF grid, so the two circular backends agree (1e-4)."""
    img = _blurred((10, 32, 32), PSF, seed=9)
    zy = tdeconv.richardson_lucy(img, PSF, DeconvolveSettings(
        algorithm="separable", separable_backend="zy_pallas", iterations=5), device="cpu")
    mm = tdeconv.richardson_lucy(img, PSF, DeconvolveSettings(
        algorithm="separable", separable_backend="matmul", iterations=5), device="cpu")
    assert _rel(zy.numpy(), mm.numpy()) <= 1e-4


def test_zy_biggs_matches_jax_zy_biggs():
    """Biggs RL-6 through the generic loop on both sides (the two-tier
    gate); acceleration moved the result past it."""
    img = _blurred((10, 32, 32), PSF, seed=10)
    s = DeconvolveSettings(algorithm="separable", separable_backend="zy_pallas", iterations=6,
                           acceleration="biggs")
    terms = _jax_terms(PSF, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, s))
    ours = tdeconv.richardson_lucy(img, PSF, s, terms=terms, device="cpu").numpy()
    _two_tier(ours, ref)
    plain = tdeconv.richardson_lucy(img, PSF, s.model_copy(update={"acceleration": "none"}),
                                    terms=terms, device="cpu").numpy()
    assert np.abs(plain - ref).max() > 1e-3 * np.abs(ref).max()
