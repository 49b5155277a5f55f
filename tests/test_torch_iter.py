"""PyTorch port: the whole-iteration RL backend ``fused_iter``, the
on-chip probes' plain versions, ``donate_input``, the device default and
the import rule, against the JAX package (CPU).

The JAX side runs its Pallas kernel in interpret mode (plain float32
dots), as ``tests/test_rl_fused_iter.py`` does; the port runs on
``device="cpu"``, where every wrapper takes its plain version. Whole RL
runs agree within 1e-5 (``max|a-b| / max|b|``, the bar of JAX's own
fused_iter-vs-fused test: the same update sequence, sums taken in
another order), within 1e-3 of the float64 zero-boundary oracle
(BASELINE's budget), and Biggs runs within the two-tier gate of
``tests/test_rl_fused.py:244-245``.
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shrimpy_tpu.config import DeconvolveSettings, DeskewSettings, ReconstructSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.ops.deskew import get_deskewed_shape
from shrimpy_tpu.ops.rl_fused_iter import rl_fused_iter as jax_rl_fused_iter
from shrimpy_tpu.ops.rl_fused_iter import rl_iter_supported as jax_rl_iter_supported
from shrimpy_tpu.parallel.pipeline import reconstruct_batch as jax_reconstruct_batch
from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.kernels import probes
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import rl_fused_iter as titer
from shrimpy_tpu_torch.ops.deskew import deskew_volume
from shrimpy_tpu_torch.ops.rl_fused import (
    _SMEM_BYTES,
    Stencil,
    fused_bound_error,
    half_step_plain,
    rl_fused,
)
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step, reconstruct_batch
from tests.test_deconv_separable import asymmetric_psf
from tests.test_torch_biggs import _two_tier
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SHAPE, PSF_SHAPE = (12, 280, 650), (5, 9, 9)  # tests/test_rl_fused_iter.py
PSF = jdeconv.gaussian_psf(PSF_SHAPE, (1.0, 1.6, 1.6))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rank2_terms():
    """The rank-2 terms of ``test_rl_iter_multi_term`` and their PSF."""
    def term(sz, sy, sx, amp):
        g = jdeconv.gaussian_psf(PSF_SHAPE, (sz, sy, sx)).astype(np.float64)
        wz, wy, wx = g.sum((1, 2)), g.sum((0, 2)), g.sum((0, 1))
        return wz * (amp / wz.sum()), wy / wy.sum(), wx / wx.sum()

    terms = [term(1.0, 1.6, 1.6, 0.7), term(1.8, 0.9, 2.2, 0.3)]
    return terms, sum(np.einsum("z,y,x->zyx", *t) for t in terms)


def _case(name):
    """(psf, terms) of a named PSF, the terms fed to both packages."""
    if name == "gaussian":
        return PSF, jdeconv.separable_decompose(PSF)
    if name == "asymmetric":
        psf = asymmetric_psf(PSF_SHAPE)
        return psf, jdeconv.separable_decompose(psf / psf.sum())
    terms, psf = _rank2_terms()
    return psf, terms


@pytest.mark.parametrize("name", ["gaussian", "asymmetric", "rank2"])
def test_rl_fused_iter_matches_jax_fused_iter(name):
    psf, terms = _case(name)
    img = _blurred(SHAPE, psf, seed=21)
    s = DeconvolveSettings(algorithm="separable")
    assert jax_rl_iter_supported(SHAPE, psf.shape, n_terms=len(terms))
    ref = np.asarray(jax_rl_fused_iter(img, psf, terms, s, 3))
    ours = titer.rl_fused_iter(torch.from_numpy(img), np.asarray(psf, np.float32), terms, s, 3)
    assert ours.shape == img.shape and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) <= 1e-5


def test_rl_fused_iter_matches_zero_boundary_oracle():
    img = _blurred(SHAPE, PSF, seed=22)
    terms = jdeconv.separable_decompose(PSF)
    ours = titer.rl_fused_iter(torch.from_numpy(img), PSF, terms, deconvolve_settings(), 4)
    oracle = jdeconv.richardson_lucy_reference_separable(
        img, PSF, iterations=4, pads=tuple((k // 2, k // 2) for k in PSF.shape), boundary="zero")
    assert _rel(ours.numpy(), oracle) <= 1e-3
    # The float64 plain path (the on-card reference) is the oracle.
    ours64 = titer.rl_fused_iter(torch.from_numpy(img), PSF, terms, deconvolve_settings(), 4,
                                 plain=True, dtype=torch.float64)
    assert ours64.dtype == torch.float64 and _rel(ours64.numpy(), oracle) <= 1e-6


@pytest.mark.parametrize("name", ["asymmetric", "rank2"])
@pytest.mark.parametrize("shape", [(11, 23, 19), (3, 40, 37)])
def test_rl_iter_plain_equals_the_half_step_pair(name, shape):
    """One iteration: the kernel's axis order (x, y, z) against the
    half-steps' (z, y, x), both plain, on a grid with z below 2 rz + 1."""
    _, terms = _case(name)
    rng = np.random.default_rng(sum(shape))
    est = torch.from_numpy((rng.random(shape) * 10 + 0.5).astype(np.float32))
    data = torch.from_numpy((rng.random(shape) * 5).astype(np.float32))
    conv, adj = Stencil(terms), Stencil(terms, flip=True)
    got = titer.rl_iter(est, data, conv, adj, 1e-6)
    want = half_step_plain(half_step_plain(est, data, conv, "ratio", 1e-6), est, adj, "mult", 1e-6)
    assert _rel(got.numpy(), want.numpy()) <= 1e-6
    if name == "asymmetric":  # swapping the stencils is another operator: the flip matters
        assert _rel(titer.rl_iter(est, data, adj, conv, 1e-6).numpy(), want.numpy()) > 1e-3
    # In float64 the two orders agree to round-off.
    got64 = titer.rl_iter_plain(est.double(), data.double(), conv, adj, 1e-6)
    want64 = half_step_plain(half_step_plain(est.double(), data.double(), conv, "ratio", 1e-6),
                             est.double(), adj, "mult", 1e-6)
    assert _rel(got64.numpy(), want64.numpy()) <= 1e-12


def test_fused_iter_through_richardson_lucy_matches_fused():
    img = _blurred(SHAPE, PSF, seed=23)
    outs = [tdeconv.richardson_lucy(
        img, PSF, deconvolve_settings(algorithm="separable", separable_backend=b, iterations=2),
        device="cpu").numpy() for b in ("fused_iter", "fused")]
    assert _rel(*outs) <= 1e-5
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, DeconvolveSettings(
        algorithm="separable", separable_backend="fused_iter", iterations=2)))
    assert _rel(outs[0], ref) <= 1e-5


def test_fused_iter_step_matches_jax_step():
    """deskew (Pallas, interpret) -> fused_iter RL (interpret) in JAX
    against the port's step with the same settings."""
    raw_shape = (117, 24, 650)
    settings = ReconstructSettings(
        deskew=DeskewSettings(px_to_scan_ratio=0.386, backend="pallas"),
        deconvolve=DeconvolveSettings(separable_backend="fused_iter", iterations=2))
    deskewed, _ = get_deskewed_shape(raw_shape, settings.deskew)
    assert jax_rl_iter_supported(deskewed, PSF.shape)
    raw = (np.random.default_rng(24).random((1, *raw_shape)) * 100).astype(np.float32)
    ref = np.asarray(jax_reconstruct_batch(jnp.asarray(raw), settings, psf=PSF))
    ours = build_reconstruct_step(settings, psf=PSF, device="cpu")(raw)
    assert tuple(ours.shape) == ref.shape
    assert _rel(ours.numpy(), ref) <= 1e-4
    # donate_input is not read inside the step, as under a JAX trace.
    settings.deconvolve.donate_input = True
    batch = torch.from_numpy(raw)
    again = reconstruct_batch(batch, settings, psf=PSF)
    torch.testing.assert_close(again, ours, rtol=0, atol=0)
    assert batch.shape == raw.shape


def test_fused_iter_biggs_matches_jax_fused_iter_biggs():
    """Both packages run Biggs on fused_iter through their generic loops."""
    img = _blurred(SHAPE, PSF, seed=25)
    s = DeconvolveSettings(algorithm="separable", separable_backend="fused_iter", iterations=6,
                           acceleration="biggs")
    terms = jdeconv.plan_separable_terms(PSF, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, s))
    ours = tdeconv.richardson_lucy(img, PSF, s, terms=terms, device="cpu").numpy()
    _two_tier(ours, ref)
    plain = tdeconv.richardson_lucy(img, PSF, s.model_copy(update={"acceleration": "none"}),
                                    terms=terms, device="cpu").numpy()
    assert np.abs(plain - ref).max() > 1e-3 * np.abs(ref).max()


@pytest.mark.parametrize("iterations", [1, 2])
def test_fused_iter_biggs_startup_is_plain_rl_bitwise(iterations):
    img = _blurred((10, 40, 44), PSF, seed=26)
    s = deconvolve_settings(iterations=iterations, separable_backend="fused_iter")
    plain = tdeconv.richardson_lucy(img, PSF, s, device="cpu")
    s.acceleration = "biggs"
    torch.testing.assert_close(tdeconv.richardson_lucy(img, PSF, s, device="cpu"), plain,
                               rtol=0, atol=0)


# The geometries where the port's fused_iter raised and JAX's runs: the
# production image with three deep or wide PSFs, and the test image with
# the widest JAX's layout takes (its limits rz 8, ry 56, rx 64).
PAST_THE_BLOCK = [((128, 2888, 1600), (17, 61, 61)), ((128, 2888, 1600), (9, 81, 81)),
                  ((128, 2888, 1600), (17, 113, 129)), ((12, 280, 650), (17, 113, 129))]


def _grid(image, psf):
    radii = tuple(k // 2 for k in psf)
    return tuple(n + 2 * r for n, r in zip(image, radii)), radii


def test_rl_iter_bounds_are_geometry():
    assert titer.rl_iter_supported((128, 2888, 1600), (9, 21, 21))  # the production volume
    assert titer.rl_iter_supported((128, 2888, 1600), (9, 21, 21), n_terms=2)
    assert titer.rl_iter_supported((34, 290, 388), (7, 11, 13), n_terms=2)  # the 2-term check
    layout = titer.iter_layout((136, 2908, 1620), (4, 10, 10), 1)
    assert layout == {"tile": titer.TILES[0], "threads": 512, "blocks": 91 * 34,
                      "smem_bytes": titer.iter_smem_bytes(titer.TILES[0], (4, 10, 10), 1)}
    assert titer.rl_iter_route((136, 2908, 1620), (4, 10, 10)) == "one_launch"
    assert titer.iter_slab((32, 48), (4, 10, 10)) == (72, 88)
    assert titer.iter_slab((32, 48), (3, 5, 5)) == (52, 72)  # 2 rx = 10 rounds up to 12
    # Tiny y/x, which JAX's layout refuses, runs here in one launch.
    assert titer.rl_iter_supported((10, 32, 32), (5, 9, 9))
    assert titer.rl_iter_route((14, 40, 40), (2, 4, 4)) == "one_launch"
    # Past every tile's block the iteration runs as two half-steps, each
    # reason named: the ring's shared memory, the TMA box, the registers.
    for image, psf in PAST_THE_BLOCK:
        g_shape, radii = _grid(image, psf)
        assert titer.rl_iter_supported(image, psf)
        assert titer.iter_layout(g_shape, radii) is None
        assert titer.rl_iter_route(g_shape, radii) == "half_steps"
    msg = titer.iter_block_error((144, 2948, 1660), (8, 30, 30), 1)
    assert "one-launch kernel's block" in msg and "shared memory" in msg and str(_SMEM_BYTES) in msg
    assert "TMA box" in titer.iter_block_error((28, 392, 778), (8, 56, 64), 1)
    assert "registers" in titer.iter_block_error((40, 300, 400), (5, 4, 4), 2)
    assert "16-byte pieces" in titer.iter_block_error((16, 160, 740), (4, 40, 40), 1)
    assert "launch grid" in titer.iter_block_error((4, 70000, 40000), (1, 1, 1))
    assert titer.rl_iter_route((4, 70000, 40000), (1, 1, 1)) == "half_steps"
    # What neither route takes is what fused refuses, named as fused_iter:
    # radii alone. A long x row runs in pieces, a deep carry on any grid.
    assert titer.iter_bound_error((4, 30, 60008), (0, 0, 4)) is None
    assert titer.iter_bound_error((70000, 30, 30), (1, 1, 1)) is None
    assert titer.iter_bound_error((4, 30, 60200), (0, 0, 29000)) is not None
    with pytest.raises(ValueError, match="fused_iter.*x radius"):
        titer.rl_iter_route((4, 30, 60200), (0, 0, 29000))
    with pytest.raises(ValueError, match="fused_iter.*z/y radius"):
        titer.rl_iter_route((40, 600, 40), (4, 212, 1))
    # More terms take a smaller tile, then the half-steps (the adjoint z
    # pass keeps n_terms * 2 rz planes a thread in registers, at most 16).
    tiles = [titer.iter_layout((136, 2908, 1620), (4, 10, 10), n) for n in (1, 2, 3)]
    assert tiles[0]["tile"] == (32, 48) and tiles[2] is None
    assert tiles[1]["tile"][0] * tiles[1]["tile"][1] < 32 * 48
    assert titer.iter_layout((136, 2908, 1620), (4, 10, 10), 1, tile=(8, 16))["tile"] == (8, 16)
    assert titer.iter_layout((136, 2908, 1620), (4, 10, 10), 2, tile=(32, 48)) is None
    assert titer.iter_layout((136, 2908, 1620), (4, 10, 10), 1, tile=(6, 48)) is None
    assert titer.iter_layout((136, 2908, 1620), (4, 10, 10), 1, tile=(64, 48)) is None


@pytest.mark.parametrize("image", [(128, 2888, 1600), (12, 280, 650), (30, 300, 400),
                                   (6, 140, 300), (64, 512, 256)])
def test_rl_iter_supported_wherever_jax_s_is(image):
    """Over PSFs from none to JAX's widest and 1-3 terms: where the JAX
    package's fused_iter runs, the port's does, on one route or the
    other."""
    psfs = [(1, 1, 1), (5, 9, 9), (3, 41, 5), (9, 21, 21), (11, 9, 9), (17, 21, 21),
            (17, 61, 61), (9, 81, 81), (15, 113, 97), (17, 113, 129)]
    taken = 0
    for psf in psfs:
        g_shape, radii = _grid(image, psf)
        for n_terms in (1, 2, 3):
            if jax_rl_iter_supported(image, psf, n_terms=n_terms):
                taken += 1
                assert titer.rl_iter_supported(image, psf, n_terms), (psf, n_terms)
                assert titer.rl_iter_route(g_shape, radii, n_terms) in titer.ROUTES
    assert taken >= 3
    for named, psf in PAST_THE_BLOCK:
        if named == image:
            assert jax_rl_iter_supported(image, psf) and titer.rl_iter_supported(image, psf)


def test_fused_iter_bound_is_narrower_than_jax_only_past_fused_s_launch_grid():
    """The gap that ROADMAP §3 logged is closed: carries wider than the
    three-pass x pass's row of shared memory, deeper than a launch's z
    grid or taller than its y grid, which JAX's layout tiles, now run
    (the x pass takes a long row in pieces, and the passes launch their
    grid chunk by chunk); the two supports agree."""
    for image in ((12, 280, 58100), (70000, 300, 400), (4, 2_100_000, 600)):
        assert jax_rl_iter_supported(image, (5, 9, 9))
        assert titer.rl_iter_supported(image, (5, 9, 9))
        g_shape, radii = _grid(image, (5, 9, 9))
        assert titer.iter_bound_error(g_shape, radii) is None is fused_bound_error(g_shape, radii)
        assert titer.rl_iter_route(g_shape, radii) in titer.ROUTES
    assert titer.rl_iter_supported((12, 280, 58000), (5, 9, 9))


@settings(max_examples=60, deadline=None)
@given(rz=st.integers(0, 12), ry=st.integers(0, 60), rx=st.integers(0, 70),
       n_terms=st.integers(1, 8))
def test_iter_layout_fits_shared_memory(rz, ry, rx, n_terms):
    """Whatever it accepts fits a block; what it refuses fits no tile."""
    radii = (rz, ry, rx)
    layout = titer.iter_layout((40, 300, 400), radii, n_terms)
    pad4 = lambda n: -(-n // 4) * 4  # noqa: E731
    pad32 = lambda n: -(-n // 32) * 32  # noqa: E731

    def smem(tile):
        # Taps of both directions; the slab; per term the x-pass plane with
        # 4 + 3 rows of zeros, the ring of 2 rz + 2 y-pass planes and the
        # adjoint x-pass plane with 4; the ratio plane; the mbarrier
        # (csrc/rl_iter.cu::layout_of). Every region 128-byte aligned.
        ty, tx = tile
        sr, sw, mr, xw = ty + 4 * ry, tx + 2 * pad4(2 * rx), ty + 2 * ry, tx + pad4(2 * rx)
        taps = pad32(2 * n_terms * (pad4(2 * rz + 1) + pad4(2 * ry + 4) + 4 + pad4(2 * rx + 4) + 4))
        per_term = pad32((sr + 7) * xw) + (2 * rz + 2) * pad32(mr * xw) + pad32((mr + 4) * tx)
        return 4 * (taps + pad32(sr * sw) + n_terms * per_term + pad32(mr * xw) + 4), sr, sw

    def fits(tile):
        b, sr, sw = smem(tile)
        return (b <= _SMEM_BYTES and sr <= 256 and sw <= 256 and sr * sw <= 4 * 512 * 8
                and n_terms * 2 * rz <= 16 and tile[0] // 4 * tile[1] <= 512)

    fitting = [t for t in titer.TILES if fits(t)]
    if layout is None:
        assert not fitting and titer.iter_block_error((40, 300, 400), radii, n_terms)
        assert titer.rl_iter_route((40, 300, 400), radii, n_terms) == "half_steps"
        return
    assert layout["smem_bytes"] == smem(layout["tile"])[0] <= _SMEM_BYTES
    assert layout["tile"] == fitting[0] and titer.iter_block_error((40, 300, 400), radii,
                                                                   n_terms) is None
    assert titer.rl_iter_route((40, 300, 400), radii, n_terms) == "one_launch"


@pytest.mark.parametrize("n_terms", [1, 2, 3])
@pytest.mark.parametrize("radii", [(0, 0, 0), (4, 10, 10), (8, 3, 3), (2, 30, 2), (2, 2, 60),
                                   (8, 30, 30), (4, 40, 40), (8, 56, 64), (5, 4, 4)])
def test_rl_iter_route_takes_half_steps_exactly_past_the_block(radii, n_terms):
    g_shape = tuple(n + 2 * r for n, r in zip((12, 280, 650), radii))
    fits = titer.iter_layout(g_shape, radii, n_terms) is not None
    assert titer.rl_iter_route(g_shape, radii, n_terms) == ("one_launch" if fits else "half_steps")
    assert (titer.iter_block_error(g_shape, radii, n_terms) is None) == fits
    assert titer.iter_bound_error(g_shape, radii, n_terms) is None


def test_rl_fused_iter_past_the_block_matches_fused_and_jax():
    """Two terms of an (11, 9, 9) PSF keep 2 x 10 adjoint z planes a
    thread, past the one-launch block: the card runs the half-steps. On
    the CPU both routes are the plain iteration, held here to the fused
    backend (the same update, the axes in another order: 1e-5) and to
    JAX's fused_iter (interpret mode) at this file's 1e-5."""
    def term(sz, sy, sx, amp):
        g = jdeconv.gaussian_psf((11, 9, 9), (sz, sy, sx)).astype(np.float64)
        wz, wy, wx = g.sum((1, 2)), g.sum((0, 2)), g.sum((0, 1))
        return wz * (amp / wz.sum()), wy / wy.sum(), wx / wx.sum()

    terms = [term(1.8, 1.6, 1.6, 0.7), term(2.6, 0.9, 2.2, 0.3)]
    psf = sum(np.einsum("z,y,x->zyx", *t) for t in terms)
    g_shape, radii = _grid(SHAPE, psf.shape)
    assert titer.rl_iter_route(g_shape, radii, 2) == "half_steps"
    assert jax_rl_iter_supported(SHAPE, psf.shape, n_terms=2)
    img = _blurred(SHAPE, psf, seed=30)
    s = DeconvolveSettings(algorithm="separable")
    ours = titer.rl_fused_iter(torch.from_numpy(img), np.asarray(psf, np.float32), terms, s, 2)
    fused = rl_fused(torch.from_numpy(img), np.asarray(psf, np.float32), terms, s, 2)
    assert _rel(ours.numpy(), fused.numpy()) <= 1e-5
    ref = np.asarray(jax_rl_fused_iter(img, psf, terms, s, 2))
    assert _rel(ours.numpy(), ref) <= 1e-5


def test_fused_iter_outside_its_bound_raises_naming_it():
    """Only what fused refuses: a y radius whose column of the three-pass
    route's y pass exceeds its shared memory."""
    psf = (np.ones((1, 425, 3)) / (425 * 3)).astype(np.float32)
    s = deconvolve_settings(iterations=1, separable_backend="fused_iter", psf_crop_tol=0.0)
    with pytest.raises(ValueError, match="fused_iter.*shared memory"):
        tdeconv.richardson_lucy(np.ones((4, 30, 30), np.float32), psf, s, device="cpu")
    # 'auto' never resolves to it, whatever the geometry.
    assert tdeconv.resolve_separable_backend("auto", SHAPE, PSF_SHAPE) == "fused"
    with pytest.raises(ValueError, match="fused_iter"):
        titer.rl_fused_iter(torch.ones((4, 30, 30)), psf, [(np.ones(1), np.ones(425) / 425,
                                                            np.ones(3) / 3)], s, 1)


def test_pack_taps_and_wrapper_guards():
    psf, terms = _case("rank2")
    conv, adj = Stencil(terms), Stencil(terms, flip=True)
    taps = titer.pack_taps(conv, adj, "cpu")
    # kz to a multiple of 4; ky and kx from index 3 of a 12 + 4 window.
    assert taps.shape == (2, 2, 8 + 16 + 16) and taps.dtype == torch.float32
    assert titer.window_taps(9) == 16 and titer.window_taps(21) == 28
    for d, st_ in enumerate((conv, adj)):
        for t, (wz, wy, wx) in enumerate(st_.host):
            want = np.zeros(40, np.float32)
            want[:5], want[8 + 3:8 + 12], want[24 + 3:24 + 12] = wz, wy, wx
            np.testing.assert_array_equal(taps[d, t].numpy(), want)
    np.testing.assert_array_equal(taps[1, 0, :5].numpy(), taps[0, 0, :5].numpy()[::-1])
    with pytest.raises(ValueError, match="differ"):
        titer.pack_taps(conv, Stencil(terms[:1], flip=True), "cpu")
    vol = torch.ones((6, 20, 20))
    before = titer.rl_iter_cuda.launches, titer.rl_iter_plain.cuda_calls
    titer.rl_iter(vol, vol, conv, adj)
    assert (titer.rl_iter_cuda.launches, titer.rl_iter_plain.cuda_calls) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        titer.rl_iter_cuda(vol, vol, conv, adj)
    with pytest.raises(ValueError, match="3-D"):
        titer.rl_iter_cuda(vol[0], vol[0], conv, adj)
    with pytest.raises(ValueError, match="CUDA tensor"):
        titer.rl_iter_half_steps(vol, vol, conv, adj)


@pytest.mark.parametrize("backend", ["fused_iter", "fused", "linear_pallas", "matmul"])
def test_donate_input_matches_and_consumes(backend):
    """Mirror of ``test_rl_fused_donate_input_matches_and_consumes``: the
    result is that of the non-donating run bit for bit and the caller's
    tensor is consumed; a numpy array is never touched."""
    vol = (np.random.default_rng(27).random((10, 40, 44), dtype=np.float32) * 50 + 1.0)
    keep = vol.copy()
    s = deconvolve_settings(algorithm="separable", separable_backend=backend, iterations=3)
    base = tdeconv.richardson_lucy(vol, PSF, s, device="cpu")
    s.donate_input = True
    given_up = torch.from_numpy(vol.copy()).clone()
    donated = tdeconv.richardson_lucy(given_up, PSF, s)
    torch.testing.assert_close(donated, base, rtol=0, atol=0)
    assert given_up.numel() == 0
    again = tdeconv.richardson_lucy(vol, PSF, s, device="cpu")
    torch.testing.assert_close(again, base, rtol=0, atol=0)
    np.testing.assert_array_equal(vol, keep)
    # Without it the caller's tensor is left as it was.
    s.donate_input = False
    kept = torch.from_numpy(vol.copy())
    tdeconv.richardson_lucy(kept, PSF, s)
    np.testing.assert_array_equal(kept.numpy(), keep)


@pytest.mark.parametrize("entry", ["richardson_lucy", "deskew_volume", "build_reconstruct_step",
                                   "reconstruct_batch", "Tracker.update", "Preprocessor",
                                   "gaussian_blur", "match_template",
                                   "focus_from_transverse_band", "VirtualStainer.predict"])
def test_numpy_input_without_device_asks_for_the_card(entry, monkeypatch):
    """A host array with no ``device`` goes to the card, so without one it
    raises; it never runs the plain versions on the CPU unasked. A tensor
    stays where its caller put it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from shrimpy_tpu_torch import config as tconfig
    from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band
    from shrimpy_tpu_torch.models.vsunet import VirtualStainer
    from shrimpy_tpu_torch.ops.features import gaussian_blur
    from shrimpy_tpu_torch.ops.match import match_template
    from shrimpy_tpu_torch.tracking import Tracker
    from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

    raw = np.random.default_rng(28).random((40, 24, 20)).astype(np.float32)
    desk = tconfig.deskew_settings(px_to_scan_ratio=0.386)
    rec = tconfig.reconstruct_settings(deskew=desk)
    track = tconfig.dynatrack_settings(tracking_method="intensity_center_of_mass",
                                       preprocessing=["deskew"], deskew={"px_to_scan_ratio": 0.386})
    calls = {
        "richardson_lucy": lambda x: tdeconv.richardson_lucy(x, PSF, iterations=1),
        "deskew_volume": lambda x: deskew_volume(x, desk),
        "build_reconstruct_step": lambda x: build_reconstruct_step(rec)(x[None]),
        "reconstruct_batch": lambda x: reconstruct_batch(x[None], rec),
        "Tracker.update": lambda x: torch.from_numpy(Tracker(track).update(x, 0).shift_px_zyx),
        "Preprocessor": lambda x: Preprocessor(track)(x)["deskewed"],
        "gaussian_blur": lambda x: gaussian_blur(x, 1.5),
        "match_template": lambda x: match_template(x, x[:4, :5, :6]),
        "focus_from_transverse_band": lambda x: torch.tensor(
            float(focus_from_transverse_band(x, pixel_size_um=0.116))),
        "VirtualStainer.predict": lambda x: VirtualStainer(tconfig.vs_settings(
            base_width=8, depth=2, in_slices=3)).predict(x)["vs_nuclei"],
    }
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\)"):
        calls[entry](raw)
    out = calls[entry](torch.from_numpy(raw))
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())


def _port_sources():
    files = sorted((REPO / "shrimpy_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "profile_step.py"]


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    pattern = re.compile(r"^\s*(import jax\b|from jax\b|import shrimpy_tpu[. ]|"
                         r"from shrimpy_tpu[. ]|import shrimpy_tpu$)", re.M)
    files = _port_sources()
    assert len(files) > 25
    names = {str(f.relative_to(REPO)) for f in files}
    assert {f"shrimpy_tpu_torch/{m}.py" for m in ("utils/fft", "ops/pcc", "ops/register",
                                                   "ops/affine_cuda", "models/train", "psf",
                                                   "utils/cache", "utils/retry", "io/platemap",
                                                   "engine/control", "engine/autoexposure",
                                                   "engine/plan", "engine/replay",
                                                   "tracking/position", "tracking/debug",
                                                   "native/__init__", "native/build",
                                                   "viewer/__init__", "viewer/ring",
                                                   "viewer/deskew_preview", "viewer/live",
                                                   "viewer/feeder", "viewer/web",
                                                   "parallel/mesh", "parallel/fft",
                                                   "parallel/launch", "io/chunkstore",
                                                   "io/ngff")} <= names
    hits = {str(f.relative_to(REPO)): pattern.findall(f.read_text()) for f in files}
    assert not {f: h for f, h in hits.items() if h}
    # The pattern does catch what it is after.
    for bad in ("import jax", "from jax import numpy", "    from shrimpy_tpu.io import ngff",
                "import shrimpy_tpu.config", "from shrimpy_tpu import io", "import shrimpy_tpu"):
        assert pattern.search(bad), bad
    assert not pattern.search("from shrimpy_tpu_torch.io import ngff")


@pytest.mark.parametrize("module", ["shrimpy_tpu_torch.cli.main",
                                    "shrimpy_tpu_torch.runtime.stream",
                                    "shrimpy_tpu_torch.ops.register",
                                    "shrimpy_tpu_torch.ops.pcc",
                                    "shrimpy_tpu_torch.ops.affine_cuda",
                                    "shrimpy_tpu_torch.utils.fft",
                                    "shrimpy_tpu_torch.tracking.preprocess",
                                    "shrimpy_tpu_torch.engine.autofocus",
                                    "shrimpy_tpu_torch.models.convert",
                                    "shrimpy_tpu_torch.models.train",
                                    "shrimpy_tpu_torch.psf",
                                    "shrimpy_tpu_torch.utils.cache",
                                    "shrimpy_tpu_torch.utils.retry",
                                    "shrimpy_tpu_torch.utils.timing",
                                    "shrimpy_tpu_torch.io.platemap",
                                    "shrimpy_tpu_torch.engine",
                                    "shrimpy_tpu_torch.engine.control",
                                    "shrimpy_tpu_torch.engine.autoexposure",
                                    "shrimpy_tpu_torch.engine.plan",
                                    "shrimpy_tpu_torch.engine.replay",
                                    "shrimpy_tpu_torch.tracking.position",
                                    "shrimpy_tpu_torch.tracking.debug",
                                    "shrimpy_tpu_torch.native",
                                    "shrimpy_tpu_torch.viewer",
                                    "shrimpy_tpu_torch.viewer.deskew_preview",
                                    "shrimpy_tpu_torch.viewer.live",
                                    "shrimpy_tpu_torch.viewer.web",
                                    "shrimpy_tpu_torch.parallel.launch",
                                    "shrimpy_tpu_torch.parallel.fft"])
def test_store_and_cli_layer_load_nothing_of_the_jax_package(module):
    """In a fresh interpreter, importing the layer (and, for the CLI,
    running a verb's ``--help`` and building the schema models) leaves no
    ``shrimpy_tpu`` module loaded."""
    code = textwrap.dedent(f"""
        import sys
        import {module} as mod
        if hasattr(mod, "cli"):
            from click.testing import CliRunner
            assert CliRunner().invoke(mod.cli, ["reconstruct", "--help"]).exit_code == 0
            assert CliRunner().invoke(mod.cli, ["register", "--help"]).exit_code == 0
            for verb in ("track", "train-vs", "measure-psf", "info", "plan", "replay",
                         "replay-dual", "monitor"):
                assert CliRunner().invoke(mod.cli, [verb, "--help"]).exit_code == 0
            assert CliRunner().invoke(mod.cli, ["microscopes"]).exit_code == 0
            result = CliRunner().invoke(mod.cli, ["plan", "validate", "configs/plan_demo.yml"])
            assert result.exit_code == 0, result.output
            assert CliRunner().invoke(mod.cli, ["plan", "show",
                                                "configs/plan_demo.yml"]).exit_code == 0
            from shrimpy_tpu_torch.config import ReconstructSettings, load_yaml_config
            load_yaml_config("configs/reconstruct_demo.yml", ReconstructSettings)
            from shrimpy_tpu_torch.config.microscopes import get_microscope
            get_microscope("mantis")
            import shrimpy_tpu_torch.io.synthetic
        if mod.__name__ == "shrimpy_tpu_torch.native":
            assert mod.load_ring() is not None
        bad = [m for m in sys.modules if m == "shrimpy_tpu" or m.startswith("shrimpy_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_card_host_modules_load_without_pydantic_yaml_tensorstore_click_matplotlib(tmp_path):
    """The card's machine has torch, numpy and scipy but none of pydantic,
    yaml, tensorstore, click or matplotlib: with those made unimportable,
    the modules the card path needs of ROADMAP item 12a, 12b and 12c import
    and run (the demo PFS on the plan namespace, the position loop with a
    tracker's correction, the timing context, run control, the plate map,
    autoexposure, the instrument rig, and the engine's event loop: a
    namespace plan with DynaTrack through ``chip_smoke.py``'s in-memory
    source and store), a run without the store's stand-in writes its
    OME-Zarr store through ``io/ngff.py`` on the port's chunk engine (no
    tensorstore), and ``engine/__init__.py`` serves the plan, the replay
    source and the dual-arm session only on demand."""
    code = textwrap.dedent("""
        import sys
        for name in ("pydantic", "yaml", "tensorstore", "click", "matplotlib"):
            sys.modules[name] = None
        import numpy as np
        from shrimpy_tpu_torch.config import autofocus_plan
        from shrimpy_tpu_torch.engine import RunControl
        from shrimpy_tpu_torch.engine.autoexposure import AutoexposureSettings, mean_intensity
        from shrimpy_tpu_torch.engine.autofocus import DemoAutofocus, focus_from_transverse_band
        from shrimpy_tpu_torch.engine.control import AbortRun
        from shrimpy_tpu_torch.io.platemap import PositionList
        from shrimpy_tpu_torch.tracking.position import PositionStore, PositionUpdateManager
        from shrimpy_tpu_torch.utils.timing import StageTimer, span

        af = DemoAutofocus(autofocus_plan(enabled=True, fail_at_indices=[1]), 2)
        assert [af.engage(0, p) for p in range(2)] == [True, False]
        store = PositionStore()
        store.set("P", 1.0, 2.0, 3.0)
        mgr = PositionUpdateManager(store, lambda s, t, p: np.array([1.0, 1.0, 1.0]))
        mgr.record_acquisition(0, "P")
        assert mgr.on_stack_complete(np.zeros((2, 2, 2)), 0, "P").result(timeout=10)
        assert mgr.drain_pending() and store.get("P").as_array().tolist() == [0.0, 1.0, 2.0]
        mgr.shutdown()
        with StageTimer().stage("stage", log=False), span("shrimpy.x"):
            pass
        assert RunControl().checkpoint() == 0.0 and issubclass(AbortRun, Exception)
        assert len(PositionList.from_plate_grid(["A"], ["1", "2"])) == 2
        assert mean_intensity(np.full((4, 4), 30000.0), 10.0, 5.0, AutoexposureSettings())[0] == 0
        try:
            import shrimpy_tpu_torch.engine as engine
            engine.AcquisitionPlan
        except ImportError:
            pass
        else:
            raise AssertionError("the plan loaded without pydantic")
        from shrimpy_tpu_torch.devices import LaserSpec, build_rig
        rig = build_rig([LaserSpec(channel="LS", power_mw=5.0)], o3_port="kim:o3")
        rig.run_start()
        rig.run_end()
        assert rig.summary()["lasers"]["LS"]["power_mw"] == 5.0
        import torch
        import chip_smoke
        from shrimpy_tpu_torch.config import acquisition_plan
        from shrimpy_tpu_torch.engine import AcquisitionEngine
        out_dir = sys.argv[1]
        blob = torch.zeros(6, 24, 24)
        blob[2:4, 10:13, 9:12] = 100.0

        def render(p, t, c):
            return torch.roll(blob, (0, t, -t), dims=(0, 1, 2)) + 1.0 + c

        def source():
            return chip_smoke.MemorySource(render, (3, 2, 6, 24, 24), (1.0, 1.0, 1.0),
                                           ["BF", "GFP"], ["0/0/000", "0/1/001"])

        plan = acquisition_plan(time={"n_timepoints": 3}, metadata={"dynatrack": {
            "input_channel": "BF", "tracking_channel": "BF", "tracking_method": "pcc",
            "image_to_stage_matrix_xyz": [[-1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]]}})
        import os
        AcquisitionEngine(source(), device="cpu").acquire(out_dir, "bare", plan)
        from shrimpy_tpu_torch.io import ngff
        bare = ngff.open_ngff(os.path.join(out_dir, "bare.zarr"))
        assert sorted(bare.positions()) == ["0/0/000", "0/1/001"]
        for pos in bare.positions().values():
            assert pos.written_timepoints() == [0, 1, 2] and pos.read().shape == (3, 2, 6, 24, 24)
        store = chip_smoke.MemoryStore("cpu")
        out, records, stage, log = chip_smoke.run_engine(source(), store, plan, "cpu", out_dir)
        assert not log.bad and all(f.result(timeout=0) is True for _, _, f in records["futures"])
        assert len(records["futures"]) == 6
        assert sum(len(p.written) for p in store.positions.values()) == 12
        assert stage.get("0/0/000").as_array().tolist() == [-2.0, 2.0, 0.0]  # x, y, z
        for name in ("shrimpy_tpu_torch.engine.plan", "shrimpy_tpu_torch.engine.replay",
                     "shrimpy_tpu_torch.engine.dual"):
            assert sys.modules.get(name) is None, name
        assert sys.modules["shrimpy_tpu_torch.io.ngff"] is ngff and ngff.ts.__name__.endswith(
            "chunkstore")
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_probe_slice_plain_is_the_tpu_probes_expectation():
    x = torch.arange(8 * 512, dtype=torch.float32).reshape(8, 512)
    xr = x.numpy()
    expect = np.concatenate([2 * xr[:, 0:128], 2 * xr[:, 0:128], 2 * xr[:, 128:256],
                             2 * xr[:, 256:384]], axis=1)  # scripts/probe_mosaic.py:39-42
    np.testing.assert_array_equal(probes.dynamic_smem_slice_plain(x).numpy(), expect)
    assert probes.probe_dynamic_smem_slice("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        probes.dynamic_smem_slice_cuda(x)
    with pytest.raises(ValueError, match="asks the card"):
        probes.probe_smem(48, "cpu")


@pytest.mark.parametrize("kb", probes.SMEM_KB)
def test_probe_smem_plain_counts_and_sums_the_pattern(kb):
    words, total = probes.smem_touch_plain(kb)
    assert words == kb * 256
    assert total == sum((i * 2654435761) % 2**32 for i in range(words)) % 2**32
    assert (kb * 1024 <= _SMEM_BYTES) == (kb <= 227)


@pytest.mark.parametrize("mode", sorted(probes.DOT_MODES))
def test_split_dot_plain_errors(mode):
    """The split products with exact accumulation, against float64: the
    three-pass splits within the probe's gate, the one-pass ones at their
    formats' precision (bf16 8 bits, TF32 11)."""
    a, b = probes.dot_operands("cpu", 0)
    assert a.shape == (128, 160) and b.shape == (160, 512)
    ref = a.double() @ b.double()
    err = _rel(probes.split_dot_plain(a, b, mode).numpy(), ref.numpy())
    lo, hi = {"fma": (0.0, 0.0), "bf16x3": (1e-7, probes.SPLIT_RTOL),
              "tf32x3": (0.0, 1e-6), "tf32": (1e-5, 1e-3), "bf16": (2e-4, 1e-2)}[mode]
    assert lo <= err <= hi, err
    assert probes.probe_split_dot("cpu")[mode]["vs_plain"] == 0.0
    with pytest.raises(ValueError, match="CUDA tensor"):
        probes.split_dot_cuda(a, b, mode)


@pytest.mark.parametrize("m,k,n", [(32, 16, 8), (96, 16, 8), (64, 16, 12), (64, 12, 8),
                                   (64, 20, 264), (0, 16, 8)])
def test_split_dot_cuda_refuses_shapes_the_kernel_does_not_take(m, k, n):
    """m a multiple of 64 (wgmma's rows), n and k of 8 (the TF32 depth):
    any other shape raises before the card is asked."""
    a, b = torch.zeros((m, k)), torch.zeros((k, n))
    for mode in probes.DOT_MODES:
        with pytest.raises(ValueError, match="multiple of 64"):
            probes.split_dot_cuda(a, b, mode)


@pytest.mark.parametrize("m,k,n", [(64, 16, 8), (192, 168, 264), (64, 1024, 256)])
def test_split_dot_cuda_refuses_a_cpu_tensor(m, k, n):
    a, b = probes.dot_operands("cpu", 1, ((m, k), (k, n)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        probes.split_dot_cuda(a, b, "bf16x3")


@pytest.mark.parametrize("probe", [lambda: probes.largest_smem("cpu"),
                                   lambda: probes.probe_smem(227, torch.device("cpu"))])
def test_smem_probes_ask_the_card(probe):
    with pytest.raises(ValueError, match="asks the card"):
        probe()


def test_smem_touch_bound_by_hand():
    """The largest block writes and reads its 232,448 bytes once: 464,896
    bytes at 128 a clock are 3632 clocks, 1.834 us at 1980 MHz."""
    assert probes.smem_touch_bytes(227) == 464896
    assert probes.smem_bound_ms(464896, 1980.0) == pytest.approx(3632 / 1.98e6, rel=1e-12)
    assert probes.smem_bound_ms(128, 1000.0) == pytest.approx(1e-6, rel=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.from_numpy(np.random.default_rng(29).standard_normal(4096).astype(np.float32))
    r = probes.round_tf32(x)
    assert torch.equal(probes.round_tf32(r), r)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11
    # A tie rounds away from zero, on both signs.
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert torch.equal(probes.round_tf32(tie), torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10)]))
