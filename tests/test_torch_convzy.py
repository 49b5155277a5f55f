"""PyTorch port: the z+y step of ``linear_pallas`` and ``zy_pallas`` and
the x pass in pieces, against the JAX package (CPU).

The z+y step takes one of two routes on the card, chosen from the shapes
alone: the march kernel of ``csrc/convzy.cu`` where its block fits, else
two single-axis passes. Here: the route and the march kernel's
shared-memory sum (the kernel's own sum is held to it on the card in
``tests/test_torch_cuda.py``); the bound, which takes every radius JAX's
``linear_pallas`` takes; RL with a PSF past the bound of the kernel
before the redesign, against JAX's ``linear_pallas`` and ``zy_pallas``
(Pallas interpret mode) at relative error ``max|a-b| / max|b|`` <= 1e-4,
the budget of ``tests/test_torch_linear.py`` and
``tests/test_torch_circular.py``; the x pass's pieces of a long row.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.ops.conv3_pallas import lp_layout
from shrimpy_tpu_torch.ops import conv3_cuda as c3
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import rl_fused as trl
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

CARRY = (136, 2908, 1620)  # the production G grid, PSF (9, 21, 21)
WIDE_PSF = jdeconv.gaussian_psf((17, 61, 61), (3.0, 9.0, 9.0))  # past the old kernel's slab


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _smem(tile, rz, ry):
    """csrc/convzy.cu::convzy_smem_floats, written out: the taps (kz to a
    multiple of 4, 3 zeros, ky, zeros to a multiple of 4 and 4 more), the
    ring of 2 rz + 4 slabs (three in flight), two z-pass planes after 4
    guard rows, every region 128-byte aligned, and an 8-byte mbarrier a
    slot."""
    pad4 = lambda n: -(-n // 4) * 4  # noqa: E731
    pad32 = lambda n: -(-n // 32) * 32  # noqa: E731
    ty, tx = tile
    slab, slots = (ty + 2 * ry) * tx, 2 * rz + 4
    taps = pad32(pad4(2 * rz + 1) + pad4(2 * ry + 4) + 4)
    return 4 * (taps + slots * pad32(slab) + 2 * pad32(4 * tx + slab) + pad4(2 * slots))


def test_production_geometry_marches():
    layout = c3.convzy_layout(CARRY, (4, 10))
    assert layout == {"tile": c3.CONVZY_TILES[0], "threads": 512, "blocks": 46 * 51,
                      "smem_bytes": _smem(c3.CONVZY_TILES[0], 4, 10)}
    for boundary in c3.BOUNDARIES:
        assert c3.convzy_route(CARRY, (4, 10), boundary) == "march"
    with pytest.raises(ValueError, match="boundary"):
        c3.convzy_route(CARRY, (4, 10), "reflect")
    # A forced tile that fits, one that does not.
    assert c3.convzy_layout(CARRY, (4, 10), tile=(8, 32))["tile"] == (8, 32)
    assert c3.convzy_layout(CARRY, (4, 10), tile=(64, 64)) is None
    assert c3.convzy_layout(CARRY, (4, 10), tile=(6, 32)) is None


@settings(max_examples=80, deadline=None)
@given(rz=st.integers(0, 12), ry=st.integers(0, 130), gy=st.sampled_from([9, 300, 2908]))
def test_convzy_route_marches_exactly_where_the_block_fits(rz, ry, gy):
    """Whatever the layout accepts fits a block; it picks the first tile
    that does; past every tile the two-pass route runs (it takes every
    radius)."""
    shape = (40, gy, 400)

    def fits(tile):
        ty, tx = tile
        return (_smem(tile, rz, ry) <= trl._SMEM_BYTES and ty + 2 * ry <= 256 and tx <= 256
                and ty // 4 * tx <= 512)

    fitting = [t for t in c3.CONVZY_TILES if fits(t)]
    layout = c3.convzy_layout(shape, (rz, ry))
    for boundary in c3.BOUNDARIES:
        route = c3.convzy_route(shape, (rz, ry), boundary)
        assert route == ("march" if fitting else "two_pass")
    if layout is None:
        assert not fitting
        return
    assert layout["tile"] == fitting[0]
    assert layout["smem_bytes"] == c3.convzy_smem_bytes(layout["tile"], (rz, ry))
    assert layout["smem_bytes"] == _smem(layout["tile"], rz, ry) <= trl._SMEM_BYTES


def test_convzy_bound_takes_every_radius_of_jax_s_linear_pallas():
    """Every (rz, ry) that lp_layout accepts (rz <= 8, ry <= 125) runs on
    one of the two routes, at the production carry and on a small one;
    the radii that the kernel before the redesign refused (ry past 40 at
    rz = 4, past 21 at rz = 8) among them."""
    taken = 0
    for rz in range(0, 9):
        for ry in range(0, 126):
            lp_layout(CARRY, rz, ry)  # raises where JAX's linear_pallas refuses
            taken += 1
            for shape in (CARRY, (20, 40, 30)):
                assert c3.convzy_route(shape, (rz, ry)) in c3.ROUTES, (rz, ry)
    assert taken == 9 * 126
    with pytest.raises(ValueError):
        lp_layout(CARRY, 9, 10)
    with pytest.raises(ValueError):
        lp_layout(CARRY, 4, 126)
    assert c3.convzy_route(CARRY, (4, 41), "circular") == "march"
    assert c3.convzy_route(CARRY, (8, 125), "zero") == "two_pass"


def test_zy_pallas_takes_radii_past_the_two_pass_column():
    """The z+y radius gap against JAX's zy_pallas is closed (ROADMAP §3):
    past 211, where the two-pass route's column of (32 + 2 r) x 128
    floats outgrows a block's shared memory, conv_axis takes the taps in
    chunks, so every radius has a route, on either boundary and axis."""
    column = lambda r: (trl._TILE_N + 2 * r) * trl._THREADS_INNER * 4  # noqa: E731
    assert column(211) <= trl._SMEM_BYTES < column(212)
    for r in (211, 212, 300, 600):
        for radii in ((4, r), (r, 0), (r, r)):
            for boundary in c3.BOUNDARIES:
                assert c3.convzy_route((8, 440, 40), radii, boundary) == "two_pass"
    with pytest.raises(ValueError, match="boundary"):
        c3.convzy_route((8, 440, 40), (4, 212), "reflect")


def test_rl_past_the_two_pass_column_matches_jax():
    """RL-2 on zy_pallas with a (3, 431, 3) PSF (y radius 215, past the
    two-pass route's column) on a small image, against JAX's zy_pallas in
    interpret mode; on the card the two-pass route takes its taps in
    chunks. (JAX's linear_pallas refuses a y radius past 125.)"""
    psf = jdeconv.gaussian_psf((3, 431, 3), (0.8, 60.0, 0.8))
    img = _blurred((4, 10, 38), psf, seed=37)
    s = DeconvolveSettings(algorithm="separable", separable_backend="zy_pallas", iterations=2,
                           psf_crop_tol=0.0)
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol))
    assert psf_w.shape == (3, 431, 3)
    terms = jdeconv.plan_separable_terms(psf_w, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    assert _rel(ours, ref) <= 1e-4
    assert c3.convzy_route((6, 440, 40), (1, 215), "circular") == "two_pass"


def test_zy_taps_are_the_first_part_of_a_packed_row():
    rng = np.random.default_rng(3)
    for lengths in ((9, 21, 21), (1, 1, 1), (7, 11, 13), (17, 61, 5)):
        terms = [tuple(rng.random(k).astype(np.float32) for k in lengths) for _ in range(2)]
        stencil = trl.Stencil(terms)
        packed = torch.from_numpy(stencil.packed_host())
        for t, (wz, wy, _) in enumerate(stencil.host):
            got = c3.zy_taps(torch.tensor(wz.copy(), dtype=torch.float32),
                             torch.tensor(wy.copy(), dtype=torch.float32))
            assert torch.equal(got, packed[t, :got.numel()])
            assert got.numel() == trl._round4(lengths[0]) + trl.window_taps(lengths[1])


@pytest.mark.parametrize("backend", ["linear_pallas", "zy_pallas"])
def test_rl_past_the_old_bound_matches_jax(backend):
    """RL-2 with a (17, 61, 61) PSF (rz 8, ry 30: the kernel before the
    redesign refused ry past 21 at rz = 8) on a small image, against
    JAX's backend of the same name in interpret mode; on the card the
    march kernel takes it."""
    img = _blurred((5, 14, 18), WIDE_PSF, seed=31)
    s = DeconvolveSettings(algorithm="separable", separable_backend=backend, iterations=2,
                           psf_crop_tol=0.0)
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(WIDE_PSF, s.psf_crop_tol))
    assert psf_w.shape == (17, 61, 61)
    terms = jdeconv.plan_separable_terms(psf_w, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, WIDE_PSF, s))
    ours = tdeconv.richardson_lucy(img, WIDE_PSF, s, terms=terms, device="cpu").numpy()
    assert _rel(ours, ref) <= 1e-4
    g_shape = tuple(n + k - 1 for n, k in zip(img.shape, psf_w.shape))
    boundary = "zero" if backend == "linear_pallas" else "circular"
    assert c3.convzy_route(g_shape, (8, 30), boundary) == "march"


@pytest.mark.parametrize("gx,rx", [(1620, 10), (58108, 4), (60000, 10), (400, 28000),
                                   (200000, 3), (60200, 29000), (130, 29000)])
def test_x_pass_walks_a_long_row_in_pieces(gx, rx):
    """A row that fits shared memory is one piece (the production carry
    keeps its launches); a longer one is cut into pieces of a multiple of
    128 columns that fit with their halo; past that only the x radius is
    refused."""
    piece = trl.x_piece(gx, rx)
    fits_whole = (gx + 2 * rx) * 4 + 64 <= trl._SMEM_BYTES
    if fits_whole:
        assert piece == gx
    elif piece:
        assert piece % 128 == 0 and 128 <= piece <= 16384 and piece < gx
        assert (piece + 2 * rx) * 4 + 64 <= trl._SMEM_BYTES
    shape = (3, 5, gx)
    err = trl.fused_bound_error(shape, (1, 1, rx))
    assert (err is None) == (piece > 0)
    if piece:
        assert trl.x_blocks(shape, rx) == 15 * -(-gx // piece)
    else:
        assert "x radius" in err


def test_three_pass_partials_are_one_pair_a_block_of_the_x_pass():
    # A plane no one-launch tile takes (gy * gx past 32 bits): the three
    # passes, whose mult_accel writes a pair a piece of a row.
    shape, radii = (4, 40000, 60000), (1, 1, 1)
    assert trl.half_step_route(shape, radii) == "three_pass"
    assert trl.x_piece(60000, 1) == 16384
    assert trl.partial_rows(shape, radii) == 4 * 40000 * 4
    assert trl.partial_rows((4, 40000, 56000), radii) == 4 * 40000
    # Rows that fit stay one block each.
    assert trl.x_blocks((136, 2908, 1620), 10) == 136 * 2908
