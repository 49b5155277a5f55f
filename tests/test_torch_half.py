"""The one-launch half-step of the port's ``fused`` backend (CPU side).

The kernel (``csrc/rl_half.cu``) runs only on a card; what the CPU can
hold is everything around it: which route a geometry takes
(``half_step_route``: one launch, else three passes a term; past both
``auto`` gives ``matmul``), the tile and the shared memory the Python
side computes for it (held equal to the kernel's own sum by a ``cuda``
test), the packed tap layout the kernel reads, and that ``rl_fused`` on
a CPU tensor still agrees with the JAX ``fused`` backend (Pallas in
interpret mode): relative error ``max|a-b| / max|b|`` <= 1e-4 for plain
RL, the two-tier gate of ``tests/test_rl_fused.py:244-245`` for Biggs
(an eps clamp may flip at isolated voxels), with 1 and 2 terms.
"""

import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import rl_fused as trl
from shrimpy_tpu_torch.ops.rl_fused import (
    HALF_TILES,
    ROUTES,
    Stencil,
    fused_bound_error,
    half_bound_error,
    half_layout,
    half_slab,
    half_smem_bytes,
    half_step_cuda,
    half_step_one_launch,
    half_step_route,
    half_step_three_pass,
    partial_rows,
    term_tap_floats,
    window_taps,
)
from tests.test_torch_rl import _blurred, _rank2_psf

torch.set_num_threads(1)

# The production G grid and radii: raw (1201, 256, 1600) deskewed to
# (128, 2888, 1600), PSF (9, 21, 21).
CARRY, RADII = (136, 2908, 1620), (4, 10, 10)
# The tolerance at which the rank-2 PSF of tests/test_torch_rl.py plans two terms.
TWO_TERM_TOL = 0.04


def test_production_geometry_takes_the_one_launch_route():
    assert half_bound_error(CARRY, RADII) is None
    assert half_step_route(CARRY, RADII) == "one_launch" == ROUTES[0]
    layout = half_layout(CARRY, RADII)
    assert layout["tile"] == HALF_TILES[0] == (32, 64) and layout["threads"] == 512
    assert layout["blocks"] == -(-CARRY[1] // 32) * -(-CARRY[2] // 64) == 2366
    assert layout["smem_bytes"] == half_smem_bytes((32, 64), RADII, 1) <= trl._SMEM_BYTES
    # One pair of Biggs partial sums a block, not an x row.
    assert partial_rows(CARRY, RADII) == 2366


@pytest.mark.parametrize("radii,n_terms,shape", [
    ((60, 10, 10), 1, (200, 300, 400)),    # the ring of 2 rz + 2 slabs outgrows a block
    ((4, 130, 10), 1, (40, 600, 400)),     # a slab of more rows than a TMA box takes
    ((4, 10, 120), 1, (40, 300, 800)),     # ... of more columns
    ((3, 5, 5), 1, (20, 60000, 40000)),    # a plane that 32 bits do not index
])
def test_geometry_past_the_block_takes_three_passes(radii, n_terms, shape):
    assert fused_bound_error(shape, radii) is None
    msg = half_bound_error(shape, radii, n_terms)
    assert msg and ("radii" in msg or "launch grid" in msg)
    assert half_layout(shape, radii, n_terms) is None
    assert half_step_route(shape, radii, n_terms) == "three_pass" == ROUTES[1]
    assert partial_rows(shape, radii, n_terms) == shape[0] * shape[1]
    # auto reads the wider bound: still fused.
    image = tuple(n - 2 * r for n, r in zip(shape, radii))
    psf = tuple(2 * r + 1 for r in radii)
    assert tdeconv.resolve_separable_backend("auto", image, psf) == "fused"


def test_geometry_past_both_routes_resolves_to_matmul():
    radii, shape = (4, 230, 10), (40, 700, 400)
    assert fused_bound_error(shape, radii) is not None
    assert half_bound_error(shape, radii) is not None
    with pytest.raises(ValueError, match="shared memory"):
        half_step_route(shape, radii)
    image = tuple(n - 2 * r for n, r in zip(shape, radii))
    psf = tuple(2 * r + 1 for r in radii)
    assert tdeconv.resolve_separable_backend("auto", image, psf) == "matmul"


@pytest.mark.parametrize("radii,n_terms", [((4, 10, 10), 1), ((4, 10, 10), 3), ((2, 4, 4), 2),
                                            ((6, 12, 12), 1), ((0, 0, 0), 1), ((3, 9, 11), 2)])
def test_layout_picks_the_first_tile_that_fits(radii, n_terms):
    shape = (40, 300, 400)
    fits = [t for t in HALF_TILES
            if half_smem_bytes(t, radii, n_terms) <= trl._SMEM_BYTES
            and half_layout(shape, radii, n_terms, tile=t) is not None]
    layout = half_layout(shape, radii, n_terms)
    assert fits and layout["tile"] == fits[0]
    assert layout["smem_bytes"] == half_smem_bytes(fits[0], radii, n_terms)
    ty, tx = layout["tile"]
    assert layout["blocks"] == -(-shape[1] // ty) * -(-shape[2] // tx)
    # A forced tile that does not fit gives no layout.
    assert half_layout(shape, (60, 10, 10), 1, tile=(8, 32)) is None


@pytest.mark.parametrize("tile", HALF_TILES)
@pytest.mark.parametrize("radii,n_terms", [((4, 10, 10), 1), ((3, 9, 11), 2), ((0, 0, 0), 1)])
def test_shared_memory_sum_by_hand(tile, radii, n_terms):
    """The byte count, term by term, as the kernel lays a block out."""
    (ty, tx), (rz, ry, rx) = tile, radii
    rows, cols = half_slab(tile, radii)
    assert rows == ty + 2 * ry
    rx4 = (rx + 3) & ~3
    assert cols % 4 == 0 and rx4 + tx + rx <= cols < rx4 + tx + rx + 4
    slab = -(-rows * cols // 32) * 32                    # a slot starts at a multiple of 128 bytes
    taps = n_terms * term_tap_floats(tuple(2 * r + 1 for r in radii))
    floats = (-(-taps // 32) * 32                        # the packed taps
              + (2 * rz + 2) * slab                      # the ring, one slot in flight
              + slab + 4 * cols                          # the z pass's plane after its guard rows
              + ty * (tx + ((2 * rx + 4 + 3) & ~3) - 4)  # the y pass's plane
              + slab // 2                                # the bf16 dx in flight
              + 4)                                       # the mbarrier
    assert half_smem_bytes(tile, radii, n_terms) == 4 * floats


def test_packed_taps_layout():
    rng = np.random.default_rng(5)
    terms = [tuple(rng.random(k) + 0.1 for k in (5, 9, 11)) for _ in range(2)]
    for flip in (False, True):
        st = Stencil(terms, flip=flip)
        packed = st.packed_host()
        assert packed.dtype == np.float32
        assert packed.shape == (2, term_tap_floats((5, 9, 11))) == (2, 8 + 16 + 20)
        assert window_taps(9) == 16 and window_taps(11) == 20
        for t, (wz, wy, wx) in enumerate(st.host):
            np.testing.assert_array_equal(packed[t, :5], wz.astype(np.float32))
            np.testing.assert_array_equal(packed[t, 8 + 3:8 + 12], wy.astype(np.float32))
            np.testing.assert_array_equal(packed[t, 24 + 3:24 + 14], wx.astype(np.float32))
            rest = np.ones(packed.shape[1], bool)
            for lo, hi in ((0, 5), (11, 20), (27, 38)):
                rest[lo:hi] = False
            assert not packed[t, rest].any()
    with pytest.raises(ValueError, match="CUDA"):
        Stencil(terms).packed()


def test_route_counters_and_forced_route_on_the_cpu():
    """No kernel route runs on a CPU tensor: it raises, and no counter
    moves."""
    st = Stencil([(np.ones(3), np.ones(3), np.ones(3))])
    vol = torch.ones((6, 20, 20))
    def counts():
        return (half_step_cuda.launches, half_step_cuda.accel_launches,
                half_step_one_launch.launches, half_step_three_pass.launches)

    before = counts()
    for step in (half_step_cuda, half_step_one_launch, half_step_three_pass):
        with pytest.raises(ValueError, match="CUDA tensor"):
            step(vol, vol, st, "ratio")
    assert before == counts()
    assert trl.half_step(vol, vol, st, "ratio").shape == vol.shape


def _jax_terms(psf, s):
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol))
    return jdeconv.plan_separable_terms(psf_w, s)


@pytest.mark.parametrize("psf_name,n_terms", [("gaussian", 1), ("rank2", 2)])
def test_rl_fused_matches_jax_fused_backend(psf_name, n_terms):
    """Plain RL, 2 iterations at tests/test_rl_fused.py's SHAPE, JAX's
    planned terms fed to both packages."""
    psf = (jdeconv.gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6)) if psf_name == "gaussian"
           else _rank2_psf((5, 9, 9)))
    shape = (12, 280, 650)
    img = _blurred(shape, psf, seed=2)
    s = DeconvolveSettings(algorithm="separable", separable_backend="fused", iterations=2,
                           separable_tol=TWO_TERM_TOL)
    terms = _jax_terms(psf, s)
    assert len(terms) == n_terms
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, f"rel err {err:.2e}"


@pytest.mark.parametrize("psf_name,n_terms", [("gaussian", 1), ("rank2", 2)])
def test_biggs_rl_fused_matches_jax_fused_backend(psf_name, n_terms):
    psf = (jdeconv.gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6)) if psf_name == "gaussian"
           else _rank2_psf((5, 9, 9)))
    shape = (12, 280, 650)
    img = _blurred(shape, psf, seed=3)
    s = DeconvolveSettings(algorithm="separable", separable_backend="fused", iterations=4,
                           acceleration="biggs", separable_tol=TWO_TERM_TOL)
    terms = _jax_terms(psf, s)
    assert len(terms) == n_terms
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s)).astype(np.float64)
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    scale = np.abs(ref).max()
    diff = np.abs(ours - ref)
    assert (diff <= 5e-4 * scale).mean() >= 0.9999
    assert diff.max() <= 2e-2 * scale
