"""PyTorch port of the deskew against the JAX package (CPU).

The port's plain version (what a CPU tensor runs) is held against the
JAX XLA path, the Pallas kernel in interpret mode and the scipy oracle;
the host copies and the CUDA kernel's interpolation tables are pinned
to their JAX originals. Tolerances: ``rtol=1e-4, atol=1e-3`` against
the JAX kernels (as ``tests/test_deskew_pallas.py``), relative error
1e-3 against scipy.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DeskewSettings
from shrimpy_tpu.io.synthetic import render_beads_skewed
from shrimpy_tpu.ops import deskew as jdeskew
from shrimpy_tpu.ops.deskew_pallas import _deskew_pallas_jit, _plan
from shrimpy_tpu_torch.ops import deskew as tdeskew
from shrimpy_tpu_torch.ops import deskew_cuda as dcuda
from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda, plan_tables

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

# (raw shape, keep_overhang, average_n_slices, value scale): the JAX
# pallas tests' geometries, z-averaging, and the long-scan band-clamp
# geometry (several y blocks of overhang) both ways.
CASES = [
    ((40, 32, 24), False, 1, 100.0),
    ((40, 32, 24), True, 1, 100.0),
    ((40, 32, 16), False, 3, 1.0),
    ((41, 30, 16), True, 3, 1.0),
    ((180, 64, 64), True, 1, 1.0),
    ((180, 64, 64), False, 1, 1.0),
]


def _settings(keep_overhang=False, average_n_slices=1, **kw):
    return DeskewSettings(
        ls_angle_deg=kw.pop("ls_angle_deg", 30.0), px_to_scan_ratio=0.386,
        keep_overhang=keep_overhang, average_n_slices=average_n_slices, **kw,
    )


def _jax_kwargs(s):
    return dict(
        ls_angle_deg=s.ls_angle_deg, px_to_scan_ratio=s.px_to_scan_ratio,
        keep_overhang=s.keep_overhang, average_n_slices=s.average_n_slices,
    )


@pytest.mark.parametrize("shape,keep_overhang,avg,scale", CASES)
def test_plain_matches_jax_xla_and_pallas(shape, keep_overhang, avg, scale):
    rng = np.random.default_rng(7)
    raw = (rng.random(shape) * scale).astype(np.float32)
    s = _settings(keep_overhang, avg)
    ours = tdeskew.deskew_volume(raw, s, device="cpu")
    assert ours.dtype == torch.float32 and not ours.is_cuda
    ours = ours.numpy()
    xla = np.asarray(jdeskew._deskew_xla(jnp.asarray(raw), **_jax_kwargs(s)))
    pallas = np.asarray(
        _deskew_pallas_jit(jnp.asarray(raw), **_jax_kwargs(s), interpret=True)
    )
    assert ours.shape == xla.shape == pallas.shape
    np.testing.assert_allclose(ours, xla, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("keep_overhang", [False, True])
@pytest.mark.parametrize("avg", [1, 3])
def test_plain_matches_scipy_oracle(keep_overhang, avg):
    rng = np.random.default_rng(3)
    raw = (rng.random((48, 24, 16)) * 50.0).astype(np.float32)
    s = _settings(keep_overhang, avg)
    ours = tdeskew.deskew_volume(raw, s, device="cpu").numpy()
    oracle = jdeskew.deskew_reference_scipy(raw, s)
    err = np.abs(ours - oracle).max() / np.abs(oracle).max()
    assert err <= 1e-3, f"rel err {err:.2e}"


def test_plain_float64_matches_scipy_tightly():
    """The float64 plain path (the reference of the on-card whole-step
    check) is the scipy oracle to float64 round-off, tail group included."""
    rng = np.random.default_rng(5)
    raw = rng.random((41, 30, 12)) * 50.0
    s = _settings(True, 4)
    ours = tdeskew.deskew_plain(torch.from_numpy(raw), s, dtype=torch.float64).numpy()
    from scipy import ndimage

    m, off, out_shape = jdeskew.deskew_affine_matrix(raw.shape, s)
    full = ndimage.affine_transform(raw, m, offset=off, output_shape=out_shape,
                                    order=1, mode="grid-constant", cval=0.0)
    groups = np.stack([full[i : i + 4].mean(0) for i in range(0, full.shape[0], 4)])
    np.testing.assert_allclose(ours, groups, rtol=0, atol=1e-9)


def test_beads_land_correctly():
    """Beads rendered in skewed space appear at their lab positions
    (minus the fully-sampled-band y crop)."""
    s = _settings()
    beads = np.array([[6.0, 60.0, 12.0], [10.0, 80.0, 20.0]])
    raw = render_beads_skewed((64, 48, 32), beads)
    out = tdeskew.deskew_volume(raw, s, device="cpu").numpy()
    y_off = 47 * math.cos(math.radians(30.0))
    for z, y, x in beads:
        zi, yi, xi = int(round(z)), int(round(y - y_off)), int(round(x))
        patch = out[zi - 2 : zi + 3, yi - 2 : yi + 3, xi - 2 : xi + 3]
        assert patch.max() > 0.3 * out.max()


@pytest.mark.parametrize("keep_overhang", [False, True])
@pytest.mark.parametrize("avg", [1, 2])
@pytest.mark.parametrize("angle", [30.0, 45.0])
def test_host_copies_equal_originals(keep_overhang, avg, angle):
    s = _settings(keep_overhang, avg, ls_angle_deg=angle, pixel_size_um=0.116)
    for shape in [(40, 32, 24), (1201, 256, 1600), (300, 2048, 2048)]:
        try:
            want = jdeskew._geometry(shape, s)
        except ValueError as exc:  # empty fully-sampled band
            with pytest.raises(ValueError, match="fully-sampled band is empty"):
                tdeskew._geometry(shape, s)
            assert "fully-sampled band is empty" in str(exc)
            continue
        assert tdeskew._geometry(shape, s) == want
        assert tdeskew.get_deskewed_shape(shape, s) == jdeskew.get_deskewed_shape(shape, s)
        assert tdeskew.get_deskewed_shape(shape, s, 0.2) == jdeskew.get_deskewed_shape(
            shape, s, 0.2
        )
        for a, b in zip(tdeskew.deskew_affine_matrix(shape, s),
                        jdeskew.deskew_affine_matrix(shape, s)):
            np.testing.assert_array_equal(a, b)
    raw = np.random.default_rng(1).random((30, 20, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tdeskew.deskew_reference_scipy(raw, s), jdeskew.deskew_reference_scipy(raw, s)
    )


def test_voxel_scale_carries_average():
    s = _settings(average_n_slices=3, pixel_size_um=0.116)
    assert tdeskew.get_deskewed_shape((40, 32, 16), s)[1] == pytest.approx(
        (3 * 0.116, 0.116, 0.116)
    )


@pytest.mark.parametrize("nz,n", [(12, 1), (12, 3), (13, 3), (14, 4), (2, 5)])
def test_average_z_groups_matches_jax(nz, n):
    vol = np.random.default_rng(nz).random((nz, 5, 4)).astype(np.float32)
    ours = tdeskew._average_z_groups(torch.from_numpy(vol), n).numpy()
    ref = np.asarray(jdeskew._average_z_groups(jnp.asarray(vol), n))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def _decode_jax_plan(plan):
    """The JAX pallas plan's band-local meta as global per-(z, y) tables."""
    meta, bz, nz, ny = plan["meta"], plan["bz_raw"], plan["nz"], plan["ny"]
    z = np.arange(nz)[:, None]
    y = np.arange(ny)[None, :]

    def row(k):
        return meta[z // bz, y // 128, (z % bz) * 8 + k, y % 128]

    s_lo = plan["s_lo"][z // bz, y // 128]
    t_lo = np.repeat(plan["t_lo"], bz)[:nz]
    return {
        "w00": row(0), "w01": row(1),
        "s0": s_lo + row(2).astype(np.int64), "s1": s_lo + row(3).astype(np.int64),
        "wt0": row(4)[:, 0], "wt1": row(5)[:, 0],
        "t0": t_lo + row(6)[:, 0].astype(np.int64),
        "t1": t_lo + row(7)[:, 0].astype(np.int64),
    }


@pytest.mark.parametrize("shape,keep_overhang,avg,scale", CASES)
def test_plan_tables_match_jax_plan(shape, keep_overhang, avg, scale):
    s = _settings(keep_overhang, avg)
    ours = plan_tables(shape, s)
    ref = _decode_jax_plan(_plan(shape, s))
    assert ours["nz"] == _plan(shape, s)["nz"]
    assert ours["n_groups"] == _plan(shape, s)["n_groups"]
    for w in ("w00", "w01", "wt0", "wt1"):
        np.testing.assert_allclose(ours[w], ref[w], rtol=1e-6, atol=0, err_msg=w)
    # Indices agree wherever their weight is non-zero.
    for idx, w in (("s0", "w00"), ("s1", "w01"), ("t0", "wt0"), ("t1", "wt1")):
        live = ours[w] != 0
        np.testing.assert_array_equal(ours[idx][live], ref[idx][live], err_msg=idx)


def _apply_tables(raw: np.ndarray, tab: dict) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy (float64 accumulation)."""
    out = np.zeros((tab["n_groups"], tab["ny"], tab["nx"]))
    for z in range(tab["nz"]):
        acc = 0.0
        for t, wt in ((tab["t0"][z], tab["wt0"][z]), (tab["t1"][z], tab["wt1"][z])):
            if wt == 0:
                continue
            rows = (tab["w00"][z, :, None] * raw[tab["s0"][z], t]
                    + tab["w01"][z, :, None] * raw[tab["s1"][z], t])
            acc = acc + float(wt) * rows
        out[z // tab["a_avg"]] += acc
    return out


@pytest.mark.parametrize("shape,keep_overhang,avg,scale", CASES)
def test_kernel_tables_reproduce_pallas(shape, keep_overhang, avg, scale):
    """The tables with the kernel's formula give the TPU kernel's output:
    the on-card kernel is then only checked for its own arithmetic."""
    rng = np.random.default_rng(11)
    raw = (rng.random(shape) * scale).astype(np.float32)
    s = _settings(keep_overhang, avg)
    ours = _apply_tables(raw.astype(np.float64), plan_tables(shape, s))
    pallas = np.asarray(
        _deskew_pallas_jit(jnp.asarray(raw), **_jax_kwargs(s), interpret=True)
    )
    np.testing.assert_allclose(ours, pallas, rtol=1e-4, atol=1e-3 * scale / 100)


def test_production_tables_weight_both_tilt_planes():
    """At 30 degrees float64 sin(30) is 0.49999999999999994, so t = z / sin
    lands an ulp past 2 z: wt1 is nonzero (<= 2.84e-14) on 127 of the 128
    output z of the production raw, and the kernel reads both tilt planes
    of those z. The tables follow JAX's _plan; a plan that snapped these
    weights to 0 would skip those planes and change what is computed."""
    tab = plan_tables((1201, 256, 1600), _settings())
    assert tab["nz"] == 128 and tab["n_groups"] == 128
    live = tab["wt1"] != 0
    assert int(live.sum()) == 127 and not live[0]
    assert 0 < float(np.abs(tab["wt1"]).max()) <= 2.9e-14
    assert (tab["wt0"] != 0).all()
    assert (tab["t1"][1:] == tab["t0"][1:] + 1).all()


# (raw shape, settings) of the kernel's layout checks: the production raw,
# BASELINE.md config 1, outputs past the old kernel's launch grid, x
# extents of 1 and 13, a scan extent shorter than a band, a ratio of 1.5,
# one tilt plane.
LAYOUT_CASES = [
    ((1201, 256, 1600), {}),
    ((300, 2048, 2048), {"keep_overhang": True, "average_n_slices": 3}),
    ((410000, 4, 8), {}),
    ((410000, 2, 8), {"keep_overhang": True}),
    ((40, 32, 1), {"keep_overhang": True}),
    ((40, 32, 13), {}),
    ((6, 32, 24), {"keep_overhang": True}),
    ((60, 16, 24), {"keep_overhang": True, "px_to_scan_ratio": 1.5}),
    ((50, 1, 24), {"keep_overhang": True}),
]


def _plan_settings(kw):
    kw = dict(kw)
    return DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=kw.pop("px_to_scan_ratio", 0.386),
                          **kw)


@pytest.mark.parametrize("shape,kw", LAYOUT_CASES)
def test_kernel_layout_fits_every_band(shape, kw):
    """The band of one z and one tile (scan rows s0 at its first row .. s1
    at its last) spans at most ``rows`` rows, and the ring fits a block;
    the clamped indices are non-decreasing in y, so s0 at the first row is
    the band's least row; t1 - t0 is 0 or 1 (the band's planes)."""
    tab = plan_tables(shape, _plan_settings(kw))
    assert (np.diff(tab["s0"], axis=1) >= 0).all() and (np.diff(tab["s1"], axis=1) >= 0).all()
    assert np.isin(tab["t1"] - tab["t0"], (0, 1)).all()
    lay = dcuda.deskew_layout(shape, tab)
    ty, tx = lay["tile"]
    assert tx == min(256, -(-shape[2] // 4) * 4) and lay["planes"] == min(shape[1], 2)
    assert -(-ty // (256 // (tx // 4))) <= 16
    ceil128 = lambda n: -(-n // 128) * 128  # noqa: E731
    assert lay["smem_bytes"] == 2 * (lay["rows"] * ceil128(4 * lay["planes"] * tx)
                                     + ceil128(16 * ty) + 128 + 8)
    assert lay["smem_bytes"] <= 232448
    spans = [int((tab["s1"][:, min(y0 + ty, tab["ny"]) - 1] - tab["s0"][:, y0]).max()) + 1
             for y0 in range(0, tab["ny"], ty)]
    assert max(spans) == lay["rows"] == dcuda.band_rows(tab, ty)
    assert lay["tiles"] == tab["n_groups"] * -(-tab["ny"] // ty) * -(-shape[2] // tx)
    if shape[0] == 410000:  # past the kernel before: 65535 blocks of 16 rows
        assert tab["ny"] > 65535 * 16


def test_kernel_layout_of_the_production_raw_and_forced_tiles():
    tab = plan_tables((1201, 256, 1600), _settings())
    lay = dcuda.deskew_layout((1201, 256, 1600), tab)
    assert lay == {"tile": (64, 256), "rows": 27, "planes": 2, "smem_bytes": 112912,
                   "tiles": 128 * 46 * 7}
    assert dcuda.deskew_layout((1201, 256, 1600), tab, tile=(16, 128))["rows"] == 8
    for tile in ((128, 256), (64, 260), (64, 6), (1024, 64), (0, 256)):
        with pytest.raises(ValueError, match="does not fit"):
            dcuda.deskew_layout((1201, 256, 1600), tab, tile=tile)
    # A ratio so large that the ring of 64-row bands outgrows a block:
    # smaller tiles.
    big = plan_tables((2000, 8, 256), _plan_settings({"px_to_scan_ratio": 6.0}))
    lay = dcuda.deskew_layout((2000, 8, 256), big)
    assert lay["tile"][0] < 64 and lay["smem_bytes"] <= 232448
    assert dcuda.deskew_smem_bytes(dcuda.band_rows(big, 64), 2, 256, 64) > 232448


def _band_kernel(raw: np.ndarray, tab: dict, layout: dict) -> np.ndarray:
    """csrc/deskew.cu's walk in numpy: per tile and z the band of rows x
    planes x tx from (s0 at the tile's first row, t0, x0), zero past raw,
    read at the band-local rows and planes, float64, each z's sum added to
    its group as :func:`_apply_tables` adds it."""
    ns, nt, nx = raw.shape
    (ty, tx), rows, planes = layout["tile"], layout["rows"], layout["planes"]
    pad = np.zeros((ns + rows, nt + 1, nx + tx))
    pad[:ns, :nt, :nx] = raw
    out = np.zeros((tab["n_groups"], tab["ny"], nx))
    for g in range(tab["n_groups"]):
        for y0 in range(0, tab["ny"], ty):
            ys = np.arange(y0, min(y0 + ty, tab["ny"]))
            for x0 in range(0, nx, tx):
                for z in range(g * tab["a_avg"], min((g + 1) * tab["a_avg"], tab["nz"])):
                    s_lo, t_lo = tab["s0"][z, y0], tab["t0"][z]
                    band = pad[s_lo:s_lo + rows, t_lo:t_lo + planes, x0:x0 + tx]
                    l0, l1 = tab["s0"][z, ys] - s_lo, tab["s1"][z, ys] - s_lo
                    assert l0.min() >= 0 and l1.max() < rows
                    u0, u1 = tab["w00"][z, ys, None], tab["w01"][z, ys, None]
                    acc = 0.0
                    for wt, p in ((tab["wt0"][z], 0), (tab["wt1"][z], tab["t1"][z] - t_lo)):
                        if wt != 0:
                            acc = acc + float(wt) * (u0 * band[l0, p] + u1 * band[l1, p])
                    out[g, ys, x0:x0 + tx] += (acc + np.zeros((len(ys), tx)))[:, :nx - x0]
    return out


@pytest.mark.parametrize("shape,kw", [c for c in LAYOUT_CASES if np.prod(c[0]) < 100_000]
                         + [((41, 27, 20), {"keep_overhang": True, "average_n_slices": 4})])
@pytest.mark.parametrize("tile", [None, (8, 8), (3, 4)])
def test_band_walk_reproduces_the_tables(shape, kw, tile):
    """The kernel's band-local reads (the band starting at s0 of the tile's
    first row, ``rows`` rows and ``planes`` planes, zero past raw) give
    exactly what the tables give read from raw directly."""
    s = _plan_settings(kw)
    tab = plan_tables(shape, s)
    raw = np.random.default_rng(5).random(shape)
    layout = dcuda.deskew_layout(shape, tab, tile=tile)
    np.testing.assert_array_equal(_band_kernel(raw, tab, layout), _apply_tables(raw, tab))


def test_cpu_tensor_runs_plain_and_kernel_wrapper_refuses_it():
    s = _settings()
    raw = torch.rand((40, 32, 24), generator=torch.Generator().manual_seed(0))
    before = deskew_cuda.launches
    out = tdeskew.deskew_volume(raw, s, device="cpu")
    assert deskew_cuda.launches == before
    torch.testing.assert_close(out, tdeskew.deskew_plain(raw, s), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        deskew_cuda(raw, s)


def test_backend_values_all_mean_the_same_function():
    raw = np.random.default_rng(2).random((40, 32, 16)).astype(np.float32)
    outs = [tdeskew.deskew_volume(raw, _settings(backend=b), device="cpu").numpy()
            for b in ("auto", "pallas", "xla")]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    bogus = _settings().model_copy(update={"backend": "mosaic"})
    with pytest.raises(ValueError, match="backend"):
        tdeskew.deskew_volume(raw, bogus, device="cpu")
