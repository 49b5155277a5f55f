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
