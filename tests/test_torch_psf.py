"""PyTorch port of PSF measurement against the JAX package (CPU).

``shrimpy_tpu_torch/psf.py`` against ``shrimpy_tpu/psf.py`` on bead stores
written by ``synthetic_ls_stack``: the host code is pinned statement for
statement (all but ``measure_psf``, which reads the store and deskews on
the port's device); ``measure_psf`` with the ``epi`` and ``lightsheet``
geometries gives JAX's bead count, its PSF within 1e-5 of the PSF's max
(the port's plain deskew against JAX's XLA deskew, float32 sums in
another order) and its FWHM within 1e-3 um; the measured PSF deconvolves
as JAX's ``matmul`` backend does (1e-4, as ``tests/test_torch_matmul.py``
holds RL). ``chip_smoke.py``'s bead raw is
``synthetic_ls_stack``'s.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import chip_smoke
from shrimpy_tpu import psf as jpsf
from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.config import DeconvolveSettings, DeskewSettings
from shrimpy_tpu.io.synthetic import synthetic_ls_stack
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu_torch import psf as tpsf
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.config import deskew_settings
from shrimpy_tpu_torch.ops import deconv as tdeconv
from tests.test_torch_config import _code

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PSF_RTOL, FWHM_ATOL_UM = 1e-5, 1e-3
RL_RTOL = 1e-4
# Raws large enough for the geometry's patch: epi (31, 31, 31) on the raw,
# lightsheet (31, 41, 41) on the (50, 223, 96) deskew.
RAWS = {"epi": ((80, 64, 96), 6), "lightsheet": ((120, 100, 96), 10)}


@pytest.fixture(scope="module")
def bead_stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("beads")
    out = {}
    for geometry, (shape, n) in RAWS.items():
        synthetic_ls_stack(root / f"{geometry}.zarr", raw_shape_szx=shape, n_beads=n, seed=3)
        out[geometry] = root / f"{geometry}.zarr"
    return out


def _jax_deskew(geometry, store):
    if geometry != "lightsheet":
        return None
    from shrimpy_tpu.io.ngff import open_ngff

    sz, sy, _ = open_ngff(store).position().zyx_scale
    return DeskewSettings(ls_angle_deg=30.0, pixel_size_um=sy, scan_step_um=sz)


def _port_deskew(geometry, store):
    if geometry != "lightsheet":
        return None
    from shrimpy_tpu_torch.io.ngff import open_ngff

    sz, sy, _ = open_ngff(store).position().zyx_scale
    return deskew_settings(ls_angle_deg=30.0, pixel_size_um=sy, scan_step_um=sz)


def _measured(bead_stores, tmp_path, geometry):
    store = bead_stores[geometry]
    want = jpsf.measure_psf(store, tmp_path / "jax", geometry=geometry,
                            deskew=_jax_deskew(geometry, store))
    got = tpsf.measure_psf(store, tmp_path / "port", geometry=geometry,
                           deskew=_port_deskew(geometry, store), device="cpu")
    return (want, np.load(tmp_path / "jax.npy")), (got, np.load(tmp_path / "port.npy"))


def _reports_agree(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert got["n_beads"] == want["n_beads"] >= 2
    assert got["shape"] == want["shape"] and got["peak_voxel"] == want["peak_voxel"]
    assert got["axis_labels"] == want["axis_labels"]
    np.testing.assert_allclose(got["scale_zyx_um"], want["scale_zyx_um"], rtol=1e-12)
    np.testing.assert_allclose(got["fwhm_um_zyx"], want["fwhm_um_zyx"], rtol=0,
                               atol=FWHM_ATOL_UM)


def _json_of(output: str) -> dict:
    """The verb's JSON report, after the log lines the CLI prints."""
    lines = output.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


def test_host_code_is_the_original_statement_for_statement():
    """All but ``measure_psf`` and the import of ``DeskewSettings`` (the port
    reads the settings by attribute)."""
    ours = _code(REPO / "shrimpy_tpu_torch/psf.py", ("measure_psf", "measure_volume_psf"))
    assert ours == _code(REPO / "shrimpy_tpu/psf.py", ("measure_psf",),
                         drop_imports=("shrimpy_tpu.config.schemas",))
    assert "import torch" not in (REPO / "shrimpy_tpu_torch/psf.py").read_text().split("def ")[0]


@pytest.mark.parametrize("geometry", list(RAWS))
def test_measure_psf_matches_jax(bead_stores, tmp_path, geometry):
    (want, wpsf), (got, gpsf) = _measured(bead_stores, tmp_path, geometry)
    _reports_agree(got.as_dict(), want.as_dict())
    assert gpsf.shape == wpsf.shape and gpsf.dtype == wpsf.dtype == np.float32
    assert np.abs(gpsf - wpsf).max() <= PSF_RTOL * wpsf.max()
    assert json.loads((tmp_path / "port.json").read_text()) == got.as_dict()


def test_measured_psf_deconvolves_as_jax_does(bead_stores, tmp_path):
    """The light-sheet PSF (non-separable: the tilted bead; its z radius is
    past JAX's ``fused`` block) through both packages' ``richardson_lucy``
    on ``matmul``, the backend JAX runs it on off the TPU (5 iterations,
    within 1e-4 as ``tests/test_torch_matmul.py`` holds it), JAX's planned
    terms fed to both; and on the port's ``fused``, what the card runs,
    against the zero-boundary float64 oracle within 1e-3."""
    (_, psf), _ = _measured(bead_stores, tmp_path, "lightsheet")
    s = DeconvolveSettings(algorithm="separable", separable_backend="matmul", iterations=5)
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(psf, s.psf_crop_tol))
    terms = jdeconv.plan_separable_terms(psf_w, s)
    assert terms is not None and len(terms) > 1
    img = (np.random.default_rng(4).random((12, 36, 36)) * 100).astype(np.float32)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = tdeconv.richardson_lucy(img, psf, s, terms=terms, device="cpu").numpy()
    assert np.abs(ours - ref).max() <= RL_RTOL * np.abs(ref).max()
    fused = s.model_copy(update={"separable_backend": "fused"})
    got = tdeconv.richardson_lucy(img, psf, fused, terms=terms, device="cpu").numpy()
    oracle = jdeconv.richardson_lucy_reference_separable(img, psf, iterations=5, terms=terms,
                                                         boundary="zero")
    assert np.abs(got - oracle).max() <= 1e-3 * np.abs(oracle).max()


def test_measure_volume_psf_takes_a_tensor(bead_stores, tmp_path):
    """The store-free entry on a CPU tensor gives the store path's PSF."""
    from shrimpy_tpu_torch.io.ngff import open_ngff

    store = bead_stores["lightsheet"]
    pos = open_ngff(store).position()
    raw = torch.from_numpy(pos.volume(0, 0).astype(np.float32))
    settings = _port_deskew("lightsheet", store)
    a = tpsf.measure_volume_psf(raw, pos.zyx_scale, tmp_path / "a", geometry="lightsheet",
                                deskew=settings)
    b = tpsf.measure_psf(store, tmp_path / "b", geometry="lightsheet", deskew=settings,
                         device="cpu")
    assert a.as_dict() == b.as_dict()
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))


def test_lightsheet_without_a_card_asks_for_one(bead_stores, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = bead_stores["lightsheet"]
    with pytest.raises(RuntimeError, match="is_available"):
        tpsf.measure_psf(store, tmp_path / "x", geometry="lightsheet",
                         deskew=_port_deskew("lightsheet", store))


@pytest.mark.parametrize("geometry", list(RAWS))
def test_measure_psf_verb_matches_jax_cli(bead_stores, tmp_path, geometry):
    store = str(bead_stores[geometry])
    runner = CliRunner()
    want = runner.invoke(jax_cli, ["measure-psf", store, "-o", str(tmp_path / "jax"),
                                   "--geometry", geometry])
    got = runner.invoke(cli, ["measure-psf", store, "-o", str(tmp_path / "port"),
                              "--geometry", geometry, "--device", "cpu"])
    assert want.exit_code == 0, want.output
    assert got.exit_code == 0, got.output
    _reports_agree(_json_of(got.output), _json_of(want.output))
    wpsf, gpsf = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "port.npy")
    assert np.abs(gpsf - wpsf).max() <= PSF_RTOL * wpsf.max()


def test_chip_smoke_bead_raw_is_synthetic_ls_stack_s():
    """``chip_smoke.py`` renders phase 4p's beads with torch (numpy would
    take minutes at its size): the same bead positions and raw as
    ``synthetic_ls_stack`` within float32 rounding."""
    shape, n = (60, 40, 50), 4
    raw, beads = synthetic_ls_stack(raw_shape_szx=shape, n_beads=n, seed=chip_smoke.SEED + 5)
    got, got_beads = chip_smoke.bead_raw(shape, n, device="cpu")
    np.testing.assert_array_equal(got_beads, beads)
    assert got.shape == raw.shape and got.dtype == torch.float32
    assert float((got - torch.from_numpy(raw)).abs().max()) <= 1e-5 * float(raw.max())
