"""The yardstick's byte counts at the production shapes, against the
bounds the port's kernel table gives (PERF.md)."""

import pytest

from gpubench import geometry, inputs, spec

RAW = (1201, 256, 1600)


def _config(name):
    return spec.load_named("configs", name)


def test_deskew_geometry_and_its_bound():
    d = _config("mantis-ls-sep")["deskew"]
    assert geometry.deskewed_shape(RAW, d) == (128, 2888, 1600)
    assert geometry.deskew_rows_read(RAW, d) == 284_664
    assert geometry.bound_s(geometry.deskew_bytes(RAW, d)) * 1e3 == pytest.approx(1.250, abs=5e-4)
    whole = (RAW[0] * RAW[1] * RAW[2] + 128 * 2888 * 1600) * 4
    assert geometry.bound_s(whole) * 1e3 == pytest.approx(1.294, abs=5e-4)


def test_separable_half_step_bound():
    c = _config("mantis-ls-sep")
    psf = geometry.working_psf(inputs.make_psf(c["psf"]), c["deconvolve"]["psf_crop_tol"])
    grid = geometry.g_grid((128, 2888, 1600), psf.shape)
    assert grid == (136, 2908, 1620)
    by_bytes = geometry.bound_s(geometry.half_step_bytes(grid))
    assert by_bytes * 1e3 == pytest.approx(2.295, abs=5e-4)
    assert geometry.bound_s(geometry.half_step_bytes(grid),
                            geometry.half_step_flops(grid, psf.shape)) == by_bytes


def test_zband_bound():
    # PERF.md's bound is of the uncut PSF's grid; the step crops the tilted
    # PSF's outer y planes (psf_crop_tol), which shortens the grid's y.
    assert geometry.fft_grid((128, 2888, 1600), (15, 31, 31))[0] == (144, 3000, 1920)
    assert geometry.bound_s(geometry.zband_bytes((144, 3000, 1920), 15)) * 1e3 == pytest.approx(
        2.086, abs=5e-4)
    c = _config("mantis-ls-fft")
    psf = geometry.working_psf(inputs.make_psf(c["psf"]), c["deconvolve"]["psf_crop_tol"])
    assert psf.shape == (15, 29, 31)
    grid, pads = geometry.fft_grid((128, 2888, 1600), psf.shape)
    assert grid == (144, 2916, 1920)
    assert [lo + hi for lo, hi in pads] == [16, 28, 320]
    by_bytes = geometry.bound_s(geometry.zband_bytes(grid, 15))
    assert by_bytes * 1e3 == pytest.approx(2.028, abs=5e-4)
    assert geometry.bound_s(geometry.zband_bytes(grid, 15), geometry.zband_flops(grid, 15)) == by_bytes


def test_routes_of_the_two_configurations():
    for name, route in (("mantis-ls-sep", "separable"), ("mantis-ls-fft", "fft")):
        c = _config(name)
        psf = geometry.working_psf(inputs.make_psf(c["psf"]), c["deconvolve"]["psf_crop_tol"])
        assert geometry.rl_route(psf, c["deconvolve"]) == route
    tilted = geometry.working_psf(inputs.make_psf(_config("mantis-ls-fft")["psf"]), 1e-5)
    assert geometry.separable_residuals(tilted, 24)[-1] == pytest.approx(0.087, abs=1e-3)


@pytest.mark.parametrize("n, multiple, want", [(142, 1, 144), (2918, 1, 3000), (2916, 1, 2916), (1630, 128, 1920),
                                               (7, 1, 8), (1, 128, 128)])
def test_smooth_len(n, multiple, want):
    assert geometry.smooth_len(n, multiple) == want
