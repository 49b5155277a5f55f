"""The measured PSF's cell (``ls-meas.rl20``): the frozen ``npy`` PSF,
the separable tiers the harness works out again against the program's
plan, the reference's operator on those tiers against the program's
plain float64 path, and a tiny cell run through ``cell.run`` (the test
calls the program; the harness's reference never does)."""

import hashlib
import json

import numpy as np
import pytest
import torch

from gpubench import cell, control, geometry, inputs, reference, spec
from shrimpy_tpu_torch.ops import deconv as port

MEAS = spec.load_named("configs", "mantis-ls-meas")
MID_CROP = (11, 15, 15)  # the measured PSF's centre: K = 24 on the truncated tier


def centre_crop(psf: np.ndarray, shape) -> np.ndarray:
    """The ``shape`` block of ``psf`` around its centre voxel."""
    return np.ascontiguousarray(psf[tuple(slice(n // 2 - k // 2, n // 2 + k // 2 + 1)
                                          for n, k in zip(psf.shape, shape))])


def save_npy(root, name: str, psf: np.ndarray) -> dict:
    """``psf`` written as ``root/psfs/<name>.npy``; returns the ``npy``
    PSF entry that names it."""
    path = root / "psfs" / f"{name}.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, psf.astype(np.float32))
    return {"kind": "npy", "path": f"psfs/{name}.npy",
            "sha256": hashlib.sha256(path.read_bytes()).hexdigest()}


def _settings(config):
    return cell.port_settings(config).deconvolve


def test_committed_psf_matches_its_hash_and_plan():
    psf = inputs.make_psf(MEAS["psf"])
    assert psf.shape == (31, 41, 41) and psf.dtype == np.float32
    work = geometry.working_psf(psf, MEAS["deconvolve"]["psf_crop_tol"])
    assert work.shape == (31, 41, 37)
    tier, terms, residual = geometry.separable_terms(work, MEAS["deconvolve"])
    assert (tier, len(terms)) == ("truncated", 24)
    assert residual == pytest.approx(3.716e-3, abs=1e-6)
    assert geometry.g_grid((128, 2888, 1600), work.shape) == (158, 2928, 1636)


def test_npy_kind_refuses_a_bad_hash_and_a_path_outside(tmp_path):
    root = tmp_path / "gpubench"
    entry = save_npy(root, "p", np.ones((3, 3, 3), np.float32))
    assert inputs.make_psf(entry, root).sum() == 27
    with pytest.raises(ValueError, match="sha256"):
        inputs.make_psf({**entry, "sha256": "0" * 64}, root)
    np.save(tmp_path / "outside.npy", np.ones((3, 3, 3), np.float32))
    for path in ("../outside.npy", str(tmp_path / "outside.npy")):
        with pytest.raises(ValueError, match="not inside"):
            inputs.make_psf({**entry, "path": path}, root)
    with pytest.raises(ValueError, match="unknown PSF"):
        inputs.make_psf({"kind": "tiff"}, root)


def _port_tier(psf_unit, s):
    """The program's tier, terms and residual for a working PSF
    (``plan_separable_terms``' branches, replayed)."""
    unit = psf_unit / psf_unit.sum()
    strict = port.separable_decompose(unit, s.separable_tol, s.max_separable_terms)
    extended = max(s.max_extended_terms, s.max_separable_terms)
    ext = (port.separable_decompose(unit, s.separable_tol, extended)
           if strict is None and extended > s.max_separable_terms else None)
    terms = port.plan_separable_terms(psf_unit, s)
    tier = ("fft" if terms is None else "separable" if strict is not None
            else "extended" if ext is not None else "truncated")
    residual = 1.0
    if terms:
        approx = geometry.terms_psf(terms)
        residual = float(np.linalg.norm(unit - approx) / np.linalg.norm(unit))
    return tier, terms, residual


def _seeded_psfs():
    rng = np.random.default_rng(12)
    axes = lambda: [np.abs(rng.normal(size=n)) + 0.1 for n in (7, 9, 11)]
    rank1 = np.einsum("z,y,x->zyx", *axes())
    rank3 = sum(np.einsum("z,y,x->zyx", *axes()) * w for w in (1.0, 0.3, 0.05))
    noisy = rank3 + 2e-3 * rank3.max() * rng.normal(size=rank3.shape)
    tilted = spec.load_named("configs", "mantis-ls-fft")["psf"]
    measured = inputs.make_psf(MEAS["psf"])
    return {"rank1": rank1, "rank3": rank3, "noisy": noisy,
            "tilted": inputs.make_psf(tilted),
            "measured_small": centre_crop(measured, (7, 9, 9)),
            "measured_mid": centre_crop(measured, MID_CROP),
            "measured": measured}


@pytest.mark.parametrize("name", sorted(_seeded_psfs()))
def test_tiers_match_the_programs_plan(name):
    psf = _seeded_psfs()[name].astype(np.float32)
    d = MEAS["deconvolve"]
    s = _settings(MEAS)
    work = geometry.working_psf(psf, d["psf_crop_tol"])
    port_work = port.prepare_psf(psf, s)
    assert work.shape == port_work.shape
    tier, terms, residual = geometry.separable_terms(work, d)
    want_tier, want_terms, want_residual = _port_tier(port_work.astype(np.float64), s)
    assert (tier, len(terms)) == (want_tier, len(want_terms or []))
    assert geometry.rl_route(work, d) == tier
    if terms:  # the same residual and operator, to the program's float32 taps
        assert residual == pytest.approx(want_residual, rel=1e-4, abs=1e-7)
        a, b = geometry.terms_psf(terms), geometry.terms_psf(want_terms)
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()


def test_separable_algorithm_raises_where_no_tier_takes_the_psf():
    tilted = inputs.make_psf(spec.load_named("configs", "mantis-ls-fft")["psf"])
    d = {**MEAS["deconvolve"], "algorithm": "separable"}
    with pytest.raises(ValueError, match="no separable tier"):
        geometry.rl_route(geometry.working_psf(tilted, 1e-5), d)


def _raw(shape=(64, 16, 24), seed=3):
    params = spec.load_named("traffic", "ring4-closed")["raw"] | {"structures": 40}
    return inputs.camera_raw(shape, params, seed, "cpu")


@pytest.mark.parametrize("crop, tier", [((7, 9, 9), "extended"), (MID_CROP, "truncated")])
def test_reference_runs_the_programs_operator(crop, tier):
    """On the program's own terms the reference's RL (FFTs of the terms'
    sum on a grid nothing wraps on) and the program's plain float64 RL
    (three passes a term, zero boundary) are one operator."""
    psf = centre_crop(inputs.make_psf(MEAS["psf"]), crop)
    d = {**MEAS["deconvolve"], "iterations": 4}
    s = _settings({**MEAS, "deconvolve": d})
    work = port.prepare_psf(psf, s)
    terms = port.plan_separable_terms(work, s)
    assert geometry.rl_route(geometry.working_psf(psf, d["psf_crop_tol"]), d) == tier
    vol = reference.deskew(_raw(), MEAS["deskew"])
    got = port.rl_separable(vol, work, terms, s, 4, plain=True, dtype=torch.float64)
    ref = reference._rl_separable(vol, geometry.terms_psf(terms), d, None)
    assert reference.max_rel_err(got, ref) < 1e-10
    # ... and the reference's own terms give that operator to float32 taps.
    own = reference.richardson_lucy(vol, psf, d)
    assert reference.max_rel_err(got, own) < 1e-6


@pytest.mark.parametrize("name, route", [("mantis-ls-sep", "separable"), ("mantis-ls-fft", "fft")])
def test_existing_configurations_keep_their_path(monkeypatch, name, route):
    """The two cells before the measured one: the same route, and the
    reference's same function on the whole working PSF."""
    c = spec.load_named("configs", name)
    psf = inputs.make_psf(c["psf"])
    work = geometry.working_psf(psf, c["deconvolve"]["psf_crop_tol"])
    assert geometry.rl_route(work, c["deconvolve"]) == route
    seen = []
    for fn in ("_rl_separable", "_rl_fft"):
        monkeypatch.setattr(reference, fn, lambda image, p, d, store, fn=fn: seen.append((fn, p)))
    reference.richardson_lucy(torch.zeros(4, 8, 8, dtype=torch.float64), psf, c["deconvolve"])
    assert [f for f, _ in seen] == ["_rl_" + route] and np.array_equal(seen[0][1], work)


def test_rl_roofline_meas_bound():
    work = geometry.working_psf(inputs.make_psf(MEAS["psf"]), MEAS["deconvolve"]["psf_crop_tol"])
    grid = geometry.g_grid((128, 2888, 1600), work.shape)
    assert geometry.bound_s(geometry.half_step_bytes(grid)) * 1e3 == pytest.approx(2.711, abs=5e-4)


def test_tiny_measured_cell_is_correct(run_tiny):
    rc, lines, _, result = run_tiny("tiny-meas.rl3", 2**33 + 7, traced=True)
    assert rc == 0 and result["correct"] is True
    assert json.loads(lines[-2].split(": ", 1)[1])["plain_calls_on_cuda"] == {}
    metrics = result["metrics"]  # off the card the trace readers find nothing to read
    assert "rl_roofline.sep" not in metrics and "zband_roofline" not in metrics


@pytest.mark.parametrize("fault", control.OPERATOR_FAULTS)
def test_wrong_operator_is_not_correct(run_tiny, fault):
    rc, _, _, result = run_tiny("tiny-meas.rl3", 2**33 + 8, seconds=0.2,
                                make_step=control.FAULTS[fault])
    assert rc == 0 and result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("fault", control.OPERATOR_FAULTS)
def test_wrong_operator_faults_refuse_other_routes(fault):
    c = spec.load_named("configs", "mantis-ls-fft")
    with pytest.raises(ValueError):
        control.FAULTS[fault](c, inputs.make_psf(c["psf"]), "cpu")


def _meas_ctx():
    """A context of the measured cell at its own shapes, with a traced
    volume of the three-pass route's kernels (the names the card's
    trace gives them) and a deskew."""
    from gpubench.trace import Trace

    t = Trace(start_us=0.0, end_us=8200e3)
    t.device = [("void (anonymous namespace)::deskew_kernel<true>(float const*)", 0.0, 1.7e3),
                ("void (anonymous namespace)::axis_pass_kernel<false, false>(float const*)",
                 2e3, 5300e3),
                ("void (anonymous namespace)::x_pass_kernel<false, false>(float const*)",
                 5300e3, 8150e3)]
    return cell.Context("ls-meas.rl20", MEAS, {}, inputs.make_psf(MEAS["psf"]), (1201, 256, 1600),
                        (128, 2888, 1600), 30.0, volumes=[None], trace=t)


def test_readers_on_the_three_pass_route():
    """The three passes are separable work to ``trace.kind``; the
    separable and the FFT rooflines find nothing to read on this route,
    and ``rl_roofline.meas`` holds the work to the same bound as the
    separable one."""
    ctx = _meas_ctx()
    assert {cell.trace.kind(name) for name, _, _ in ctx.trace.device} == {"deskew", "separable"}
    assert spec.load_reader("rl_roofline.sep")(ctx) is None
    assert spec.load_reader("zband_roofline")(ctx) is None
    got = spec.load_reader("rl_roofline.meas")(ctx)
    assert got == pytest.approx(100 * 40 * 2.7111e-3 / (8150e3 - 2e3) * 1e6, rel=1e-4)
    sep = spec.load_named("configs", "mantis-ls-sep")
    other = cell.Context("ls-sep.rl20", sep, {}, inputs.make_psf(sep["psf"]), (1201, 256, 1600),
                         (128, 2888, 1600), 10.0, volumes=[None], trace=ctx.trace)
    assert spec.load_reader("rl_roofline.meas")(other) is None
