"""PyTorch port of the FFT and hybrid RL against the JAX package (CPU).

The host copies (the FFT grid, the z chunk, ``auto``'s resolution, the
nonnegative CP decomposition and the hybrid's term plan, the two float64
oracles) are pinned to their originals, bit for bit. Whole RL runs take
the same numpy inputs through ``richardson_lucy`` of both packages:
relative error ``max|a-b| / max|b|`` <= 1e-5 for every ``fft_backend``
(the same update on the same grid, float32 sums in another order; JAX's
``dft*`` backends compute their transforms by matmul-DFT, the port's by
``torch.fft``), 1e-3 against the float64 oracle (BASELINE's budget) and
1e-6 for the port's float64 plain path against it. Biggs runs keep a
bf16 state, so they are held to 1e-3. The band's plain version
(what a CPU tensor runs) is held against a direct numpy loop of its two
formulas within 1e-12 in float64. The loop's four operations
(``ops/fft_cuda.py``) run their plain versions on a CPU tensor, bit for
bit the torch calls they stand for, and refuse what the card's versions
cannot take.
"""

import inspect

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy.signal import fftconvolve

import bench
from shrimpy_tpu.config import DeconvolveSettings, ReconstructSettings
from shrimpy_tpu.io.ngff import create_fov, open_ngff
from shrimpy_tpu.io.synthetic import gaussian_blob, tilted_gaussian_psf
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.parallel.pipeline import _deconv_fn as jax_deconv_fn
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops import fft_cuda
from shrimpy_tpu_torch.ops import rl_fft as trl_fft
from shrimpy_tpu_torch.ops.zband_cuda import zband, zband_cuda, zband_plain
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

FFT_BACKENDS = ["auto", "fft3", "fft2z", "dft2z", "dft3", "dftz"]
JAX_RTOL = 1e-5
ORACLE_RTOL = 1e-3
BIGGS_RTOL = 1e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _scene(shape=(16, 40, 40), seed=42):
    """tests/test_deconv.py::_dark_region_scene: two blobs, a dark octant."""
    rng = np.random.default_rng(seed)
    psf = tilted_gaussian_psf((7, 9, 9))
    truth = gaussian_blob(shape, (8.0, 18.0, 24.0), (1.0, 1.5, 1.5), amplitude=500.0)
    truth += gaussian_blob(shape, (7.0, 28.0, 12.0), (1.2, 2.0, 2.0), amplitude=300.0)
    blurred = fftconvolve(truth, psf, mode="same").astype(np.float32)
    blurred[:5, :13, :] = 0.0
    blurred = np.clip(blurred + rng.normal(0.0, 0.1, blurred.shape).astype(np.float32),
                      0.0, None)
    return psf, blurred


def _sheared_psf():
    """tests/test_deconv.py's non-separable (7, 9, 9) PSF of the dft tests."""
    zz, yy, xx = np.meshgrid(np.arange(7) - 3.0, np.arange(9) - 4.0, np.arange(9) - 4.0,
                             indexing="ij")
    psf = np.exp(-0.5 * (((zz + 0.9 * yy) / 1.2) ** 2 + ((yy + 0.8 * xx) / 1.8) ** 2
                         + (xx / 2.5) ** 2)).astype(np.float32)
    return psf / psf.sum()


def _ours(img, psf, s, **kw):
    return tdeconv.richardson_lucy(img, psf, s, device="cpu", **kw).numpy()


@pytest.mark.parametrize("image_shape,psf_shape", [
    ((128, 2888, 1600), (15, 31, 31)), ((24, 60, 72), (7, 9, 9)), ((12, 40, 44), (1, 9, 9)),
    ((20, 24), (5, 7)), ((40,), (7,)), ((5, 37, 45), (9, 3, 3)),
])
@pytest.mark.parametrize("transform", ["xla", "matmul"])
def test_padded_grid_equals_jax(image_shape, psf_shape, transform):
    assert (tdeconv._padded_grid_shape(image_shape, psf_shape, transform=transform)
            == jdeconv._padded_grid_shape(image_shape, psf_shape, transform=transform))
    assert (tdeconv._padded_grid_shape(image_shape, psf_shape, tpu_lanes=False)
            == jdeconv._padded_grid_shape(image_shape, psf_shape, tpu_lanes=False))


def test_production_grid_and_chunk():
    """The grid of bench config 6: x rounds to 1920 under the kept rule."""
    grid, _ = tdeconv._padded_grid_shape((128, 2888, 1600), (15, 31, 31))
    assert grid == (144, 3000, 1920)
    for gz in (1, 9, 20, 144, 97):
        for req in (1, 7, 8, 64, 200):
            assert tdeconv._fft2z_chunk(gz, req) == jdeconv._fft2z_chunk(gz, req)


@pytest.mark.parametrize("backend", FFT_BACKENDS)
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_resolve_fft_backend_follows_jax_off_tpu(backend, ndim):
    s = DeconvolveSettings(fft_backend=backend)
    assert tdeconv.resolve_fft_backend(s, ndim) == jdeconv.resolve_fft_backend(s, ndim)


def test_unknown_fft_backend_raises():
    from shrimpy_tpu_torch.config import deconvolve_settings

    with pytest.raises(ValueError, match="fft_backend"):
        _ours(np.ones((6, 8, 8), np.float32), _sheared_psf(),
              deconvolve_settings(algorithm="fft", fft_backend="fft2d"))


@pytest.mark.parametrize("backend", FFT_BACKENDS)
def test_fft_backend_matches_jax_and_oracle(backend):
    """Every fft_backend on the sheared PSF: against JAX's own path for
    that value, the float64 oracle on the backend's grid, and the port's
    float64 plain path against the oracle."""
    img = np.random.default_rng(5).uniform(0, 100, (12, 40, 44)).astype(np.float32)
    psf = _sheared_psf()
    s = DeconvolveSettings(algorithm="fft", fft_backend=backend, iterations=4)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = _ours(img, psf, s)
    assert ours.shape == img.shape
    assert _rel(ours, ref) <= JAX_RTOL
    oracle = tdeconv.richardson_lucy_reference(
        img, psf, 4, grid_transform="matmul" if backend.startswith("dft") else "xla")
    assert _rel(ours, oracle) <= ORACLE_RTOL
    ours64 = _ours(img, psf, s, plain=True, dtype=torch.float64)
    assert _rel(ours64, oracle) <= 1e-6


def test_fft2z_matches_fft3():
    """tests/test_deconv.py:94: the same update on the same grid, within
    2e-4 after 10 iterations."""
    psf, img = _scene()
    fft3 = _ours(img, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft3"),
                 iterations=10)
    fft2z = _ours(img, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft2z"),
                  iterations=10)
    assert _rel(fft2z, fft3) <= 2e-4


def test_fft2z_chunk_size_does_not_change_results():
    """tests/test_deconv.py:113: fft_z_chunk only sets the planes a
    transform call takes (1, a non-divisor 7, past the grid 64)."""
    psf, img = _scene()
    outs = [_ours(img, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft2z",
                                               fft_z_chunk=zc), iterations=5)
            for zc in (1, 7, 64)]
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-5, atol=1e-5)


def test_fft2z_single_plane_psf_band():
    """tests/test_deconv.py:131: kz == 1, the degenerate band."""
    vol = np.random.default_rng(3).random((6, 24, 32)).astype(np.float32) * 100 + 1.0
    psf = tdeconv.gaussian_psf((1, 9, 9), (1.0, 1.5, 1.5))
    kw = {"iterations": 5}
    fft3 = _ours(vol, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft3"), **kw)
    fft2z = _ours(vol, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft2z"), **kw)
    assert _rel(fft2z, fft3) <= 2e-4
    ref = np.asarray(jdeconv.richardson_lucy(
        vol, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft2z"), **kw))
    assert _rel(fft2z, ref) <= JAX_RTOL


@pytest.mark.parametrize("backend", ["fft3", "fft2z"])
def test_fft_biggs_matches_jax(backend):
    psf, img = _scene()
    s = DeconvolveSettings(algorithm="fft", fft_backend=backend, acceleration="biggs",
                           iterations=6)
    assert _rel(_ours(img, psf, s), np.asarray(jdeconv.richardson_lucy(img, psf, s))) \
        <= BIGGS_RTOL


def test_donate_input_fft_path_matches_and_consumes():
    """tests/test_deconv.py:52: identical result, the caller's tensor consumed."""
    psf, img = _scene()
    base = _ours(img, psf, DeconvolveSettings(algorithm="fft"), iterations=3)
    t = torch.from_numpy(img.copy())
    out = tdeconv.richardson_lucy(t, psf, DeconvolveSettings(algorithm="fft",
                                                            donate_input=True), iterations=3)
    np.testing.assert_array_equal(out.numpy(), base)
    assert t.numel() == 0


@pytest.mark.parametrize("algorithm", ["auto", "fft"])
@pytest.mark.parametrize("shape,psf_shape", [((20, 24), (5, 7)), ((40,), (7,))])
def test_1d_and_2d_images_match_jax(algorithm, shape, psf_shape):
    img = (np.random.default_rng(11).random(shape) * 50 + 1).astype(np.float32)
    grids = np.meshgrid(*(np.arange(n) - n // 2 for n in psf_shape), indexing="ij")
    psf = np.exp(-sum(g**2 for g in grids) / (2 * 1.2**2)).astype(np.float32)
    s = DeconvolveSettings(iterations=3, algorithm=algorithm)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf / psf.sum(), s))
    ours = _ours(img, psf / psf.sum(), s)
    assert ours.shape == shape and _rel(ours, ref) <= JAX_RTOL
    with pytest.raises(ValueError, match="3-D volume"):
        _ours(img, psf, s.model_copy(update={"fft_backend": "fft2z"}))


def test_non_separable_psf_under_auto_runs_fft2z_as_jax():
    psf, img = _scene()
    s = DeconvolveSettings(iterations=3, psf_denoise="off", max_extended_terms=6)
    assert tdeconv.plan_separable_terms(tdeconv.prepare_psf(psf, s), s) is None
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = _ours(img, psf, s)
    assert _rel(ours, ref) <= JAX_RTOL
    explicit = _ours(img, psf, s.model_copy(update={"algorithm": "fft",
                                                    "fft_backend": "fft2z"}))
    np.testing.assert_array_equal(ours, explicit)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_nonneg_cp_equals_jax(k):
    psf = np.asarray(tilted_gaussian_psf((7, 9, 9)), np.float64)
    psf /= psf.sum()
    ours, r_ours = tdeconv.nonneg_cp_decompose(psf, k)
    ref, r_ref = jdeconv.nonneg_cp_decompose(psf, k)
    assert r_ours == r_ref
    for t_ours, t_ref in zip(ours, ref, strict=True):
        for a, b in zip(t_ours, t_ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("psf_name,cap", [("tilted", 24), ("tilted_production", 24),
                                          ("random", 8), ("random", 10)])
def test_plan_hybrid_terms_equals_jax(psf_name, cap):
    if psf_name == "random":
        psf = np.random.RandomState(0).uniform(0.1, 1.0, (5, 7, 7))
    else:
        psf = tilted_gaussian_psf((7, 9, 9) if psf_name == "tilted" else (15, 31, 31))
    s = DeconvolveSettings(algorithm="hybrid", max_extended_terms=cap)
    ours, r_ours = tdeconv.plan_hybrid_terms(psf, s)
    ref, r_ref = jdeconv.plan_hybrid_terms(psf, s)
    assert r_ours == r_ref and len(ours) == len(ref)
    for t_ours, t_ref in zip(ours, ref):
        for a, b in zip(t_ours, t_ref):
            np.testing.assert_array_equal(a, b)


def test_oracles_equal_jax():
    psf, img = _scene((10, 30, 28))
    for transform in ("xla", "matmul"):
        np.testing.assert_array_equal(
            tdeconv.richardson_lucy_reference(img, psf, 3, grid_transform=transform),
            jdeconv.richardson_lucy_reference(img, psf, 3, grid_transform=transform))
    g = tdeconv.gaussian_psf((5, 9, 9), (1.0, 1.5, 1.5))
    for boundary in ("circular", "zero"):
        np.testing.assert_array_equal(
            tdeconv.richardson_lucy_reference_separable(img, g, 3, boundary=boundary),
            jdeconv.richardson_lucy_reference_separable(img, g, 3, boundary=boundary))


@pytest.mark.parametrize("backend", ["matmul", "linear_pallas"])
@pytest.mark.parametrize("acceleration", ["none", "biggs"])
def test_hybrid_matches_jax(backend, acceleration):
    """Hybrid with the warm phase's separable_backend named on both sides
    (JAX's ``auto`` is ``matmul`` off the TPU, the port's picks ``fused``
    by geometry; the two have different boundaries). ``linear_pallas``
    has ``fused``'s zero boundary and runs JAX's Pallas kernel in
    interpret mode at this size, where JAX's ``fused`` refuses it."""
    psf, img = _scene((12, 32, 36))
    s = DeconvolveSettings(algorithm="hybrid", hybrid_separable_iters=4, iterations=3,
                           separable_backend=backend, acceleration=acceleration)
    ref = np.asarray(jdeconv.richardson_lucy(img, psf, s))
    ours = _ours(img, psf, s)
    assert _rel(ours, ref) <= (JAX_RTOL if acceleration == "none" else BIGGS_RTOL)
    assert np.isfinite(ours).all() and (ours >= 0).all()


def test_hybrid_zero_warm_iters_equals_fft_path():
    """tests/test_deconv.py:474: hybrid_separable_iters=0 is the FFT path
    bit for bit, and JAX's too within JAX_RTOL."""
    psf, img = _scene()
    fft = _ours(img, psf, DeconvolveSettings(algorithm="fft", fft_backend="fft3"),
                iterations=3)
    s = DeconvolveSettings(algorithm="hybrid", fft_backend="fft3", hybrid_separable_iters=0)
    hyb = _ours(img, psf, s, iterations=3)
    np.testing.assert_array_equal(hyb, fft)
    assert _rel(hyb, np.asarray(jdeconv.richardson_lucy(img, psf, s, iterations=3))) \
        <= JAX_RTOL


def test_hybrid_biggs_restarts_alpha_at_the_boundary():
    """With Biggs the exact tail starts its own state: its first two
    iterations (alpha 0) are plain RL from the warm start, bit for bit."""
    psf, img = _scene()
    s = DeconvolveSettings(algorithm="hybrid", hybrid_separable_iters=5, iterations=2,
                           acceleration="biggs", separable_backend="matmul")
    hyb = _ours(img, psf, s)
    psf_w = tdeconv.prepare_psf(psf, s)
    warm_terms, _ = tdeconv.plan_hybrid_terms(psf_w, s)
    t = torch.from_numpy(img)
    warm = tdeconv.rl_separable(t, psf_w, warm_terms, s, 5)
    warm = torch.where(torch.isfinite(warm) & (warm >= 0), warm, torch.clamp_min(t, 0.0))
    tail = trl_fft.rl_fft(t, psf_w, s.model_copy(update={"acceleration": "none"}), 2,
                          init=warm).numpy()
    np.testing.assert_array_equal(hyb, tail)


def test_hybrid_biggs_beats_plain_rl20():
    """tests/test_deconv.py:526 on the port: hybrid(s=16, e=3, Biggs on
    both phases) nearer the RL-60 trajectory than plain exact RL-20."""
    psf, img = _scene()
    exact = DeconvolveSettings(algorithm="fft", fft_backend="fft3")
    ref = _ours(img, psf, exact, iterations=60).astype(np.float64)

    def dist(out):
        return float(np.linalg.norm(out.astype(np.float64) - ref) / np.linalg.norm(ref))

    d20 = dist(_ours(img, psf, exact, iterations=20))
    hb = DeconvolveSettings(algorithm="hybrid", fft_backend="fft3", hybrid_separable_iters=16,
                            acceleration="biggs")
    d_hb = dist(_ours(img, psf, hb, iterations=3))
    assert d_hb < d20 and (d20 - d_hb) / d20 > 0.15, (d_hb, d20)


def test_hybrid_output_is_finite_and_positive_on_dark_scene():
    psf, img = _scene()
    out = _ours(img, psf, DeconvolveSettings(algorithm="hybrid", hybrid_separable_iters=10),
                iterations=4)
    assert np.isfinite(out).all() and (out >= 0).all()
    assert out.max() > 1.2 * img.max()


def test_hybrid_requires_3d_psf():
    psf = np.ones((5, 5), np.float32) / 25
    with pytest.raises(ValueError, match="hybrid"):
        _ours(np.ones((32, 32), np.float32), psf, DeconvolveSettings(algorithm="hybrid"),
              iterations=2)


@pytest.mark.parametrize("deconvolve", [
    {"algorithm": "fft", "fft_backend": "fft2z"},
    {"algorithm": "hybrid", "hybrid_separable_iters": 4, "separable_backend": "matmul"},
    {"algorithm": "auto", "psf_denoise": "off", "max_extended_terms": 6},
])
def test_pipeline_deconv_stage_matches_jax(deconvolve):
    """The step's RL stage against JAX's ``_deconv_fn`` (tests/test_deconv.py:583)
    and the port's own ``richardson_lucy``."""
    psf, img = _scene((12, 32, 36))
    settings = ReconstructSettings(deconvolve={**deconvolve, "iterations": 3})
    ref = np.asarray(jax_deconv_fn(settings, psf)(img))
    out = build_reconstruct_step(settings, psf=psf, device="cpu")(img[None])[0].numpy()
    assert _rel(out, ref) <= JAX_RTOL
    direct = _ours(img, psf, settings.deconvolve)
    np.testing.assert_array_equal(out, direct)


@pytest.mark.parametrize("mode", ["conv", "corr"])
@pytest.mark.parametrize("gz,gy,gxr,kz", [(9, 33, 17, 9), (20, 37, 45, 7), (6, 5, 4, 1),
                                          (4, 3, 5, 9), (12, 8, 6, 4)])
def test_zband_plain_matches_numpy_loop(mode, gz, gy, gxr, kz):
    """The two formulas of ``csrc/zband.cu`` by a direct loop, float64;
    kz past gz wraps more than once, an even kz has no centre."""
    rng = np.random.default_rng(gz * 100 + kz)
    spec = rng.normal(size=(gz, gy, gxr)) + 1j * rng.normal(size=(gz, gy, gxr))
    taps = rng.normal(size=(kz, gy, gxr)) + 1j * rng.normal(size=(kz, gy, gxr))
    rz = kz // 2
    want = np.zeros_like(spec)
    for z in range(gz):
        for t in range(kz):
            h = taps[kz - 1 - t] if mode == "conv" else np.conj(taps[t])
            want[z] += h * spec[(z + t - rz) % gz]
    got = zband_plain(torch.from_numpy(spec), torch.from_numpy(taps), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        zband(torch.from_numpy(spec), torch.from_numpy(taps), mode).numpy(), got)


def test_zband_guards_and_cpu_dispatch():
    spec = torch.zeros((6, 4, 3), dtype=torch.complex64)
    taps = torch.zeros((3, 4, 3), dtype=torch.complex64)
    before = zband_cuda.launches
    zband(spec, taps, "conv")
    assert zband_cuda.launches == before and zband_plain.cuda_calls == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        zband_cuda(spec, taps, "conv")
    with pytest.raises(ValueError, match="mode"):
        zband_plain(spec, taps, "adjoint")
    with pytest.raises(ValueError, match="planes"):
        zband_plain(spec, taps[:, :3], "conv")


def test_fft2z_band_is_the_conv_of_fft3():
    """One fft2z half-step's spectra against the 3-D transform's: the band
    of the plane OTFs equals the 3-D OTF applied along z."""
    grid = (10, 16, 18)
    psf = _sheared_psf()
    rng = np.random.default_rng(2)
    vol = torch.from_numpy(rng.random(grid))
    taps = trl_fft.plane_otfs(psf, grid, torch.float64)
    spec = torch.fft.rfft2(vol)
    got = torch.fft.irfft2(zband_plain(spec, taps, "conv"), s=grid[1:])
    otf = torch.fft.rfftn(trl_fft.embed_psf(psf, grid, torch.float64))
    want = torch.fft.irfftn(torch.fft.rfftn(vol) * otf, s=grid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    got = torch.fft.irfft2(zband_plain(spec, taps, "corr"), s=grid[1:])
    want = torch.fft.irfftn(torch.fft.rfftn(vol) * otf.conj(), s=grid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("algorithm", ["fft", "hybrid"])
def test_cli_deconvolve_fft_and_hybrid_on_cpu(tmp_path, algorithm):
    psf, img = _scene((10, 28, 30))
    np.save(tmp_path / "psf.npy", psf)
    pos = create_fov(tmp_path / "in.zarr", shape=(1, 1, *img.shape), dtype="float32",
                     channel_names=["GFP"], zyx_scale=(0.25, 0.116, 0.116))
    pos.write((0, 0), img)
    result = CliRunner().invoke(cli, [
        "deconvolve", str(tmp_path / "in.zarr"), "-o", str(tmp_path / "out.zarr"),
        "--psf", str(tmp_path / "psf.npy"), "--iterations", "3", "--algorithm", algorithm,
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    got = open_ngff(tmp_path / "out.zarr").position().volume(0, 0)
    s = DeconvolveSettings(algorithm=algorithm, iterations=3)
    want = _ours(img, psf, s)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-5)


def _bench_settings(fn):
    """The ``DeconvolveSettings(...)`` call of a bench config, evaluated."""
    src = inspect.getsource(fn)
    start = src.index("settings = DeconvolveSettings(") + len("settings = ")
    depth, i = 0, start
    while True:
        depth += {"(": 1, ")": -1}.get(src[i], 0)
        i += 1
        if depth == 0 and src[i - 1] == ")":
            break
    return eval(src[start:i], {"DeconvolveSettings": DeconvolveSettings,  # noqa: S307
                               "RL_ITERS": bench.RL_ITERS})


def test_chip_smoke_fft_settings_equal_bench_nonsep():
    """chip_smoke.py's FFT phases run bench.py configs 6, 8 and 9:
    the settings of ``_config_nonsep*`` in every field the port reads,
    the same PSF (the port's ``io/synthetic.py::tilted_gaussian_psf``) and
    the same volume shape."""
    import importlib.util
    from pathlib import Path

    from shrimpy_tpu_torch import config as tconfig

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, fn in (("config6", bench._config_nonsep), ("config8", bench._config_nonsep_hybrid),
                     ("config9", bench._config_nonsep_hybrid_accel)):
        ref = _bench_settings(fn)
        ns = smoke.nonsep_settings(name)
        for field in tconfig.DECONVOLVE_DEFAULTS:
            assert getattr(ns, field) == getattr(ref, field), (name, field)
        assert "tilted_gaussian_psf()" in inspect.getsource(fn)
        assert '"128,2888,1600"' in inspect.getsource(fn)
    assert smoke.NONSEP_SHAPE == (128, 2888, 1600)
    from shrimpy_tpu_torch.io import synthetic as tsynthetic

    assert "tilted_gaussian_psf()" in inspect.getsource(smoke.run_phases)
    np.testing.assert_array_equal(tsynthetic.tilted_gaussian_psf(), tilted_gaussian_psf())


def _fft_args(op, dtype=torch.float32, shape=(3, 10, 9)):
    """Fresh arguments of one of fft_cuda's four operations on the CPU."""
    g = torch.Generator().manual_seed(7)
    real = torch.rand(shape, generator=g, dtype=dtype) * 2.0
    n, gy, gx = shape
    spec = torch.fft.rfft2(torch.rand(shape, generator=g, dtype=dtype))
    other = torch.rand(shape, generator=g, dtype=dtype) * 100.0
    return {"r2c": (real, torch.empty_like(spec)),
            "c2r_": (spec, torch.empty_like(real)),
            "ratio_": (real, other, 1e-3),
            "scale_": (real, other)}[op]


def _torch_call(op, args):
    """What each operation stands for, written as the loop wrote it before."""
    a, b, *rest = (t.clone() if isinstance(t, torch.Tensor) else t for t in args)
    if op == "r2c":
        return torch.fft.rfft2(a)
    if op == "c2r_":
        return torch.fft.irfft2(a, s=tuple(b.shape[1:]), norm="forward")
    if op == "ratio_":
        return torch.div(b, a.clamp_min_(rest[0]))
    return a.mul_(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["r2c", "c2r_", "ratio_", "scale_"])
def test_fft_wrappers_run_the_plain_versions_on_the_cpu(op, dtype):
    """Each wrapper takes a CPU tensor to its plain version: the torch call
    it stands for, bit for bit, written into the caller's buffer; no
    launch is counted, nor a plain call on a CUDA tensor."""
    args = _fft_args(op, dtype)
    want = _torch_call(op, args)
    cuda_fn = getattr(fft_cuda, op.rstrip("_") + "_cuda")
    plain_fn = getattr(fft_cuda, op.rstrip("_") + "_plain")
    launches, calls = cuda_fn.launches, plain_fn.cuda_calls
    got = getattr(fft_cuda, op)(*args)
    assert got.data_ptr() == (args[1] if op in ("r2c", "c2r_") else args[0]).data_ptr()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(plain_fn(*_fft_args(op, dtype)).numpy(), want.numpy())
    assert cuda_fn.launches == launches == 0 and plain_fn.cuda_calls == calls == 0
    assert fft_cuda.WRAPPERS[fft_cuda.PLAIN.index(plain_fn)] is getattr(fft_cuda, op)


def _views(op):
    """(label, args, message) of inputs each operation must refuse."""
    args = _fft_args(op)
    a, b = args[0], args[1]
    rest = args[2:]
    half = (a, b.half()) if op == "c2r_" else (a.half(), b, *rest)
    bad = [("float16", half, "float32|float64"),
           ("not contiguous", (a.transpose(1, 2), b, *rest), "contiguous|shape|spectrum")]
    if op in ("r2c", "c2r_"):
        # The real array laid over the spectrum's own bytes.
        spec, real = (b, a) if op == "r2c" else (a, b)
        over = torch.view_as_real(spec).reshape(-1)[:real.numel()].view(real.shape)
        bad.append(("overlapping", (over, spec) if op == "r2c" else (spec, over), "overlap"))
        bad.append(("complex128 for float32", (a, b.to(torch.complex128)) if op == "r2c"
                    else (a.to(torch.complex128), b), "complex64"))
        bad.append(("wrong planes", (a, b[:2]) if op == "r2c" else (a[:2], b), "spectrum"))
    else:
        bad.append(("overlapping", (a, a.view(a.shape), *rest), "overlap"))
        bad.append(("float64 beside float32", (a, b.double(), *rest), "both"))
        bad.append(("shape", (a, b[:2].contiguous(), *rest), "shape"))
    return bad


@pytest.mark.parametrize("op", ["r2c", "c2r_", "ratio_", "scale_"])
def test_fft_wrappers_refuse_bad_input(op):
    """The wrapper, its plain version and its card version refuse the same
    inputs (wrong dtype, not contiguous, the output overlapping the input,
    a spectrum of another shape) before any work; the card's version also
    refuses a CPU tensor."""
    stem = op.rstrip("_")
    for fn in (getattr(fft_cuda, op), getattr(fft_cuda, stem + "_plain"),
               getattr(fft_cuda, stem + "_cuda")):
        for label, args, msg in _views(op):
            with pytest.raises(ValueError, match=msg):
                fn(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(fft_cuda, stem + "_cuda")(*_fft_args(op))


def test_fft_kernels_are_filed_as_elementwise_by_the_trace():
    """Every ``__global__`` kernel of ``csrc/rl_fft.cu`` is filed as
    ``elementwise`` by the benchmark's trace reader, as the torch kernels it
    replaces were, under any name the profiler may show; cuFFT's own
    kernels stay ``transforms``."""
    import re
    from pathlib import Path

    from gpubench import trace

    src = (Path(fft_cuda.__file__).resolve().parent.parent / "csrc" / "rl_fft.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", src)
    assert sorted(names) == ["rl_ratio_kernel", "rl_scale_kernel"]
    for name in names:
        for shown in (name, f"void (anonymous namespace)::{name}<float>(float*, float const*, "
                            "long long, int)", f"{name}<double>"):
            assert trace.kind(shown) == "elementwise", shown
    assert trace.kind("void regular_fft_c2r_1920u<EPT_10u>(...)") == "transforms"


@pytest.mark.parametrize("z_chunk", [4, 5, 16])
@pytest.mark.parametrize("accel", ["none", "biggs"])
def test_fft2z_loop_goes_through_the_wrappers(monkeypatch, z_chunk, accel):
    """``rl_fft2z`` calls the four operations once per chunk and half-step
    (r2c and c2r_ twice a chunk an iteration, ratio_ and scale_ once),
    the wrappers unless ``plain``, the plain versions with it, and on the
    CPU both give the same bits."""
    psf, img = _scene((12, 32, 36))
    s = DeconvolveSettings(algorithm="fft", fft_backend="fft2z", acceleration=accel)
    grid, pads = tdeconv._padded_grid_shape(img.shape, psf.shape)
    chunks = -(-grid[0] // z_chunk)
    outs = {}
    for plain in (False, True):
        calls = []

        def counted(fn):
            def wrapped(*args):
                calls.append(fn.__name__)
                return fn(*args)
            return wrapped

        name = "PLAIN" if plain else "WRAPPERS"
        monkeypatch.setattr(fft_cuda, name, tuple(counted(f) for f in getattr(fft_cuda, name)))
        outs[plain] = trl_fft.rl_fft2z(torch.from_numpy(img), psf, s, 3, grid=grid, pads=pads,
                                       z_chunk=z_chunk, plain=plain).numpy()
        want = ["r2c", "c2r_", "ratio_", "scale_"]
        if plain:
            want = [w.rstrip("_") + "_plain" for w in want]
        assert {w: calls.count(w) for w in want} == dict(zip(want, [6 * chunks, 6 * chunks,
                                                                    3 * chunks, 3 * chunks]))
    np.testing.assert_array_equal(outs[False], outs[True])
