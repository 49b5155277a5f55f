"""PyTorch port: the reconstruct step, the store runtime, the CLI and the
guards of the compute path (CPU).

The slice as a whole — deskew then separable RL through
``build_reconstruct_step`` — is held against JAX ``reconstruct_batch``
with the Pallas deskew and the fused RL backend (interpret mode) at
relative error 1e-4; the store/CLI layer against the port's own
``reconstruct_batch`` (same arithmetic: exact to 1e-6 relative).
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

import bench
from shrimpy_tpu.config import (
    DeconvolveSettings,
    DeskewSettings,
    PhaseSettings,
    ReconstructSettings,
    RegistrationSettings,
)
from shrimpy_tpu.config.schemas import IORetrySettings, inject_derived_parameters
from shrimpy_tpu.io.ngff import create_fov, open_ngff
from shrimpy_tpu.io.synthetic import coordinate_encoded_plate, synthetic_ls_stack
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.ops.deskew import get_deskewed_shape
from shrimpy_tpu.ops.rl_fused import rl_fused_supported
from shrimpy_tpu.parallel.pipeline import reconstruct_batch as jax_reconstruct_batch
from shrimpy_tpu.runtime import stream as jstream
from shrimpy_tpu.utils.retry import robust_call as jax_robust_call
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.kernels import build
from shrimpy_tpu_torch.ops.deconv import gaussian_psf, richardson_lucy
from shrimpy_tpu_torch.ops.deskew import deskew_volume
from shrimpy_tpu_torch.parallel.pipeline import (
    build_reconstruct_step,
    output_shape,
    reconstruct_batch,
)
from shrimpy_tpu_torch.runtime import stream as tstream
from shrimpy_tpu_torch.runtime.feed import DeviceFeed
from shrimpy_tpu_torch.utils.retry import robust_call
from shrimpy_tpu_torch.utils.timing import StageTimer

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _slice_settings(iterations=2):
    return ReconstructSettings(
        deskew=DeskewSettings(px_to_scan_ratio=0.386, backend="pallas"),
        deconvolve=DeconvolveSettings(separable_backend="fused", iterations=iterations),
    )


def test_reconstruct_batch_matches_jax_slice():
    """deskew (Pallas, interpret) -> fused RL (interpret) in JAX against
    the port's step; the deskewed volume fits the fused kernel's layout."""
    raw_shape = (117, 24, 650)
    settings = _slice_settings()
    psf = gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))
    deskewed, _ = get_deskewed_shape(raw_shape, settings.deskew)
    assert rl_fused_supported(deskewed, psf.shape)
    raw = (np.random.default_rng(0).random((1, *raw_shape)) * 100).astype(np.float32)
    ref = np.asarray(jax_reconstruct_batch(jnp.asarray(raw), settings, psf=psf))
    ours = reconstruct_batch(raw, settings, psf=psf, device="cpu")
    assert tuple(ours.shape) == ref.shape == (1, *output_shape(raw_shape, settings))
    err = np.abs(ours.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, f"rel err {err:.2e}"
    # JAX's planned terms fed to the port give the same result.
    terms = jdeconv.plan_separable_terms(psf, settings.deconvolve)
    again = reconstruct_batch(raw, settings, psf=psf, terms=terms, device="cpu")
    torch.testing.assert_close(again, ours, rtol=0, atol=0)


def test_step_runs_volumes_of_a_batch_independently():
    settings = tconfig.reconstruct_settings(
        deskew=tconfig.deskew_settings(px_to_scan_ratio=0.386),
        deconvolve=tconfig.deconvolve_settings(iterations=2),
    )
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    raw = np.random.default_rng(1).random((3, 40, 24, 20)).astype(np.float32)
    step = build_reconstruct_step(settings, psf=psf, device="cpu")
    out = step(raw)
    assert out.shape == (3, *output_shape((40, 24, 20), settings))
    for b in range(3):
        one = step(raw[b : b + 1])[0]
        torch.testing.assert_close(out[b], one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="B, S, T, X"):
        step(raw[0])


def _demo_settings(store):
    from shrimpy_tpu.config.schemas import load_yaml_config

    settings = load_yaml_config(REPO / "configs/reconstruct_demo.yml", ReconstructSettings)
    sz, sy, _ = open_ngff(store).position().zyx_scale
    inject_derived_parameters(settings, pixel_size_um=sy, z_step_um=sz)
    return settings, sy


def test_cli_reconstruct_demo_config_on_cpu(tmp_path):
    """``shrimpy-tpu-torch reconstruct -c configs/reconstruct_demo.yml
    --device cpu`` on a synthetic store: read back, equal to the port's
    reconstruct_batch, with the deskew voxel scale."""
    raw, _ = synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 32))
    out = tmp_path / "out.zarr"
    result = CliRunner().invoke(cli, [
        "reconstruct", str(tmp_path / "ls.zarr"), "-o", str(out),
        "-c", str(REPO / "configs/reconstruct_demo.yml"), "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output
    pos = open_ngff(out).position()
    got = np.asarray(pos.volume(0, 0))
    settings, px = _demo_settings(tmp_path / "ls.zarr")
    want = reconstruct_batch(raw[None], settings, psf=tstream._load_psf(settings), device="cpu")[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    n = settings.deskew.average_n_slices
    np.testing.assert_allclose(pos.zyx_scale, (n * px, px, px), rtol=1e-9)
    summary = json.loads((out / "reconstruct_summary.json").read_text())
    assert summary["device"] == "cpu" and summary["volumes"] == 1
    assert summary["device_memory_gib"] == {}  # no CUDA here: no gauges


def test_cli_reconstruct_biggs_linear_pallas_on_cpu(tmp_path):
    """A YAML that sets ``acceleration: biggs`` and ``separable_backend:
    linear_pallas`` runs through ``shrimpy-tpu-torch reconstruct``: read
    back, equal to the port's reconstruct_batch with those settings."""
    raw, _ = synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 32))
    cfg = tmp_path / "biggs_linear.yml"
    cfg.write_text(textwrap.dedent("""
        deskew:
          ls_angle_deg: 30.0
        deconvolve:
          iterations: 4
          acceleration: biggs
          separable_backend: linear_pallas
    """))
    out = tmp_path / "out.zarr"
    result = CliRunner().invoke(cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o", str(out),
                                      "-c", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    got = np.asarray(open_ngff(out).position().volume(0, 0))
    from shrimpy_tpu.config.schemas import load_yaml_config

    settings = load_yaml_config(cfg, ReconstructSettings)
    sz, sy, _ = open_ngff(tmp_path / "ls.zarr").position().zyx_scale
    inject_derived_parameters(settings, pixel_size_um=sy, z_step_um=sz)
    assert settings.deconvolve.acceleration == "biggs"
    want = reconstruct_batch(raw[None], settings, psf=tstream._load_psf(settings), device="cpu")[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    plain = settings.model_copy(deep=True)
    plain.deconvolve.acceleration = "none"
    assert not np.array_equal(
        got, reconstruct_batch(raw[None], plain, psf=tstream._load_psf(plain), device="cpu")[0].numpy())


@pytest.mark.parametrize("backend", ["zy_pallas", "matmul"])
def test_cli_reconstruct_circular_backends_on_cpu(tmp_path, backend):
    """A YAML that sets ``separable_backend: zy_pallas`` or ``matmul``
    runs through ``shrimpy-tpu-torch reconstruct``: read back, equal to
    the port's reconstruct_batch with those settings, within 1e-4 of
    JAX's reconstruct_batch on the same backend (Pallas deskew and
    zy_pallas in interpret mode)."""
    raw, _ = synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 32))
    cfg = tmp_path / f"{backend}.yml"
    cfg.write_text(textwrap.dedent(f"""
        deskew:
          ls_angle_deg: 30.0
          backend: pallas
        deconvolve:
          iterations: 3
          separable_backend: {backend}
    """))
    out = tmp_path / "out.zarr"
    result = CliRunner().invoke(cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o", str(out),
                                      "-c", str(cfg), "--device", "cpu"])
    assert result.exit_code == 0, result.output
    got = np.asarray(open_ngff(out).position().volume(0, 0))
    from shrimpy_tpu.config.schemas import load_yaml_config

    settings = load_yaml_config(cfg, ReconstructSettings)
    sz, sy, _ = open_ngff(tmp_path / "ls.zarr").position().zyx_scale
    inject_derived_parameters(settings, pixel_size_um=sy, z_step_um=sz)
    assert settings.deconvolve.separable_backend == backend
    psf = tstream._load_psf(settings)
    want = reconstruct_batch(raw[None], settings, psf=psf, device="cpu")[0].numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    ref = np.asarray(jax_reconstruct_batch(jnp.asarray(raw[None]), settings, psf=psf))[0]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_cli_deskew_and_deconvolve_verbs(tmp_path):
    raw, _ = synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 16))
    runner = CliRunner()
    out = tmp_path / "d.zarr"
    result = runner.invoke(cli, [
        "deskew", str(tmp_path / "ls.zarr"), "-o", str(out),
        "--average-n-slices", "3", "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output
    settings, px = _demo_settings(tmp_path / "ls.zarr")
    desk = settings.deskew.model_copy(update={"average_n_slices": 3})
    pos = open_ngff(out).position()
    np.testing.assert_array_equal(np.asarray(pos.volume(0, 0)),
                                  deskew_volume(raw, desk, device="cpu").numpy())
    np.testing.assert_allclose(pos.zyx_scale, (3 * px, px, px), rtol=1e-9)

    vol = np.random.default_rng(2).random((10, 20, 18)).astype(np.float32) * 50
    create_fov(tmp_path / "v.zarr", shape=(1, 1, *vol.shape), dtype="float32").write(
        (0, 0), vol
    )
    result = runner.invoke(cli, [
        "deconvolve", str(tmp_path / "v.zarr"), "-o", str(tmp_path / "r.zarr"),
        "--iterations", "2", "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output
    want = richardson_lucy(vol, gaussian_psf((9, 15, 15), (1.5, 2.5, 2.5)),
                           DeconvolveSettings(iterations=2), device="cpu").numpy()
    np.testing.assert_array_equal(
        np.asarray(open_ngff(tmp_path / "r.zarr").position().volume(0, 0)), want
    )
    result = runner.invoke(cli, [
        "deconvolve", str(tmp_path / "v.zarr"), "-o", str(tmp_path / "f.zarr"),
        "--iterations", "2", "--algorithm", "fft", "--device", "cpu",
    ])
    assert result.exit_code == 0, result.output
    want = richardson_lucy(vol, gaussian_psf((9, 15, 15), (1.5, 2.5, 2.5)),
                           DeconvolveSettings(iterations=2, algorithm="fft"),
                           device="cpu").numpy()
    np.testing.assert_array_equal(
        np.asarray(open_ngff(tmp_path / "f.zarr").position().volume(0, 0)), want
    )


def test_reconstruct_store_plate_selection_and_resume(tmp_path):
    coordinate_encoded_plate(tmp_path / "p.zarr", shape_tczyx=(2, 2, 4, 16, 16))
    settings = ReconstructSettings(
        deconvolve=DeconvolveSettings(iterations=1), channels=["ch1"],
        output_dtype="uint16",
    )
    first = tstream.reconstruct_store(tmp_path / "p.zarr", tmp_path / "o.zarr", settings,
                                      device="cpu", batch_size=3, terms=None)
    assert first["volumes"] == 4 and first["skipped_resume"] == 0
    again = tstream.reconstruct_store(tmp_path / "p.zarr", tmp_path / "o.zarr", settings,
                                      device="cpu", resume=True)
    assert again["volumes"] == 0 and again["skipped_resume"] == 4
    out = open_ngff(tmp_path / "o.zarr")
    assert set(out.positions()) == set(open_ngff(tmp_path / "p.zarr").positions())
    pos = out.positions()["0/1/001"]
    assert pos.dtype == np.uint16
    assert np.asarray(pos.volume(1, 1)).max() > 0
    assert np.asarray(pos.volume(1, 0)).max() == 0  # ch0 not selected


def test_stream_copies_equal_originals(tmp_path):
    coordinate_encoded_plate(tmp_path / "p.zarr", shape_tczyx=(3, 2, 2, 8, 8))
    store = open_ngff(tmp_path / "p.zarr")
    for sel in ({}, {"channels": ["ch1"]}, {"time_indices": [0, 2], "positions": ["0/0/000"]}):
        s = ReconstructSettings(**sel)
        assert [i.key for i in tstream.plan_work(store, s)] == [
            i.key for i in jstream.plan_work(store, s)
        ]
    batch = np.array([[np.nan, -3.0, 7.5, 1e6, np.inf]], np.float32)
    for dtype in ("float32", "uint16"):
        np.testing.assert_array_equal(tstream._as_output_dtype(batch, dtype),
                                      jstream._as_output_dtype(batch, dtype))
    for mod in (tstream, jstream):
        s = ReconstructSettings(deconvolve=DeconvolveSettings())
        np.testing.assert_array_equal(tstream._load_psf(s), jstream._load_psf(s))
        journal = tmp_path / f"{mod.__name__}.jsonl"
        prog = mod._Progress(journal)
        items = [mod.WorkItem("0/0/000", t, 0) for t in range(3)]
        prog.mark(items[:2])
        prog.mark_failed(items[2], "read", "boom")
        journal.write_text(journal.read_text() + "{torn\n")
        assert mod._Progress(journal).done == {"0/0/000|0|0", "0/0/000|1|0"}


@pytest.mark.parametrize("fails,attempts,no_retry", [
    (0, 3, False), (2, 3, False), (3, 3, False), (1, 3, True), (0, 1, False),
])
def test_robust_call_copy_behaves_as_original(fails, attempts, no_retry):
    def outcome(fn):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise KeyError(calls["n"])
            return "ok"

        try:
            got = fn(flaky, attempts=attempts, wait_s=0.0,
                     no_retry=(KeyError,) if no_retry else ())
        except KeyError as e:
            got = f"raised {e}"
        return got, calls["n"]

    assert outcome(robust_call) == outcome(jax_robust_call)
    with pytest.raises(ValueError, match="attempts"):
        robust_call(lambda: None, attempts=0)


@pytest.mark.parametrize("update,match", [
    ({"phase": PhaseSettings(transfer_function={"yx_pixel_size": 0.116,
                                                "z_pixel_size": 0.25})}, None),
    ({"registration": RegistrationSettings(transform_path="transform.json")}, None),
    ({"shard_volumes": True}, "shard_volumes"),
    ({"deconvolve": DeconvolveSettings(acceleration="biggs", iterations=3)}, None),
    ({"deconvolve": DeconvolveSettings(algorithm="hybrid", separable_backend="matmul",
                                       hybrid_separable_iters=3, iterations=2)}, None),
    ({"deconvolve": DeconvolveSettings(separable_backend="linear_pallas", iterations=3)},
     None),
    ({"deconvolve": DeconvolveSettings(separable_backend="zy_pallas", iterations=3)}, None),
    ({"deconvolve": DeconvolveSettings(separable_backend="matmul", iterations=3)}, None),
    ({"deconvolve": DeconvolveSettings(separable_backend="fused_iter", iterations=3)}, None),
])
def test_unported_pipeline_settings_raise(update, match, tmp_path):
    """Settings the step refuses raise (``shard_volumes`` without a mesh
    whose space axis is > 1: JAX's ``ValueError``); those it runs
    (``match`` None) give a finite batch of the right shape, and the
    phase and hybrid stages JAX's ``reconstruct_batch`` within 1e-4 (the
    deskew's budget). A mesh that is not the port's ``Mesh`` is a
    ``TypeError`` that names a mesh. A registration case reads a real
    transform JSON from ``tmp_path``."""
    if "registration" in update:
        path = tmp_path / update["registration"].transform_path
        path.write_text(json.dumps({"matrix_zyx": [[1.01, 0, 0], [0.02, 0.99, 0], [0, 0, 1]],
                                    "offset_zyx": [0.5, -1.5, 2.0]}))
        update = {"registration": RegistrationSettings(transform_path=str(path))}
    settings = ReconstructSettings(deskew=DeskewSettings(px_to_scan_ratio=0.386),
                                   **update)
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    if match is None:
        raw = np.random.default_rng(3).random((1, 40, 24, 20)).astype(np.float32)
        out = build_reconstruct_step(settings, psf=psf, device="cpu")(raw)
        assert tuple(out.shape) == (1, *output_shape((40, 24, 20), settings))
        assert bool(torch.isfinite(out).all())
        if "phase" in update or getattr(update.get("deconvolve"), "algorithm", "") == "hybrid":
            ref = np.asarray(jax_reconstruct_batch(raw, settings, psf=psf))
            assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() <= 1e-4
    else:
        with pytest.raises(ValueError, match=f"{match} requires a device mesh with space > 1"):
            build_reconstruct_step(settings, psf=psf, device="cpu")
    with pytest.raises(TypeError, match="mesh must be a .*Mesh"):
        build_reconstruct_step(ReconstructSettings(), mesh=object(), device="cpu")


def test_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    settings = ReconstructSettings(deskew=DeskewSettings(px_to_scan_ratio=0.386))
    with pytest.raises(RuntimeError, match="is_available"):
        build_reconstruct_step(settings, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        richardson_lucy(np.ones((6, 20, 20), np.float32),
                        gaussian_psf((3, 5, 5), (1.0, 1.0, 1.0)), device="cuda:0")
    synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(40, 24, 16))
    result = CliRunner().invoke(cli, ["deskew", str(tmp_path / "ls.zarr"),
                                      "-o", str(tmp_path / "o.zarr")])
    assert result.exit_code != 0 and "is_available" in result.output
    assert not (tmp_path / "o.zarr").exists()


def test_compute_path_imports_no_jax():
    """The port's compute path on numpy input, in a fresh interpreter,
    ends with jax (and pydantic, tensorstore, click, yaml) unimported."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from shrimpy_tpu_torch.config import (
            deconvolve_settings, deskew_settings, reconstruct_settings)
        from shrimpy_tpu_torch.ops.deconv import gaussian_psf
        from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
        import shrimpy_tpu_torch.kernels.build, shrimpy_tpu_torch.ops.deskew_cuda
        import shrimpy_tpu_torch.utils.timing, shrimpy_tpu_torch.runtime.feed
        s = reconstruct_settings(deskew=deskew_settings(px_to_scan_ratio=0.386),
                                 deconvolve=deconvolve_settings(iterations=2))
        raw = np.random.default_rng(0).random((1, 40, 24, 16)).astype(np.float32)
        out = build_reconstruct_step(s, psf=gaussian_psf((5, 7, 7), (1, 1.5, 1.5)),
                                     device="cpu")(raw)
        assert out.shape[0] == 1 and bool(out.isfinite().all())
        bad = [m for m in ("jax", "pydantic", "tensorstore", "click", "yaml",
                           "shrimpy_tpu") if m in sys.modules]
        assert not bad, bad
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_settings_equal_bench_headline():
    """chip_smoke.py's namespaces equal bench.py::_run_headline's
    ReconstructSettings (bench.py:315-321) in every field the port reads."""
    smoke = _load_chip_smoke()
    ns = smoke.headline_settings()
    ref = ReconstructSettings(
        deskew=DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
        deconvolve=DeconvolveSettings(iterations=bench.RL_ITERS),
    )
    for field in tconfig.RECONSTRUCT_DEFAULTS:
        if field not in ("deskew", "deconvolve"):
            assert getattr(ns, field) == getattr(ref, field), field
    for field in tconfig.DESKEW_DEFAULTS:
        assert getattr(ns.deskew, field) == getattr(ref.deskew, field), field
    for field in tconfig.DECONVOLVE_DEFAULTS:
        assert getattr(ns.deconvolve, field) == getattr(ref.deconvolve, field), field
    for field in tconfig.IO_RETRY_DEFAULTS:
        assert getattr(ns.io_retry, field) == getattr(ref.io_retry, field), field
    assert smoke.RAW_SHAPE == bench.GEOMETRIES[0]
    assert smoke.PSF_SHAPE == bench.PSF_SHAPE
    assert smoke.ITERATIONS == bench.RL_ITERS


def test_settings_builders_carry_schema_defaults():
    for builder, model, defaults in (
        (tconfig.deskew_settings, DeskewSettings(), tconfig.DESKEW_DEFAULTS),
        (tconfig.deconvolve_settings, DeconvolveSettings(), tconfig.DECONVOLVE_DEFAULTS),
        (tconfig.reconstruct_settings, ReconstructSettings(), tconfig.RECONSTRUCT_DEFAULTS),
    ):
        ns = builder()
        for field in defaults:
            assert getattr(ns, field) == getattr(model, field), field
    io = IORetrySettings()
    for field in tconfig.IO_RETRY_DEFAULTS:
        assert getattr(tconfig.reconstruct_settings().io_retry, field) == getattr(io, field)
    with pytest.raises(TypeError, match="unknown"):
        tconfig.deskew_settings(angle=30)
    # require_ratio follows DeskewSettings' derivation rule.
    derived = DeskewSettings(pixel_size_um=0.116, scan_step_um=0.3)
    ns = tconfig.deskew_settings(pixel_size_um=0.116, scan_step_um=0.3)
    assert tconfig.require_ratio(ns) == derived.require_ratio()
    with pytest.raises(ValueError, match="px_to_scan_ratio"):
        tconfig.require_ratio(tconfig.deskew_settings())


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, where):
    """No card here: the script exits non-zero and prints no result, in
    the repository and in a directory that holds only the script."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a visible card would run the whole smoke test")
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _fake_nvcc(tmp_path, body: str) -> None:
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)


def test_build_keys_library_by_sources_and_reports_nvcc_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    _fake_nvcc(tmp_path, 'echo "error: boom in rl_fused.cu" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="boom in rl_fused.cu"):
        build.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_invokes_nvcc_for_sm90a_once(tmp_path, monkeypatch):
    """One build: an nvcc per source for sm_90a, then one link; a second
    build() finds the keyed library and calls nvcc no more."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    log = tmp_path / "calls"
    # Record the arguments; write the -o target like nvcc would.
    _fake_nvcc(tmp_path, f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\n'
                         'touch "$2"\n')
    first = build.build()
    assert first.exists() and first.parent == tmp_path / "build"
    assert build.build() == first
    calls = log.read_text().splitlines()
    assert {s.name for s in build.sources()} == {"deskew.cu", "rl_fused.cu", "rl_half.cu",
                                                 "convzy.cu", "rl_iter.cu", "probes.cu",
                                                 "affine.cu", "zband.cu", "rl_pass.cu",
                                                 "rl_fft.cu"}
    assert len(calls) == len(build.sources()) + 1
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    compiles = [c for c in calls if " -c " in c]
    for src in build.sources():
        assert sum(str(src) in c for c in compiles) == 1
    (link,) = [c for c in calls if "-shared" in c]
    assert sum(w.endswith(".o") for w in link.split()) == len(build.sources())
    assert link.split()[-1] == "-lcufft"  # after the objects that call it
    assert not list((tmp_path / "build").glob("objs.*"))  # objects removed


def test_build_key_covers_the_link_flags(monkeypatch):
    """The common library's name changes with what it links, so a build
    without cuFFT is never served for one with it."""
    with_cufft = build.library_path()
    monkeypatch.setattr(build, "LINK_FLAGS", [])
    assert build.library_path() != with_cufft


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_stage_timer_and_cpu_feed():
    timer = StageTimer()
    with timer.stage("a", log=False):
        pass
    with timer.stage("a", log=False):
        pass
    assert set(timer.as_dict()) == {"a"} and len(timer.records) == 2
    feed = DeviceFeed(torch.device("cpu"), (2, 3, 4, 5))
    batch = np.random.default_rng(0).random((2, 3, 4, 5)).astype(np.float32)
    dev = feed.to_device(batch)
    np.testing.assert_array_equal(feed.collect(feed.start_to_host(dev * 2)), batch * 2)
