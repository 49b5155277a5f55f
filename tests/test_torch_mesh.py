"""Multi-device reconstruction of the port (ROADMAP item 11) on the CPU.

Four gloo ranks, started once for the module (``launch.Ranks``), run the
port's mesh: the slab FFT against JAX's under ``shard_map``, the dryrun
passes of ``__graft_entry__.py`` (held to the port's single-device step
within 1e-5 and to JAX's run of the same settings on ``make_mesh(4,
space=...)`` of the 8 virtual devices within 1e-4, the RL backend named
on both sides), ``tests/test_parallel.py``'s cases, the store runtime on
a mesh against JAX's store, and the import gate in every rank. The CLI's
``--devices 2`` and a failing rank each start ranks of their own.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from shrimpy_tpu.config import (
    DeconvolveSettings,
    DeskewSettings,
    PhaseSettings,
    ReconstructSettings,
)
from shrimpy_tpu.io.ngff import create_fov, create_hcs, open_ngff
from shrimpy_tpu.io.synthetic import synthetic_ls_stack, tilted_gaussian_psf
from shrimpy_tpu.ops.deconv import gaussian_psf
from shrimpy_tpu.parallel import make_mesh as jax_make_mesh
from shrimpy_tpu.parallel import reconstruct_batch as jax_reconstruct_batch
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.parallel import launch
from shrimpy_tpu_torch.parallel import make_mesh, reconstruct_batch
from shrimpy_tpu_torch.parallel.fft import slab_fft
from shrimpy_tpu_torch.parallel.mesh import Mesh, check_devices
from shrimpy_tpu_torch.parallel.pipeline import (
    _deconv_fn,
    build_reconstruct_step,
    output_shape,
    sharded_rl_grid,
)
from shrimpy_tpu_torch.runtime.stream import reconstruct_store

torch.set_num_threads(1)

DESKEW = DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=0.386)
SETTINGS = ReconstructSettings(deskew=DESKEW, deconvolve=DeconvolveSettings(iterations=3))
PHASE = PhaseSettings(transfer_function={"yx_pixel_size": 0.116, "z_pixel_size": 0.25,
                                         "z_padding": 0})


@pytest.fixture(scope="module")
def ranks():
    with launch.Ranks(4, devices=["cpu"] * 4) as r:
        yield r


def rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() or 1.0))


def named(settings, backend: str):
    """``settings`` with its separable backend named (JAX's ``auto`` is
    device-keyed; ROADMAP, Known behaviours)."""
    return settings.model_copy(update={"deconvolve": settings.deconvolve.model_copy(
        update={"separable_backend": backend})})


def on_jax_mesh(raw, settings, psf, space):
    return np.asarray(jax_reconstruct_batch(raw, settings, psf=psf,
                                            mesh=jax_make_mesh(4, space=space)))


# --- make_mesh -------------------------------------------------------------


@pytest.mark.parametrize("args,kwargs", [
    ((0,), {}), ((100,), {}), ((8,), {"space": 0}), ((8,), {"space": 3}),
])
def test_make_mesh_errors_are_jax_s(args, kwargs):
    with pytest.raises(ValueError) as ref:
        jax_make_mesh(*args, **kwargs)
    with pytest.raises(ValueError) as got:
        make_mesh(*args, devices=["cpu"] * 8, **kwargs)
    assert str(got.value) == str(ref.value)


def test_make_mesh_one_process_and_repeated_cards():
    mesh = make_mesh(1, devices=["cpu"])
    assert mesh.devices.shape == (1, 1) and mesh.devices.size == 1
    assert mesh.axis_names == ("batch", "space") and mesh.device == torch.device("cpu")
    assert mesh.world is None and mesh.group("space") is None
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_mesh(8, space=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="NCCL cannot run two ranks .*cuda:0 repeated"):
        check_devices(["cuda:0", "cuda", "cuda:1"], "nccl")
    with pytest.raises(ValueError, match="NCCL cannot run two ranks"):
        launch.resolve_launch(2, "nccl", ["cuda:0", "cuda:0"])
    assert launch.resolve_launch(4, "gloo", ["cuda:0"] * 4) == ("gloo", ["cuda:0"] * 4)
    assert launch.resolve_launch(2, None, ["cpu", "cpu"]) == ("gloo", ["cpu", "cpu"])


@pytest.mark.parametrize("space", [1, 2, 4])
def test_mesh_shapes_on_four_ranks_and_no_jax_in_any(ranks, space):
    every = ranks.run(launch.describe, space=space)
    ref = jax_make_mesh(4, space=space)
    assert [r["rank"] for r in every] == [0, 1, 2, 3]
    for r in every:
        assert r["shape"] == ref.devices.shape and r["axis_names"] == ref.axis_names
        assert r["coords"] == divmod(r["rank"], space)
        assert r["device"] == "cpu" and r["backend"] == "gloo"
        assert "torch" in r["packages"] and "shrimpy_tpu_torch" in r["packages"]
        assert not {"jax", "jaxlib", "shrimpy_tpu", "flax", "optax"} & set(r["packages"])


# --- the slab FFT ----------------------------------------------------------


@pytest.mark.parametrize("transform", ["xla", "matmul"])
def test_slab_fft_matches_jax_shard_map(ranks, transform):
    import jax
    from jax.sharding import PartitionSpec as P

    from shrimpy_tpu.parallel.fft import fft3_sharded, ifft3_sharded

    x = np.random.default_rng(7).random((2, 8, 16, 64), dtype=np.float32).astype(np.complex64)
    spec = P("batch", None, None, "space")

    def jax_run(fn, v):
        return np.asarray(jax.jit(jax.shard_map(
            lambda blk: fn(blk, "space", transform), mesh=jax_make_mesh(4, space=4),
            in_specs=spec, out_specs=spec, check_vma=False))(v))

    got = ranks.run(slab_fft, space=4, args=(x,), kwargs={"transform": transform}).numpy()
    ref = jax_run(fft3_sharded, x)
    assert rel(got, ref) <= 1e-5
    assert rel(got, np.fft.fftn(x, axes=(1, 2, 3))) <= 1e-5
    back = ranks.run(slab_fft, space=4, args=(got,),
                     kwargs={"transform": transform, "inverse": True}).numpy()
    assert rel(back, x) <= 1e-5
    assert rel(back, jax_run(ifft3_sharded, ref)) <= 1e-5


# --- the dryrun passes (__graft_entry__.py) ----------------------------------


def test_dryrun_pass_1(ranks):
    """Mesh (2, 2), auto backends: equal to the single-device step."""
    settings = ReconstructSettings(deskew=DESKEW, deconvolve=DeconvolveSettings(iterations=5))
    psf = gaussian_psf((3, 3, 3), (0.8, 0.8, 0.8))
    raw = np.random.default_rng(0).random((2, 16, 12, 256), dtype=np.float32)
    out = ranks.run(reconstruct_batch, space=2, args=(raw, settings), kwargs={"psf": psf})
    single = reconstruct_batch(raw, settings, psf=psf, device="cpu")
    assert tuple(out.shape) == (2, *output_shape((16, 12, 256), settings))
    assert rel(out, single) <= 1e-5
    matmul = named(settings, "matmul")
    ours = ranks.run(reconstruct_batch, space=2, args=(raw, matmul), kwargs={"psf": psf})
    assert rel(ours, on_jax_mesh(raw, matmul, psf, 2)) <= 1e-4


def test_dryrun_pass_2(ranks):
    """Mesh (1, 4): the deskew kernel's plain version and the fused RL on
    X slabs of 256, against the single-device step and JAX's Pallas
    deskew + fused RL (interpret mode) on its mesh."""
    settings = ReconstructSettings(
        deskew=DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=0.386, backend="pallas"),
        deconvolve=DeconvolveSettings(iterations=2, separable_backend="fused"))
    psf = gaussian_psf((3, 7, 7), (0.8, 1.2, 1.2))
    raw = np.random.default_rng(1).random((1, 80, 12, 1024), dtype=np.float32) * 50.0
    out = ranks.run(reconstruct_batch, space=4, args=(raw, settings), kwargs={"psf": psf})
    assert rel(out, reconstruct_batch(raw, settings, psf=psf, device="cpu")) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, 4)) <= 1e-4


def _shard_settings(psf_phase: bool, **deconv):
    kw = {"phase": PhaseSettings(transfer_function=PHASE.transfer_function,
                                 apply_inverse={"transform": "matmul"})} if psf_phase else {}
    return ReconstructSettings(deconvolve=DeconvolveSettings(**deconv), shard_volumes=True,
                               **kw)


def test_dryrun_pass_3(ranks):
    """shard_volumes: phase + dft2z RL-2 as slab FFTs over space 4."""
    settings = _shard_settings(True, iterations=2, algorithm="fft", fft_backend="dft2z")
    psf = gaussian_psf((3, 7, 7), (0.8, 1.2, 1.2))
    raw = np.random.default_rng(2).random((1, 8, 16, 256), dtype=np.float32) * 50.0
    out = ranks.run(reconstruct_batch, space=4, args=(raw, settings), kwargs={"psf": psf})
    single = reconstruct_batch(raw, settings.model_copy(update={"shard_volumes": False}),
                               psf=psf, device="cpu")
    assert rel(out, single) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, 4)) <= 1e-4


def test_dryrun_pass_4(ranks):
    """(a) The non-separable PSF through the slab RL; (b) the production
    carry's per-rank shard and memory estimate, from shapes alone (JAX's
    pass traces it with ``eval_shape``)."""
    import jax

    from shrimpy_tpu.ops.deconv import _padded_grid_shape as jax_grid
    from shrimpy_tpu.parallel.pipeline import build_reconstruct_step as jax_build

    from shrimpy_tpu_torch.ops.deconv import plan_separable_terms, prepare_psf

    settings = _shard_settings(False, iterations=2, algorithm="fft", fft_backend="dft2z")
    psf = tilted_gaussian_psf()
    assert plan_separable_terms(prepare_psf(psf, settings.deconvolve), settings.deconvolve) is None
    raw = np.random.default_rng(3).random((1, 8, 16, 256), dtype=np.float32) * 50.0
    out = ranks.run(reconstruct_batch, space=4, args=(raw, settings), kwargs={"psf": psf})
    single = reconstruct_batch(raw, settings.model_copy(update={"shard_volumes": False}),
                               psf=psf, device="cpu")
    assert rel(out, single) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, 4)) <= 1e-4

    prod = (128, 2888, 1600)
    psf_w = prepare_psf(psf, settings.deconvolve)
    transform, grid, _ = sharded_rl_grid(prod, psf_w.shape, settings.deconvolve, 4)
    assert transform == "matmul"
    assert grid == jax_grid(prod, tuple(psf_w.shape), transform="matmul")[0] == (144, 2920, 1664)
    shard = (1, grid[0], grid[1], grid[2] // 4)
    assert shard == (1, 144, 2920, 416)
    est = 2 * 4 * int(np.prod(shard)) + 3 * 8 * int(np.prod(shard))
    assert round(est / 1024**3, 2) == 5.21
    step = jax_build(settings, psf=psf, mesh=jax_make_mesh(4, space=4), donate=False)
    abstract = jax.ShapeDtypeStruct((1, *prod), np.float32)
    tf_abs = jax.ShapeDtypeStruct((2, 1, 1, 1), np.float32)
    assert tuple(jax.eval_shape(step, abstract, tf_abs).shape) == (1, *prod)


# --- tests/test_parallel.py's cases ------------------------------------------


@pytest.mark.parametrize("b,space", [(8, 1), (4, 2), (8, 2), (2, 2)])
def test_batch_and_space_sharding_match_single_device(ranks, b, space):
    """Volumes over batch (8 over 4), the replicated row (B 4 or 2 on a
    (2, 2) mesh) and the flattened reshard (8 over (2, 2))."""
    raw = np.random.default_rng(b + space).random((b, 24, 16, 128), dtype=np.float32) * 50.0
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    settings = named(SETTINGS, "matmul")
    out = ranks.run(reconstruct_batch, space=space, args=(raw, settings), kwargs={"psf": psf})
    assert rel(out, reconstruct_batch(raw, settings, psf=psf, device="cpu")) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, space)) <= 1e-4


def test_phase_on_whole_volumes_after_the_reshard(ranks, tmp_path):
    """Deskew + phase over (2, 2): the step computing the transfer
    function, and the store runtime handing it in."""
    settings = ReconstructSettings(deskew=DESKEW, phase=PHASE)
    raw = np.random.default_rng(14).random((4, 24, 16, 128), dtype=np.float32) * 50.0
    single = reconstruct_batch(raw, settings, device="cpu")
    out = ranks.run(reconstruct_batch, space=2, args=(raw, settings))
    assert rel(out, single) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, None, 2)) <= 1e-4
    pos = create_fov(tmp_path / "in.zarr", shape=(4, 1, 24, 16, 128), dtype="float32",
                     channel_names=["BF"], zyx_scale=(0.25, 0.116, 0.116))
    pos.write(Ellipsis, raw[:, None])
    summary = ranks.run(reconstruct_store, space=2,
                        args=(tmp_path / "in.zarr", tmp_path / "out.zarr", settings),
                        kwargs={"batch_size": 4})
    assert summary["volumes"] == 4 and summary["mesh"] == {"batch": 2, "space": 2}
    stored = open_ngff(tmp_path / "out.zarr").position().read()[:, 0]
    assert rel(stored, single) <= 1e-5


def test_deskew_only_pipeline(ranks):
    from shrimpy_tpu.ops.deskew import deskew_volume as jax_deskew

    settings = ReconstructSettings(deskew=DESKEW)
    raw = np.random.default_rng(5).random((8, 20, 12, 128), dtype=np.float32) * 50.0
    out = ranks.run(reconstruct_batch, space=2, args=(raw, settings))
    # The port's deskew is JAX's within its budget of 1e-4 of the range.
    assert rel(out[3], np.asarray(jax_deskew(raw[3], DESKEW))) <= 1e-4
    assert rel(out, on_jax_mesh(raw, settings, None, 2)) <= 1e-4
    assert rel(out, reconstruct_batch(raw, settings, device="cpu")) == 0.0


@pytest.mark.parametrize("stage", ["fft_rl", "phase"])
def test_shard_volumes_stages_match_single_device(ranks, stage):
    raw = np.random.default_rng(6).random((2, 8, 16, 256), dtype=np.float32) * 50.0
    if stage == "phase":
        settings = ReconstructSettings(phase=PHASE, shard_volumes=True)
        psf = None
    else:
        settings = ReconstructSettings(
            deconvolve=DeconvolveSettings(iterations=3, algorithm="fft"), shard_volumes=True)
        psf = gaussian_psf((3, 5, 5), (0.8, 1.0, 1.0))
    out = ranks.run(reconstruct_batch, space=4, args=(raw, settings), kwargs={"psf": psf})
    single = reconstruct_batch(raw, settings.model_copy(update={"shard_volumes": False}),
                               psf=psf, device="cpu")
    assert rel(out, single) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, 4)) <= 1e-4


@pytest.mark.parametrize("pad_mode", ["edge", "constant"])
def test_shard_volumes_x_pad_and_crop_in_each_pad_mode(ranks, pad_mode):
    """The grid's X pad and crop move columns between the ranks' slabs
    (uneven splits; reflect in the tests above): the sharded RL in the
    other pad modes, and a PSF whose X pad reaches past a whole slab."""
    raw = np.random.default_rng(13).random((1, 8, 16, 64), dtype=np.float32) * 50.0
    settings = ReconstructSettings(deconvolve=DeconvolveSettings(
        iterations=2, algorithm="fft", fft_backend="fft3", pad_mode=pad_mode), shard_volumes=True)
    psf = gaussian_psf((3, 5, 41), (0.8, 1.0, 6.0))
    out = ranks.run(reconstruct_batch, space=4, args=(raw, settings), kwargs={"psf": psf})
    single = reconstruct_batch(raw, settings.model_copy(update={"shard_volumes": False}),
                               psf=psf, device="cpu")
    assert rel(out, single) <= 1e-5
    assert rel(out, on_jax_mesh(raw, settings, psf, 4)) <= 1e-4


def _fake_mesh(shape) -> Mesh:
    """A mesh of ``shape`` seen from rank 0 without a process group: the
    checks that raise before any collective run on it."""
    return Mesh(np.full(shape, torch.device("cpu"), dtype=object))


def test_mesh_divisibility_errors_are_jax_s():
    psf = gaussian_psf((5, 5, 5), (1.0, 1.0, 1.0))
    rng = np.random.default_rng(8)
    for raw, shape, match in (
        (rng.random((3, 24, 16, 128), dtype=np.float32), (2, 2), "batch size 3 must be divisible"),
        (rng.random((4, 24, 16, 130), dtype=np.float32), (1, 4), "X extent .* must be divisible"),
    ):
        with pytest.raises(ValueError, match=match) as ref:
            jax_reconstruct_batch(raw, SETTINGS, psf=psf, mesh=jax_make_mesh(4, space=shape[1]))
        with pytest.raises(ValueError) as got:
            build_reconstruct_step(SETTINGS, psf=psf, mesh=_fake_mesh(shape))(raw)
        assert str(got.value) == str(ref.value)


def test_shard_volumes_rejections_are_jax_s():
    """Without a space axis; Biggs on the sharded path; separable and
    hybrid at the schema tier (``tests/test_deconv.py``)."""
    s = ReconstructSettings(deconvolve=DeconvolveSettings(iterations=2, algorithm="fft"),
                            shard_volumes=True)
    psf = gaussian_psf((3, 5, 5), (0.8, 1.0, 1.0))
    for mesh in (None, _fake_mesh((4, 1))):
        with pytest.raises(ValueError, match="shard_volumes requires a device mesh with space > 1"):
            build_reconstruct_step(s, psf=psf, mesh=mesh, device=None if mesh else "cpu")
    biggs = ReconstructSettings(deconvolve=DeconvolveSettings(
        iterations=2, algorithm="fft", fft_backend="fft3", acceleration="biggs"),
        shard_volumes=True)
    with pytest.raises(ValueError) as ref:
        jax_reconstruct_batch(np.ones((2, 8, 16, 32), np.float32), biggs, psf=psf,
                              mesh=jax_make_mesh(8, space=4))
    with pytest.raises(ValueError) as got:
        build_reconstruct_step(biggs, psf=psf, mesh=_fake_mesh((1, 4)))
    assert "acceleration" in str(ref.value) and str(got.value) == str(ref.value)
    for algorithm in ("separable", "hybrid"):
        with pytest.raises(ValueError, match=algorithm) as ref:
            ReconstructSettings(deconvolve={"algorithm": algorithm, "iterations": 2},
                                shard_volumes=True)
        with pytest.raises(ValueError) as got:
            tconfig.reconstruct_settings(
                deconvolve=tconfig.deconvolve_settings(algorithm=algorithm, iterations=2),
                shard_volumes=True)
        assert str(got.value) in str(ref.value)


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("algorithm", ["auto", "fft", "separable", "hybrid"])
def test_reconstruct_settings_refuses_what_the_schema_refuses(shard, algorithm):
    """F4: the namespace takes and refuses what ``_check_shard_volumes``
    does, with its message."""
    try:
        ReconstructSettings(deconvolve=DeconvolveSettings(algorithm=algorithm),
                            shard_volumes=shard)
        ref = None
    except ValueError as e:
        ref = str(e)
    try:
        tconfig.reconstruct_settings(deconvolve=tconfig.deconvolve_settings(algorithm=algorithm),
                                     shard_volumes=shard)
        got = None
    except ValueError as e:
        got = str(e)
    assert (got is None) == (ref is None) == (not shard or algorithm in ("auto", "fft"))
    if ref is not None:
        assert got in ref


def test_explicit_fused_backend_unsupported_geometry_raises():
    """JAX's fused kernel refuses an x far below ``bx + 256``; the card's
    kernel takes any extent (``fused_bound_error`` is None there, and the
    step runs) and refuses only radii past its shared memory, where
    ``auto`` goes to ``matmul``."""
    from shrimpy_tpu_torch.ops.deconv import resolve_separable_backend
    from shrimpy_tpu_torch.ops.rl_fused import fused_bound_error

    settings = ReconstructSettings(deconvolve=DeconvolveSettings(iterations=2,
                                                                 separable_backend="fused"))
    psf = gaussian_psf((3, 5, 5), (0.8, 1.0, 1.0))
    raw = np.random.default_rng(9).random((1, 8, 16, 64), dtype=np.float32)
    with pytest.raises(ValueError, match="fused"):
        jax_reconstruct_batch(raw, settings, psf=psf)
    assert fused_bound_error((10, 20, 68), (1, 2, 2)) is None
    out = reconstruct_batch(raw, settings, psf=psf, device="cpu")
    assert bool(torch.isfinite(out).all())
    assert "z/y radius 212" in fused_bound_error((10, 440, 68), (1, 212, 1))
    assert resolve_separable_backend("auto", (8, 16, 64), (3, 425, 3)) == "matmul"


def test_pipeline_nonsep_fallback_honors_fft_backend():
    from shrimpy_tpu.parallel.pipeline import _deconv_fn as jax_deconv_fn

    from shrimpy_tpu_torch.ops.deconv import richardson_lucy

    zz, yy, xx = np.meshgrid(np.arange(5) - 2.0, np.arange(7) - 3.0, np.arange(7) - 3.0,
                             indexing="ij")
    psf = np.exp(-0.5 * (((zz + 0.8 * yy) / 1.0) ** 2 + ((yy + 0.7 * xx) / 1.5) ** 2
                         + (xx / 2.0) ** 2)).astype(np.float32)
    psf /= psf.sum()
    vol = np.random.default_rng(10).random((8, 24, 20), dtype=np.float32) * 50.0
    for backend in ("fft2z", "fft3"):
        deconv = DeconvolveSettings(iterations=3, algorithm="fft", fft_backend=backend,
                                    fft_z_chunk=2)
        settings = ReconstructSettings(deconvolve=deconv)
        ours = _deconv_fn(settings, psf, plain=False, dtype=torch.float32)(torch.from_numpy(vol))
        oracle = richardson_lucy(vol, psf, deconv, device="cpu")
        np.testing.assert_allclose(ours.numpy(), oracle.numpy(), rtol=0, atol=1e-5)
        ref = np.asarray(jax_deconv_fn(settings, psf)(vol))
        assert rel(ours, ref) <= 1e-5


def test_a_failing_rank_fails_the_parent():
    with pytest.raises(launch.RankError, match="(?s)rank . of 2 failed.*Traceback.*"
                                               "batch size 3 must be divisible"):
        launch.spawn(reconstruct_batch, 2, devices=["cpu"] * 2,
                     args=(np.zeros((3, 16, 12, 64), np.float32), SETTINGS),
                     kwargs={"psf": gaussian_psf((3, 3, 3), (0.8, 0.8, 0.8))})


# --- the store runtime and the CLI -------------------------------------------


def test_mesh_plate_through_runtime_equals_jax_store(ranks, tmp_path):
    """test_runtime.py's plate: 2 positions x 2 timepoints over (4, 1)."""
    from shrimpy_tpu.runtime import reconstruct_store as jax_store

    rng = np.random.default_rng(11)
    plate = tmp_path / "plate.zarr"
    store = create_hcs(plate, channel_names=["GFP"])
    for p in range(2):
        pos = store.create_position("0", str(p), "000", channel_names=["GFP"])
        pos.create_array((2, 1, 32, 24, 16), dtype="float32")
        pos.write(Ellipsis, rng.random((2, 1, 32, 24, 16), dtype=np.float32))
    settings = named(ReconstructSettings(deskew=DESKEW, deconvolve=DeconvolveSettings(
        iterations=2)), "matmul")
    summary = ranks.run(reconstruct_store, space=1, args=(plate, tmp_path / "t.zarr", settings),
                        kwargs={"batch_size": 4})
    assert summary["volumes"] == 4 and summary["mesh"] == {"batch": 4, "space": 1}
    jax_store(plate, tmp_path / "j.zarr", settings, mesh=jax_make_mesh(4), batch_size=4)
    ours, ref = open_ngff(tmp_path / "t.zarr"), open_ngff(tmp_path / "j.zarr")
    assert ours.is_plate and sorted(ours.positions()) == ["0/0/000", "0/1/000"]
    for key in ("0/0/000", "0/1/000"):
        assert rel(ours.positions()[key].read(), ref.positions()[key].read()) <= 1e-4
    again = ranks.run(reconstruct_store, space=1, args=(plate, tmp_path / "t.zarr", settings),
                      kwargs={"batch_size": 4, "resume": True})
    assert again["volumes"] == 0 and again["skipped_resume"] == 4


def test_shard_volumes_through_runtime_equals_jax_store(ranks, tmp_path):
    from shrimpy_tpu.runtime import reconstruct_store as jax_store

    rng = np.random.default_rng(12)
    pos = create_fov(tmp_path / "bf.zarr", shape=(2, 1, 8, 16, 256), dtype="float32",
                     channel_names=["BF"], zyx_scale=(0.25, 0.116, 0.116))
    for t in range(2):
        pos.write((t, 0), rng.random((8, 16, 256), dtype=np.float32) * 100)
    settings = ReconstructSettings(phase=PHASE, shard_volumes=True)
    summary = ranks.run(reconstruct_store, space=4,
                        args=(tmp_path / "bf.zarr", tmp_path / "t.zarr", settings))
    assert summary["volumes"] == 2 and summary["mesh"] == {"batch": 1, "space": 4}
    jax_store(tmp_path / "bf.zarr", tmp_path / "j.zarr", settings,
              mesh=jax_make_mesh(4, space=4))
    ours = open_ngff(tmp_path / "t.zarr").position().read()
    assert rel(ours, open_ngff(tmp_path / "j.zarr").position().read()) <= 1e-4
    single = reconstruct_store(tmp_path / "bf.zarr", tmp_path / "s.zarr",
                               settings.model_copy(update={"shard_volumes": False}),
                               device="cpu")
    assert single["volumes"] == 2
    assert rel(ours, open_ngff(tmp_path / "s.zarr").position().read()) <= 1e-5


def test_cli_reconstruct_devices_2_writes_the_store_of_devices_1(tmp_path):
    from shrimpy_tpu.cli.main import cli as jax_cli

    synthetic_ls_stack(tmp_path / "ls.zarr", raw_shape_szx=(48, 32, 32))
    cfg = tmp_path / "r.yml"
    cfg.write_text("deskew: {ls_angle_deg: 30.0}\n"
                   "deconvolve: {iterations: 3, separable_backend: matmul}\n")
    outs = {}
    for name, extra in (("one", ["--devices", "1"]), ("two", ["--devices", "2"]),
                        ("space", ["--devices", "2", "--space", "2"])):
        result = CliRunner().invoke(cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o",
                                          str(tmp_path / f"{name}.zarr"), "-c", str(cfg),
                                          "--device", "cpu", *extra])
        assert result.exit_code == 0, result.output
        outs[name] = open_ngff(tmp_path / f"{name}.zarr").position().read()
    assert '"mesh"' in result.stdout and '"space": 2' in result.stdout
    assert rel(outs["two"], outs["one"]) == 0.0 and rel(outs["space"], outs["one"]) == 0.0
    result = CliRunner().invoke(jax_cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o",
                                          str(tmp_path / "jax.zarr"), "-c", str(cfg),
                                          "--devices", "2"])
    assert result.exit_code == 0, result.output
    assert rel(outs["two"], open_ngff(tmp_path / "jax.zarr").position().read()) <= 1e-4
    bad = CliRunner().invoke(cli, ["reconstruct", str(tmp_path / "ls.zarr"), "-o",
                                   str(tmp_path / "bad.zarr"), "-c", str(cfg), "--device",
                                   "cpu", "--space", "2"])
    assert bad.exit_code != 0 and "--space 2 needs --devices" in bad.output
