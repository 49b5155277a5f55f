"""PyTorch port of phase reconstruction against the JAX package (CPU).

The host transfer function (float64 numpy) and ``tf_as_real`` are
copies, pinned bit for bit. The inverse runs on ``torch.fft`` and is
held against JAX's ``apply_inverse_transfer_function`` for every
``transform`` value within 1e-5 of the scale (float32 transforms in
another order) and against its own float64 path within 1e-5; the
physics tests of ``tests/test_phase.py`` run on the port's functions.
The stage runs through ``build_reconstruct_step`` (alone and after the
deskew, against JAX's ``reconstruct_batch``: 1e-4, the deskew's own
budget), ``reconstruct_store`` with the default ``z_padding`` of 5 and
the ``phase`` verb.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from shrimpy_tpu.config import (
    DeskewSettings,
    PhaseApplyInverseSettings,
    PhaseSettings,
    PhaseTransferFunctionSettings,
    ReconstructSettings,
)
from shrimpy_tpu.io.ngff import create_fov, open_ngff
from shrimpy_tpu.io.synthetic import gaussian_blob
from shrimpy_tpu.ops import phase as jphase
from shrimpy_tpu.parallel.pipeline import reconstruct_batch as jax_reconstruct_batch
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.ops import phase as tphase
from shrimpy_tpu_torch.parallel.pipeline import (
    _stage_input_shape_for_phase,
    build_reconstruct_step,
    output_shape,
)
from shrimpy_tpu_torch.runtime.stream import reconstruct_store

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

TF_SETTINGS = PhaseTransferFunctionSettings(
    wavelength_illumination=0.450,
    index_of_refraction_media=1.4,
    numerical_aperture_detection=1.35,
    numerical_aperture_illumination=0.52,
    yx_pixel_size=0.116,
    z_pixel_size=0.2,
    z_padding=0,
)
JAX_RTOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _inverse(stack, tf, settings=None, **kw):
    return tphase.apply_inverse_transfer_function(stack, tf, settings, device="cpu",
                                                  **kw).numpy()


@pytest.mark.parametrize("shape,update", [
    ((12, 24, 24), {}), ((8, 32, 30), {"z_padding": 5}), ((10, 24, 25), {"z_padding": 3}),
    ((6, 16, 16), {"invert_phase_contrast": True, "numerical_aperture_illumination": 0.9}),
])
def test_transfer_function_equals_jax(shape, update):
    tfs = TF_SETTINGS.model_copy(update=update)
    ours = tphase.compute_transfer_function(shape, tfs)
    ref = jphase.compute_transfer_function(shape, tfs)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tphase.tf_as_real(ours), jphase.tf_as_real(ref))


def test_phase_defaults_equal_schema():
    ns = tconfig.phase_settings()
    model = PhaseSettings()
    for field in tconfig.PHASE_TF_DEFAULTS:
        assert getattr(ns.transfer_function, field) == getattr(model.transfer_function, field)
    for field in tconfig.PHASE_INVERSE_DEFAULTS:
        assert getattr(ns.apply_inverse, field) == getattr(model.apply_inverse, field)
    tfs = tconfig.phase_settings({"yx_pixel_size": 0.116, "z_pixel_size": 0.2, "z_padding": 0})
    np.testing.assert_array_equal(
        tphase.compute_transfer_function((6, 16, 16), tfs.transfer_function),
        jphase.compute_transfer_function((6, 16, 16), TF_SETTINGS))


def test_tf_requires_injected_pixel_sizes():
    with pytest.raises(ValueError, match="yx_pixel_size"):
        tphase.compute_transfer_function((8, 16, 16), PhaseTransferFunctionSettings())


def test_tf_hermitian_and_dc_free():
    tf = tphase.compute_transfer_function((12, 24, 24), TF_SETTINGS)
    mirror = np.conj(np.roll(tf[::-1, ::-1, ::-1], (1, 1, 1), axis=(0, 1, 2)))
    np.testing.assert_allclose(tf, mirror, atol=1e-5)
    assert abs(tf[0, 0, 0]) < 1e-6
    assert np.abs(tf).max() > 1e-3


def test_forward_stack_is_real_contrast():
    phi = np.random.default_rng(0).normal(size=(12, 24, 24))
    tf = tphase.compute_transfer_function((12, 24, 24), TF_SETTINGS)
    stack = tphase.simulate_defocus_stack(phi, tf, background=1.0)
    np.testing.assert_array_equal(stack, jphase.simulate_defocus_stack(phi, tf, background=1.0))
    assert np.isfinite(stack).all() and stack.std() > 0
    assert abs(stack.mean() - 1.0) < 1e-3


def _phase_object(shape, amplitude=0.1):
    phi = gaussian_blob(shape, tuple(n / 2.0 for n in shape), (2.0, 4.0, 4.0),
                        amplitude=amplitude)
    return phi - phi.mean()


def test_inverse_recovers_simulated_phase_object():
    """tests/test_phase.py:65 on the port."""
    shape = (16, 32, 32)
    phi = _phase_object(shape)
    tf = tphase.compute_transfer_function(shape, TF_SETTINGS)
    stack = tphase.simulate_defocus_stack(phi, tf, background=1.0)
    recon = _inverse(stack, tf, PhaseApplyInverseSettings(regularization_strength=1e-4))
    assert np.corrcoef(recon.ravel(), phi.ravel())[0, 1] > 0.8


def test_invert_phase_contrast_flips_sign():
    shape = (12, 24, 24)
    phi = _phase_object(shape, 0.05)
    tf = tphase.compute_transfer_function(shape, TF_SETTINGS)
    stack = tphase.simulate_defocus_stack(phi, tf)
    s = PhaseApplyInverseSettings(regularization_strength=1e-4)
    inv_tf = tphase.compute_transfer_function(
        shape, TF_SETTINGS.model_copy(update={"invert_phase_contrast": True}))
    np.testing.assert_allclose(_inverse(stack, inv_tf, s), -_inverse(stack, tf, s), atol=1e-5)


@pytest.mark.parametrize("transform", ["auto", "xla", "matmul"])
@pytest.mark.parametrize("shape,zpad", [((12, 28, 30), 0), ((10, 24, 25), 3), ((8, 16, 16), 5)])
def test_inverse_matches_jax(transform, shape, zpad):
    """Each ``transform`` value against JAX's own path for it; the real
    (2, Z, Y, X) pair gives the complex TF's result; the float64 path
    agrees; ``matmul`` (half spectrum) agrees with ``xla``."""
    tfs = TF_SETTINGS.model_copy(update={"z_padding": zpad})
    tf = tphase.compute_transfer_function(shape, tfs)
    stack = tphase.simulate_defocus_stack(_phase_object(shape, 0.05),
                                          tphase.compute_transfer_function(shape, TF_SETTINGS))
    s = PhaseApplyInverseSettings(regularization_strength=1e-3, transform=transform)
    ref = np.asarray(jphase.apply_inverse_transfer_function(stack, tf, s, z_padding=zpad))
    ours = _inverse(stack, tf, s, z_padding=zpad)
    assert ours.shape == shape and _rel(ours, ref) <= JAX_RTOL
    np.testing.assert_array_equal(_inverse(stack, tphase.tf_as_real(tf), s, z_padding=zpad),
                                  ours)
    ours64 = _inverse(stack, tf, s, z_padding=zpad, dtype=torch.float64)
    assert _rel(ours, ours64) <= 1e-5
    xla = _inverse(stack, tf, s.model_copy(update={"transform": "xla"}), z_padding=zpad)
    assert _rel(ours, xla) <= 1e-4


def test_reconstruct_phase_matches_jax():
    shape = (10, 24, 24)
    settings = PhaseSettings(
        transfer_function=TF_SETTINGS.model_copy(update={"z_padding": 4}).model_dump(),
        apply_inverse={"regularization_strength": 1e-3},
    )
    stack = 1.0 + 0.01 * np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = np.asarray(jphase.reconstruct_phase(stack, settings))
    ours = tphase.reconstruct_phase(stack, settings, device="cpu").numpy()
    assert ours.shape == shape and np.isfinite(ours).all()
    assert _rel(ours, ref) <= JAX_RTOL


def test_inverse_guards():
    tf = tphase.compute_transfer_function((6, 16, 16), TF_SETTINGS)
    with pytest.raises(ValueError, match="does not match"):
        _inverse(np.ones((6, 16, 16), np.float32), tf, z_padding=2)
    with pytest.raises(ValueError, match="pair"):
        _inverse(np.ones((6, 16, 16), np.float32), tf.real.astype(np.float32))
    with pytest.raises(ValueError, match="transform"):
        tphase.resolve_transform(tconfig.phase_settings(apply_inverse={"transform": "dft"})
                                 .apply_inverse)


def _phase_settings(zpad=5):
    return PhaseSettings(transfer_function={"yx_pixel_size": 0.116, "z_pixel_size": 0.25,
                                            "z_padding": zpad},
                         apply_inverse={"regularization_strength": 1e-3})


@pytest.mark.parametrize("with_deskew", [False, True])
def test_step_phase_stage_matches_jax(with_deskew):
    """``settings.phase`` through the step, alone and after the deskew,
    against JAX's ``reconstruct_batch`` (which computes the TF of the
    post-deskew shape); the TF handed over as its real pair or computed
    by the step give the same bits."""
    deskew = DeskewSettings(px_to_scan_ratio=0.386, backend="xla") if with_deskew else None
    settings = ReconstructSettings(deskew=deskew, phase=_phase_settings())
    raw = (np.random.default_rng(3).random((1, 40, 24, 20)) * 100).astype(np.float32)
    ref = np.asarray(jax_reconstruct_batch(raw, settings))
    step = build_reconstruct_step(settings, device="cpu")
    ours = step(raw)
    assert tuple(ours.shape) == (1, *output_shape((40, 24, 20), settings))
    assert _rel(ours.numpy(), ref) <= (1e-4 if with_deskew else JAX_RTOL)
    tf = tphase.compute_transfer_function(
        _stage_input_shape_for_phase((40, 24, 20), settings), settings.phase.transfer_function)
    np.testing.assert_array_equal(step(raw, tphase.tf_as_real(tf)).numpy(), ours.numpy())
    np.testing.assert_array_equal(step(raw, tf).numpy(), ours.numpy())


def test_store_with_default_z_padding(tmp_path):
    """tests/test_runtime.py:240: the production z_padding (5) through the
    store runtime; the TF is of the unpadded stage input."""
    pos = create_fov(tmp_path / "bf.zarr", shape=(1, 1, 8, 16, 16), dtype="float32",
                     channel_names=["BF"], zyx_scale=(0.25, 0.116, 0.116))
    vol = np.random.default_rng(42).random((8, 16, 16), dtype=np.float32) * 100
    pos.write((0, 0), vol)
    settings = ReconstructSettings(
        phase=PhaseSettings(transfer_function={"yx_pixel_size": 0.116, "z_pixel_size": 0.25}))
    summary = reconstruct_store(tmp_path / "bf.zarr", tmp_path / "out.zarr", settings,
                                device="cpu")
    assert summary["volumes"] == 1
    out = open_ngff(tmp_path / "out.zarr").position().volume(0, 0)
    ref = np.asarray(jphase.reconstruct_phase(vol, settings.phase))
    assert np.isfinite(out).all() and _rel(out, ref) <= JAX_RTOL


def test_phase_verb_end_to_end(tmp_path):
    """tests/test_cli.py:379 on the port's CLI: the verb recovers the
    simulated weak phase object from an OME-Zarr store."""
    shape = (12, 32, 32)
    tfs = TF_SETTINGS.model_copy(update={"z_pixel_size": 0.25})
    tf = tphase.compute_transfer_function(shape, tfs)
    phi = gaussian_blob(shape, (6.0, 16.0, 16.0), (2.0, 3.0, 3.0), amplitude=0.1)
    phi -= phi.mean()
    stack = tphase.simulate_defocus_stack(phi, tf, background=1.0)
    pos = create_fov(tmp_path / "bf.zarr", shape=(1, 1, *shape), dtype="float32",
                     channel_names=["BF"], zyx_scale=(0.25, 0.116, 0.116))
    pos.write((0, 0), stack)
    cfg = tmp_path / "phase.yml"
    cfg.write_text("transfer_function:\n  z_padding: 0\n"
                   "apply_inverse:\n  regularization_strength: 1.0e-4\n")
    result = CliRunner().invoke(cli, ["phase", str(tmp_path / "bf.zarr"), "-o",
                                      str(tmp_path / "out.zarr"), "--config", str(cfg),
                                      "--device", "cpu"])
    assert result.exit_code == 0, result.output
    recon = np.asarray(open_ngff(tmp_path / "out.zarr").position().volume(0, 0))
    assert np.corrcoef(recon.ravel(), phi.ravel())[0, 1] > 0.8
