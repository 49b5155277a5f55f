"""PyTorch port: affine apply, the registration estimate, the registered
reconstruct step and the ``register`` verb, against the JAX package (CPU).

Tolerances:

* the plain warp against each of JAX's four ``affine_apply`` tiers and
  against scipy: ``max|a-b| <= 1e-4 max|ref|``, the bar of JAX's own tier
  tests (``tests/test_register.py:70,239``), float32 sums of the same
  corners;
* the gradient of the weighted-NCC objective against ``jax.grad``: rtol
  1e-3 of the largest entry (float32 sums over the grid in another order);
  the loss within 1e-5; the same of the refine's plain objective
  (``refine_objective_plain``: closed-form ``d loss / d warp`` from float64
  sums) for ``ncc`` and ``mse``, the loss within 1e-5 of max(1, |loss|)
  (an mse loss is the data's scale squared); that objective in float64 against torch
  autograd of the warp and the loss in float64: 1e-9 of the largest entry;
* refine parameters after 1 and 5 Adam steps: 1e-5 (``torch.optim.Adam``
  and ``optax.adam`` are one update in exact arithmetic, rounded
  differently); with the defaults both packages recover the truth within
  ``tests/test_register.py``'s tolerances;
* the registered step against JAX's: 1e-4 of max|ref|, as the slice's
  other step tests.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.config import (
    DeconvolveSettings,
    DeskewSettings,
    ReconstructSettings,
    RegistrationSettings,
)
from shrimpy_tpu.io.ngff import create_fov
from shrimpy_tpu.io.synthetic import gaussian_blob
from shrimpy_tpu.ops import register as jr
from shrimpy_tpu.parallel.pipeline import reconstruct_batch as jax_reconstruct_batch
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.ops import register as tr
from shrimpy_tpu_torch.ops.deconv import gaussian_psf
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step, output_shape

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

WARP_RTOL = 1e-4
GRAD_RTOL = 1e-3
PARAM_ATOL = 1e-5
STEP_RTOL = 1e-4


def _rotation_zyx(axis: int, deg: float) -> np.ndarray:
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(3)
    i, j = [a for a in range(3) if a != axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def jax_tier(matrix, offset, in_shape, out_shape) -> str:
    """Which of JAX's ``affine_apply`` tiers a concrete map takes
    (``shrimpy_tpu/ops/register.py:495-555``)."""
    if np.array_equal(np.asarray(matrix), np.eye(3, dtype=np.float32)):
        return "translate"
    if jr.triangular_kind(matrix) is not None:
        work = tuple(max(s, o) for s, o in zip(in_shape, out_shape))
        bounds = [jr._axis_shift_bounds(matrix, offset, a, work) for a in range(3)]
        if all(hi + 2 - lo <= jr._MAX_ROLLS_PER_AXIS for lo, hi in bounds):
            return "triangular"
    if jr._blocked_plan(matrix, offset, in_shape, out_shape) is not None:
        return "blocked"
    return "gather"


IN_SHAPE = (10, 40, 36)
LOWER = np.array([[1.003, 0.0, 0.0], [0.012, 0.997, 0.0], [-0.018, 0.015, 1.002]])
MAPS = {
    "translate": (np.eye(3), [0.4, -3.2, 2.6]),
    "triangular": (LOWER, [0.4, -3.2, 2.6]),
    "triangular_upper": (LOWER.T.copy(), [-1.3, 2.2, 0.7]),
    "blocked": (_rotation_zyx(0, 2.0) @ np.diag([1.04, 0.97, 1.02]), [1.7, -2.3, 0.9]),
    "gather": (_rotation_zyx(0, 30.0), [0.0, 12.0, -6.0]),
}


@pytest.mark.parametrize("out_shape", [IN_SHAPE, (13, 31, 44)])
@pytest.mark.parametrize("name", list(MAPS))
def test_plain_warp_matches_each_jax_tier_and_scipy(name, out_shape):
    matrix, offset = (np.asarray(v, np.float32) for v in MAPS[name])
    assert jax_tier(matrix, offset, IN_SHAPE, out_shape) == name.split("_")[0]
    vol = (np.random.default_rng(1).random(IN_SHAPE) * 50).astype(np.float32)
    ref = np.asarray(jr.affine_apply(vol, matrix, offset, out_shape))
    got = tr.affine_apply(vol, matrix, offset, out_shape, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == out_shape
    assert np.abs(got.numpy() - ref).max() <= WARP_RTOL * np.abs(ref).max()
    oracle = tr.affine_apply_reference_scipy(vol, matrix, offset, out_shape)
    np.testing.assert_array_equal(oracle, jr.affine_apply_reference_scipy(
        vol, matrix, offset, out_shape))
    assert np.abs(got.numpy() - oracle).max() <= WARP_RTOL * np.abs(oracle).max()
    f64 = tr.affine_apply_plain(torch.from_numpy(vol), matrix, offset, out_shape,
                                dtype=torch.float64)
    assert f64.dtype == torch.float64
    assert np.abs(f64.numpy() - oracle).max() <= 1e-6 * np.abs(oracle).max()


def test_plain_warp_chunks_give_the_same_bits(monkeypatch):
    vol = torch.from_numpy((np.random.default_rng(2).random((9, 20, 24)) * 10).astype(np.float32))
    m, t = MAPS["blocked"]
    whole = tr.affine_apply_plain(vol, m, t, (11, 20, 24))
    for chunk in (1, 480, 481, 5000):
        monkeypatch.setattr(tr, "PLAIN_CHUNK_VOXELS", chunk)
        torch.testing.assert_close(tr.affine_apply_plain(vol, m, t, (11, 20, 24)), whole,
                                   rtol=0, atol=0)


def _objective_data(down=2):
    """moving, and fixed on the refine's y/x strided grid."""
    rng = np.random.default_rng(5)
    shape = (8, 24, 20)
    fixed = gaussian_blob(shape, (4.0, 11.0, 9.0), (2.0, 4.0, 3.5), 100.0) + rng.normal(
        0, 1.0, shape).astype(np.float32)
    moving = gaussian_blob(shape, (4.6, 9.3, 10.8), (2.1, 4.2, 3.4), 100.0) + rng.normal(
        0, 1.0, shape).astype(np.float32)
    return moving, np.ascontiguousarray(fixed[:, ::down, ::down])


def _objective_pair(down=2, loss="ncc"):
    """The refine's objective, weighted ``loss`` over the support mask, as a
    function of (matrix, offset) in both packages (torch: autograd of the
    plain warp, in the dtype of the map)."""
    moving, fixed_s = _objective_data(down)
    out_shape = fixed_s.shape

    def jax_obj(matrix, offset):
        warped = jr._affine_apply_jit(jnp.asarray(moving), matrix, offset, out_shape)
        support = jr._affine_apply_jit(jnp.ones_like(jnp.asarray(moving)), matrix, offset,
                                       out_shape)
        w = jax.lax.stop_gradient((support > 0.999).astype(jnp.float32))
        return (jr.ncc_loss if loss == "ncc" else jr.mse_loss)(warped, jnp.asarray(fixed_s), w)

    def torch_obj(matrix, offset):
        dtype = matrix.dtype
        vol = torch.from_numpy(moving)
        warped = tr.affine_apply_plain(vol, matrix, offset, out_shape, dtype=dtype)
        with torch.no_grad():
            support = tr.affine_apply_plain(torch.ones_like(vol), matrix, offset, out_shape,
                                            dtype=dtype)
        w = (support > 0.999).to(dtype)
        return (tr.ncc_loss if loss == "ncc" else tr.mse_loss)(
            warped, torch.from_numpy(fixed_s).to(dtype), w)

    return jax_obj, torch_obj


def _refine_map(name):
    m, t = (np.asarray(v, np.float32) for v in MAPS[name])
    return m @ np.diag([1.0, 2.0, 2.0]).astype(np.float32), t * np.float32(0.3)


@pytest.mark.parametrize("name", ["triangular", "blocked", "gather"])
def test_plain_gradient_matches_jax_grad(name):
    jax_obj, torch_obj = _objective_pair()
    m, t = _refine_map(name)  # the strided grid's scale
    jl, (jgm, jgt) = jax.value_and_grad(jax_obj, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(t))
    mt = torch.tensor(m, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    loss = torch_obj(mt, tt)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    want = np.concatenate([np.asarray(jgm).ravel(), np.asarray(jgt)])
    got = np.concatenate([mt.grad.numpy().ravel(), tt.grad.numpy()])
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max(), (got, want)


@pytest.mark.parametrize("loss", ["ncc", "mse"])
@pytest.mark.parametrize("name", ["triangular", "blocked", "gather"])
def test_plain_objective_matches_jax_value_and_grad(name, loss):
    """The refine's plain objective (the kernels' plain version) against
    jax.value_and_grad of JAX's objective."""
    jax_obj, _ = _objective_pair(loss=loss)
    moving, fixed_s = _objective_data()
    m, t = _refine_map(name)
    jl, (jgm, jgt) = jax.value_and_grad(jax_obj, argnums=(0, 1))(jnp.asarray(m), jnp.asarray(t))
    value, dm, dt = tr.refine_objective_plain(torch.from_numpy(moving), torch.from_numpy(fixed_s),
                                              m, t, loss)
    assert value.dtype == dm.dtype == dt.dtype == torch.float32
    assert abs(float(value) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
    want = np.concatenate([np.asarray(jgm).ravel(), np.asarray(jgt)])
    got = np.concatenate([dm.numpy().ravel(), dt.numpy()])
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max(), (got, want)
    no_grad = tr.refine_objective_plain(torch.from_numpy(moving), torch.from_numpy(fixed_s),
                                        m, t, loss, grad=False)
    assert no_grad[1] is None and no_grad[2] is None and torch.equal(no_grad[0], value)


@pytest.mark.parametrize("loss", ["ncc", "mse"])
@pytest.mark.parametrize("name", ["triangular", "blocked", "gather"])
def test_plain_objective_matches_autograd_of_the_plain_path(name, loss):
    """The closed-form derivative of the loss by the warp against torch
    autograd through ncc_loss / mse_loss, both in float64."""
    _, torch_obj = _objective_pair(loss=loss)
    moving, fixed_s = _objective_data()
    m, t = (v.astype(np.float64) for v in _refine_map(name))
    mt = torch.tensor(m, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    want_value = torch_obj(mt, tt)
    want_value.backward()
    value, dm, dt = tr.refine_objective_plain(torch.from_numpy(moving), torch.from_numpy(fixed_s),
                                              m, t, loss, dtype=torch.float64)
    assert abs(float(value) - float(want_value.detach())) <= 1e-12
    want = torch.cat([mt.grad.reshape(9), tt.grad])
    got = torch.cat([dm.reshape(9), dt])
    assert float((got - want).abs().max()) <= 1e-9 * float(want.abs().max()), (got, want)


def test_refine_objective_function_hands_back_its_gradient():
    """RefineObjective: the loss of the pair, and its gradient through the
    map's parameters (tril and the grid's scale) by autograd."""
    moving, fixed_s = _objective_data()
    vol, fixed = torch.from_numpy(moving), torch.from_numpy(fixed_s)
    m, t = _refine_map("triangular")

    def pair(mm, tt):
        return tr.refine_objective_plain(vol, fixed, mm, tt, "ncc")

    dm = torch.zeros((3, 3), requires_grad=True)
    off = torch.tensor(t, requires_grad=True)
    scale = torch.from_numpy(m)
    value = tr.RefineObjective.apply(scale + torch.tril(dm) / 24.0, off, pair)
    value.backward()
    want_value, want_m, want_t = pair(scale, torch.from_numpy(t))
    assert torch.equal(value.detach(), want_value)
    torch.testing.assert_close(dm.grad, torch.tril(want_m) / 24.0, rtol=0, atol=0)
    torch.testing.assert_close(off.grad, want_t, rtol=0, atol=0)


def _scene(center, shape=(16, 32, 32)):
    vol = gaussian_blob(shape, center, (2.0, 3.0, 3.0), amplitude=100.0)
    vol += gaussian_blob(shape, (center[0] - 3, center[1] + 6, center[2] - 5), (1.5, 2.0, 2.0),
                         amplitude=60.0)
    return vol


def _affine_pair():
    """tests/test_register.py::test_refine_improves_on_seed's pair."""
    shape = (16, 32, 32)
    moving = gaussian_blob(shape, (9.5, 14.0, 21.0), (2.2, 3.3, 3.3), amplitude=100.0)
    moving += gaussian_blob(shape, (6.2, 20.6, 15.5), (1.6, 2.2, 2.2), amplitude=60.0)
    return _scene((8.0, 16.0, 18.0)), moving


@pytest.mark.parametrize("iterations", [1, 5])
@pytest.mark.parametrize("loss,param", [("ncc", "triangular"), ("mse", "full")])
def test_refine_steps_match_jax(iterations, loss, param):
    fixed, moving = _affine_pair()
    kw = dict(method="pcc+refine", refine_iterations=iterations, loss=loss,
              parameterization=param, learning_rate=0.02)
    want = jr.estimate_registration(fixed, moving, RegistrationSettings(**kw))
    got = tr.estimate_registration(fixed, moving, tconfig.registration_settings(**kw),
                                   device="cpu")
    np.testing.assert_allclose(got.translation_seed, want.translation_seed, atol=1e-4)
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got.offset, want.offset, rtol=0, atol=PARAM_ATOL)
    assert abs(got.final_loss - want.final_loss) <= 1e-5
    assert got.matrix.dtype == np.float32 and got.offset.dtype == np.float32
    if param == "triangular":
        assert np.all(got.matrix[np.triu_indices(3, 1)] == 0.0)
    else:
        assert np.any(got.matrix[np.triu_indices(3, 1)] != 0.0)


def test_defaults_recover_the_truth_in_both_packages():
    """bench.py's registration scene at a test size: twelve blobs and
    noise, moving = fixed translated by a known fractional shift; the
    defaults (pcc+refine, NCC, triangular, stride 4, 100 steps)."""
    shape = (16, 64, 64)
    rng = np.random.default_rng(1)
    fixed = sum(gaussian_blob(shape, tuple(rng.uniform(4, s - 4) for s in shape),
                              (2.0, 4.0, 4.0), amplitude=100.0) for _ in range(12))
    fixed = (fixed + rng.normal(0, 0.5, shape)).astype(np.float32)
    true_shift = np.array([1.6, -4.3, 2.1], np.float32)
    moving = tr.affine_apply_reference_scipy(fixed, np.eye(3), true_shift)
    want = jr.estimate_registration(fixed, moving, RegistrationSettings())
    got = tr.estimate_registration(fixed, moving, device="cpu")
    for res in (want, got):
        np.testing.assert_allclose(res.offset, -true_shift, atol=0.3)
        np.testing.assert_allclose(np.diag(res.matrix), 1.0, atol=0.02)
    np.testing.assert_allclose(got.matrix, want.matrix, atol=1e-4)
    np.testing.assert_allclose(got.offset, want.offset, atol=1e-3)


def test_pcc_method_equals_jax():
    fixed = _scene((8.0, 16.0, 18.0))
    moving = _scene((9.0, 13.0, 22.0))  # displaced by (+1, -3, +4)
    want = jr.estimate_registration(fixed, moving, RegistrationSettings(method="pcc"))
    got = tr.estimate_registration(fixed, moving, tconfig.registration_settings(method="pcc"),
                                   device="cpu")
    assert got.final_loss is None and want.final_loss is None
    np.testing.assert_array_equal(got.matrix, np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(got.offset, want.offset, atol=1e-4)
    np.testing.assert_allclose(got.translation_seed, [1.0, -3.0, 4.0], atol=0.5)
    warped = tr.affine_apply(moving, got.matrix, got.offset, device="cpu")
    assert float(tr.ncc_loss(warped, torch.from_numpy(fixed))) < 0.05


def test_divergence_falls_back_to_the_seed_as_jax(caplog):
    """A learning rate far past the basin makes the refine worse: both
    packages keep the PCC translation, with the seed's loss, loudly."""
    fixed, moving = _affine_pair()
    kw = dict(refine_iterations=5, learning_rate=40.0)
    want = jr.estimate_registration(fixed, moving, RegistrationSettings(**kw))
    # caplog's handler on the module's logger too: a CLI or an acquisition
    # run earlier in the process (configure_logging) stops the package's
    # records from reaching the root logger.
    reg_logger = logging.getLogger("shrimpy_tpu_torch.ops.register")
    reg_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="shrimpy_tpu_torch.ops.register"):
            got = tr.estimate_registration(fixed, moving, tconfig.registration_settings(**kw),
                                           device="cpu")
    finally:
        reg_logger.removeHandler(caplog.handler)
    assert "diverged" in caplog.text
    np.testing.assert_array_equal(want.matrix, np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got.matrix, np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got.offset, got.translation_seed)
    np.testing.assert_allclose(got.offset, want.offset, atol=1e-4)
    assert abs(got.final_loss - want.final_loss) <= 1e-5


def test_rolled_noise_keeps_the_basin_or_falls_back():
    """tests/test_register.py::test_refine_divergence_falls_back_to_seed on
    the port."""
    rng = np.random.default_rng(0)
    base = (rng.random((16, 64, 64), dtype=np.float32) * 100).astype(np.float32)
    mov = np.roll(base, (1, 3, -2), (0, 1, 2))
    res = tr.estimate_registration(base, mov, device="cpu")
    np.testing.assert_allclose(res.offset, [1.0, 3.0, -2.0], atol=0.2)
    np.testing.assert_allclose(np.diag(res.matrix), 1.0, atol=0.05)


def test_numpy_input_without_device_asks_for_the_card(monkeypatch):
    """As the other entry points: a host array with no ``device`` goes to
    the card, so without one it raises; a CPU tensor stays on the CPU."""
    from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixed, moving = _affine_pair()
    calls = {
        "affine_apply": lambda a, b: tr.affine_apply(a, *MAPS["triangular"]),
        "phase_cross_correlation": phase_cross_correlation,
        "estimate_registration": lambda a, b: tr.estimate_registration(
            a, b, tconfig.registration_settings(method="pcc")),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\)"):
            call(fixed, moving)
        call(torch.from_numpy(fixed), torch.from_numpy(moving))
    assert tr.affine_apply(torch.from_numpy(fixed), *MAPS["triangular"]).device.type == "cpu"


def test_registration_settings_carry_schema_defaults():
    ns, model = tconfig.registration_settings(), RegistrationSettings()
    assert set(tconfig.REGISTRATION_DEFAULTS) == set(RegistrationSettings.model_fields)
    for field in tconfig.REGISTRATION_DEFAULTS:
        assert getattr(ns, field) == getattr(model, field), field
    with pytest.raises(TypeError, match="unknown"):
        tconfig.registration_settings(iterations=3)


def _transform_json(tmp_path, matrix, offset) -> str:
    path = tmp_path / "transform.json"
    path.write_text(json.dumps({"matrix_zyx": np.asarray(matrix, np.float32).tolist(),
                                "offset_zyx": np.asarray(offset, np.float32).tolist()}))
    return str(path)


@pytest.mark.parametrize("name", ["translate", "triangular", "blocked"])
def test_registered_step_equals_jax(tmp_path, name):
    """deskew -> affine apply -> RL-2 (``matmul``, JAX's CPU choice) in
    both packages from the same transform JSON."""
    raw_shape = (40, 24, 20)
    settings = ReconstructSettings(
        deskew=DeskewSettings(px_to_scan_ratio=0.386),
        registration=RegistrationSettings(transform_path=_transform_json(tmp_path, *MAPS[name])),
        deconvolve=DeconvolveSettings(separable_backend="matmul", iterations=2),
    )
    psf = gaussian_psf((5, 7, 7), (1.0, 1.5, 1.5))
    raw = (np.random.default_rng(3).random((1, *raw_shape)) * 100).astype(np.float32)
    ref = np.asarray(jax_reconstruct_batch(jnp.asarray(raw), settings, psf=psf))
    ours = build_reconstruct_step(settings, psf=psf, device="cpu")(raw)
    assert tuple(ours.shape) == ref.shape == (1, *output_shape(raw_shape, settings))
    assert np.abs(ours.numpy() - ref).max() <= STEP_RTOL * np.abs(ref).max()
    # Without a transform the registration settings add no stage.
    bare = settings.model_copy(update={"registration": RegistrationSettings()})
    plain = build_reconstruct_step(bare, psf=psf, device="cpu")(raw)
    no_reg = build_reconstruct_step(settings.model_copy(update={"registration": None}),
                                    psf=psf, device="cpu")(raw)
    torch.testing.assert_close(plain, no_reg, rtol=0, atol=0)
    # The float64 plain step holds the float32 one within 1e-3.
    f64 = build_reconstruct_step(settings, psf=psf, device="cpu", plain=True,
                                 dtype=torch.float64)(raw)
    assert f64.dtype == torch.float64
    assert float((ours.double() - f64).abs().max()) <= 1e-3 * float(f64.abs().max())


def _two_channel_store(path, fixed, moving):
    pos = create_fov(path, shape=(1, 2, *fixed.shape), dtype="float32",
                     channel_names=["phase", "gfp"])
    pos.write((0, 0), fixed)
    pos.write((0, 1), moving)


@pytest.mark.parametrize("method", ["pcc", "pcc+refine"])
def test_register_verb_writes_jax_s_keys_and_values(tmp_path, monkeypatch, method):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    fixed, moving = _affine_pair()
    _two_channel_store(tmp_path / "two.zarr", fixed, moving)
    outs = {}
    for name, verb_cli, extra in (("jax", jax_cli, []), ("torch", cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        result = CliRunner().invoke(verb_cli, [
            "register", str(tmp_path / "two.zarr"), "--fixed-channel", "phase",
            "--moving-channel", "gfp", "--method", method, "-o", str(out), *extra])
        assert result.exit_code == 0, result.output
        outs[name] = json.loads(out.read_text())
    want, got = outs["jax"], outs["torch"]
    assert list(got) == list(want)
    for key in ("matrix_zyx", "offset_zyx", "translation_seed_zyx"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-4)
    if method == "pcc":
        assert got["final_loss"] is None and want["final_loss"] is None
    else:
        assert abs(got["final_loss"] - want["final_loss"]) <= 1e-5
    assert (got["fixed_channel"], got["moving_channel"]) == ("phase", "gfp")


def test_register_verb_across_stores_and_into_either_reconstruct(tmp_path, monkeypatch):
    """tests/test_cli.py::test_register_across_stores on the port's verb;
    its JSON drives the JAX step and the port's alike."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    fixed = gaussian_blob((12, 32, 32), (6.0, 16.0, 16.0), (2.0, 3.0, 3.0))
    moving = gaussian_blob((12, 40, 28), (7.0, 18.0, 17.0), (2.0, 3.0, 3.0))
    create_fov(tmp_path / "lf.zarr", shape=(1, 1, 12, 32, 32), dtype="float32",
               channel_names=["phase"]).write((0, 0), fixed)
    create_fov(tmp_path / "ls.zarr", shape=(1, 1, 12, 40, 28), dtype="float32",
               channel_names=["gfp"]).write((0, 0), moving)
    outs = {}
    for name, verb_cli, extra in (("jax", jax_cli, []), ("torch", cli, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        result = CliRunner().invoke(verb_cli, [
            "register", str(tmp_path / "lf.zarr"), "--fixed-channel", "phase",
            "--moving-channel", "gfp", "--moving-input", str(tmp_path / "ls.zarr"),
            "--method", "pcc", "-o", str(out), *extra])
        assert result.exit_code == 0, result.output
        outs[name] = out
    got = json.loads(outs["torch"].read_text())
    np.testing.assert_allclose(got["translation_seed_zyx"], [1.0, -2.0, 3.0], atol=0.5)
    np.testing.assert_allclose(got["offset_zyx"], json.loads(outs["jax"].read_text())[
        "offset_zyx"], atol=1e-4)
    raw = (np.random.default_rng(8).random((1, 12, 32, 32)) * 10).astype(np.float32)
    steps = {}
    for name, path in outs.items():
        s = ReconstructSettings(registration=RegistrationSettings(transform_path=str(path)))
        steps[name] = (np.asarray(jax_reconstruct_batch(jnp.asarray(raw), s)),
                       build_reconstruct_step(s, device="cpu")(raw).numpy())
    for jax_out, torch_out in steps.values():
        assert np.abs(torch_out - jax_out).max() <= STEP_RTOL * np.abs(jax_out).max()
    # A missing channel is a click error listing the store's names.
    result = CliRunner().invoke(cli, ["register", str(tmp_path / "lf.zarr"), "--fixed-channel",
                                      "dapi", "--moving-channel", "phase", "-o",
                                      str(tmp_path / "x.json"), "--device", "cpu"])
    assert result.exit_code != 0 and "not in the store" in result.output
