"""PyTorch port: Biggs-Andrews accelerated RL against the JAX package (CPU).

The shared outer loop (``ops/rl_outer.py``) against JAX ``run_rl_outer``
on an elementwise contractive step; the in-kernel form on the ``fused``
backend (plain versions of ``ratio_accel``/``mult_accel``) against JAX
``richardson_lucy(separable_backend="fused", acceleration="biggs")``
(Pallas interpret mode) and against the port's generic loop. In-kernel
and generic Biggs round the gradient differently and may flip an eps
clamp at isolated voxels, so they meet the two-tier gate of
``tests/test_rl_fused.py:244-245``: 99.99 % of voxels within 5e-4 of the
scale, every voxel within 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shrimpy_tpu.config import DeconvolveSettings
from shrimpy_tpu.ops import deconv as jdeconv
from shrimpy_tpu.ops.rl_outer import run_rl_outer as jax_run_rl_outer
from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.ops import deconv as tdeconv
from shrimpy_tpu_torch.ops.rl_fused import (
    Stencil,
    crop_grid,
    half_step,
    half_step_plain,
    start_on_grid,
)
from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer
from tests.test_deconv_separable import asymmetric_psf
from tests.test_torch_rl import _blurred

# One intra-op thread: the suite runs one process per core, and torch's
# default of a thread per core in each of them oversubscribes the cores.
torch.set_num_threads(1)

PSF = jdeconv.gaussian_psf((5, 9, 9), (1.0, 1.6, 1.6))


def _two_tier(out, ref) -> None:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    diff = np.abs(out - ref)
    assert np.mean(diff <= 5e-4 * scale) >= 0.9999
    assert float(diff.max()) <= 2e-2 * scale


def _contractive(b):
    """``x -> 2xb / (x + b)`` as ``x * (b / (0.5x + 0.5b))``: fixed point
    b, contraction 0.5 there; only correctly rounded operations."""
    return lambda x: x * (b / (0.5 * x + 0.5 * b))


def _outer_pair(n, accelerated=True):
    """(port x_n, JAX x_n) on the contractive step."""
    rng = np.random.default_rng(0)
    b = (rng.random((4, 8, 16)) * 10 + 0.5).astype(np.float32)
    x0 = (rng.random((4, 8, 16)) * 10 + 0.5).astype(np.float32)
    jstep = _contractive(jnp.asarray(b))
    ref = np.asarray(jax_run_rl_outer([(lambda e, _: (jstep(e), None), n)],
                                      jnp.asarray(x0), accelerated))
    ours = run_rl_outer([(_contractive(torch.from_numpy(b)), n)], torch.from_numpy(x0),
                        accelerated)
    return ours.numpy(), ref


@pytest.mark.parametrize("n", [1, 2, 6])
def test_run_rl_outer_matches_jax(n):
    """Accelerated runs within 1e-6 of JAX; the bf16 step
    ``dx = bf16(x_n - x_{n-1})`` bit-equal to JAX's wherever both
    packages' x_n and x_{n-1} are (each from its n and n-1 runs)."""
    x, ref = _outer_pair(n)
    assert x.dtype == np.float32
    err = float(np.abs(x - ref).max() / np.abs(ref).max())
    assert err <= 1e-6, f"rel err {err:.2e}"
    x_prev, ref_prev = _outer_pair(n - 1)
    dx = (torch.from_numpy(x) - torch.from_numpy(x_prev)).to(torch.bfloat16).float().numpy()
    jdx = np.asarray((jnp.asarray(ref) - jnp.asarray(ref_prev)).astype(jnp.bfloat16))
    same = (x == ref) & (x_prev == ref_prev)
    assert same.mean() >= 0.5
    np.testing.assert_array_equal(dx[same], jdx.astype(np.float32)[same])
    if n <= 2:  # the alpha-0 startup: plain RL bit for bit
        plain, _ = _outer_pair(n, accelerated=False)
        np.testing.assert_array_equal(x, plain)


def _blurred_img(shape, seed=1):
    return _blurred(shape, PSF, seed=seed)


@pytest.mark.parametrize("backend", ["fused", "linear_pallas"])
@pytest.mark.parametrize("iterations", [1, 2])
def test_biggs_startup_equals_plain_rl(backend, iterations):
    img = _blurred_img((10, 40, 44))
    s = deconvolve_settings(iterations=iterations, separable_backend=backend)
    plain = tdeconv.richardson_lucy(img, PSF, s, device="cpu")
    s.acceleration = "biggs"
    accel = tdeconv.richardson_lucy(img, PSF, s, device="cpu")
    torch.testing.assert_close(accel, plain, rtol=1e-6, atol=1e-5)


def test_fused_biggs_matches_jax_fused_biggs():
    """Port fused Biggs-6 against JAX's in-kernel Biggs (Pallas interpret)
    at tests/test_rl_fused.py's SHAPE, JAX's planned terms fed to both."""
    shape = (12, 280, 650)
    img = _blurred_img(shape, seed=2)
    s = DeconvolveSettings(algorithm="separable", separable_backend="fused", iterations=6,
                           acceleration="biggs")
    psf_w = jdeconv._pad_psf_to_odd(jdeconv._crop_psf_support(PSF, s.psf_crop_tol))
    terms = jdeconv.plan_separable_terms(psf_w, s)
    ref = np.asarray(jdeconv.richardson_lucy(img, PSF, s))
    ours = tdeconv.richardson_lucy(img, PSF, s, terms=terms, device="cpu").numpy()
    _two_tier(ours, ref)
    # Acceleration moved the result: the gate is not met by plain RL-6.
    plain = tdeconv.richardson_lucy(img, PSF, s.model_copy(update={"acceleration": "none"}),
                                    terms=terms, device="cpu").numpy()
    assert np.abs(plain - ref).max() > 1e-3 * np.abs(ref).max()


def _generic_fused(img, psf, settings, iterations):
    """Biggs through the generic loop on the fused backend's plain step."""
    psf_w = tdeconv.prepare_psf(psf, settings)
    terms = tdeconv.plan_terms(psf_w, settings)
    eps = settings.epsilon
    conv, adj, data, est = start_on_grid(torch.from_numpy(img), psf_w, terms, settings,
                                         torch.float32)

    def step(v):
        return half_step(half_step(v, data, conv, "ratio", eps), v, adj, "mult", eps)

    return crop_grid(run_rl_outer([(step, iterations)], est, True), img.shape, conv.radii)


@pytest.mark.parametrize("psf_name", ["gaussian", "asymmetric"])
def test_in_kernel_biggs_matches_generic_loop(psf_name):
    psf = PSF if psf_name == "gaussian" else asymmetric_psf((5, 9, 9))
    img = _blurred((12, 60, 70), psf, seed=3)
    s = deconvolve_settings(iterations=8, acceleration="biggs")
    fused = tdeconv.richardson_lucy(img, psf, s, device="cpu")
    generic = _generic_fused(img, psf, s, 8)
    _two_tier(fused.numpy(), generic.numpy())
    # The float64 plain run keeps the bf16 state: the same algorithm.
    f64 = tdeconv.richardson_lucy(img, psf, s, plain=True, dtype=torch.float64, device="cpu")
    _two_tier(fused.numpy(), f64.numpy())


def test_biggs_advances_the_rl_trajectory_faster():
    """Port, CPU (mirrors tests/test_deconv.py:317-354 on the separable
    path): accel-10 is further along the plain trajectory than plain-15,
    measured as distance to plain-40."""
    psf = asymmetric_psf((7, 9, 9))
    img = _blurred((16, 40, 40), psf, seed=4)

    def run(iters, acceleration="none"):
        s = deconvolve_settings(iterations=iters, acceleration=acceleration)
        return tdeconv.richardson_lucy(img, psf, s, plain=True, dtype=torch.float64, device="cpu").numpy()

    ref = run(40)

    def dist(out):
        return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))

    d_accel = dist(run(10, "biggs"))
    assert d_accel < dist(run(10)), "acceleration made no progress"
    assert d_accel <= dist(run(15)), f"accel-10 at {d_accel:.4f} did not reach plain-15"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mult_accel_plain_outputs_and_sums(dtype):
    """``mult_accel``'s plain outputs against their definitions; its
    sums against float64 sums of the bf16 g and g_prev (1e-6)."""
    rng = np.random.default_rng(5)
    shape = (9, 31, 27)
    terms = jdeconv.separable_decompose(asymmetric_psf((5, 9, 9)) / asymmetric_psf((5, 9, 9)).sum())
    adj = Stencil(terms, flip=True)
    ratio = torch.from_numpy(rng.random(shape) * 2 + 0.5).to(dtype)
    x = torch.from_numpy(rng.random(shape) * 5).to(dtype)
    dx = torch.from_numpy(rng.uniform(-1, 1, shape)).to(torch.bfloat16)
    gp = torch.from_numpy(rng.uniform(-1, 1, shape)).to(torch.bfloat16)
    alpha = torch.tensor(0.6)
    x_new, dx_new, g, num, den = half_step_plain(ratio, x, adj, "mult_accel",
                                                 dx=dx, g_prev=gp, alpha=alpha)
    y = torch.clamp_min(x + alpha * dx.to(dtype), 0.0)
    torch.testing.assert_close(x_new, y * half_step_plain(ratio, None, adj, "plain"),
                               rtol=1e-6, atol=0)
    assert dx_new.dtype == g.dtype == torch.bfloat16 and x_new.dtype == dtype
    torch.testing.assert_close(dx_new, (x_new - x).to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(g, (x_new - y).to(torch.bfloat16), rtol=0, atol=0)
    g64, gp64 = g.double(), gp.double()
    for got, want in ((num, (g64 * gp64).sum()), (den, (g64 * g64).sum())):
        assert abs(float(got) - float(want)) <= 1e-6 * float((g64 * g64).sum())
    # ratio_accel convolves the extrapolated point.
    data = torch.from_numpy(rng.random(shape) * 5).to(dtype)
    conv = Stencil(terms)
    torch.testing.assert_close(
        half_step_plain(x, data, conv, "ratio_accel", dx=dx, alpha=alpha),
        half_step_plain(y, data, conv, "ratio"), rtol=0, atol=0)
