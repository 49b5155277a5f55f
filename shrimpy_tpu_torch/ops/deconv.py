"""Richardson-Lucy deconvolution, separable path (counterpart of the
slice's part of ``shrimpy_tpu/ops/deconv.py``).

The host numpy helpers — PSF support cropping and odd padding, the
separable decomposition with its denoise and extended-rank tiers, and
``gaussian_psf`` — are copies of the JAX module's (which imports jax at
the top; a GPU host running the port need not have jax).
``tests/test_torch_rl.py`` pins each
copy to its original.

Backend resolution (``settings.separable_backend``,
:func:`resolve_separable_backend`):

* ``fused`` runs :func:`shrimpy_tpu_torch.ops.rl_fused.rl_fused`, the
  zero-boundary RL on the half-PSF padded grid — the JAX package's
  choice on the TPU.
* ``fused_iter`` runs
  :func:`shrimpy_tpu_torch.ops.rl_fused_iter.rl_fused_iter`, the same RL
  with one kernel launch per iteration; outside that kernel's
  shared-memory bound it raises :class:`ValueError` naming the bound.
  ``auto`` never picks it: JAX's does only under the environment switch
  ``SHRIMPY_RL_FUSE_ITER=1``, which the port does not read.
* ``linear_pallas`` and ``zy_pallas`` run :func:`rl_conv3`, RL on the
  same G grid through the z+y step of
  :mod:`shrimpy_tpu_torch.ops.conv3_cuda` and the x pass, with zero
  (``_rl_sep_linear``) or circular (``_rl_sep_zy``) boundaries. The z+y
  step marches through z in one launch where its block fits and runs as
  two single-axis passes past that
  (:func:`~shrimpy_tpu_torch.ops.conv3_cuda.convzy_route`; past radius
  211 with its taps in chunks), so both take every z and y radius, as
  JAX's ``zy_pallas`` does (its ``linear_pallas`` takes ``rz <= 8``,
  ``ry <= 125``).
* ``matmul`` runs :func:`shrimpy_tpu_torch.ops.rl_matmul.rl_matmul`,
  circular RL on the block-rounded ``_sep_pads`` grid by matrix
  products (``_rl_sep_jit``).
* ``auto`` resolves from the geometry alone, the same on every device:
  ``fused`` where its kernels' bounds take the radii, otherwise
  ``matmul``, which has none (JAX's fall-through order on the
  TPU, ``deconv.py:1128-1166``). JAX's ``auto`` off the TPU is always
  ``matmul`` (``deconv.py:1107``): the two boundaries give different
  images near the edges, so compare each backend with its own oracle.
* ``acceleration: biggs`` runs everywhere: in the half-step kernels on
  ``fused``, through the generic loop
  :func:`shrimpy_tpu_torch.ops.rl_outer.run_rl_outer` on the others.
* ``donate_input: true`` lets :func:`richardson_lucy` consume the
  caller's tensor once the carries are built (it is left empty; the
  result is bitwise that of the non-donating run). The pipeline step
  does not read it, as JAX's does not under a trace.
* The FFT/hybrid algorithms and ``fused_low_precision_iters > 0`` raise
  :class:`NotImplementedError` naming the ROADMAP item that ports them.
  None is silently ignored. ``matmul_precision`` chooses MXU dot passes on the
  TPU; the port's kernels are float32 FMA throughout, and its products
  are float32 with TF32 off (see :mod:`~shrimpy_tpu_torch.ops.rl_matmul`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.utils.device import as_tensor

logger = logging.getLogger(__name__)

_BACKENDS = ("auto", "fused", "fused_iter", "linear_pallas", "zy_pallas", "matmul")


def _separable_candidates(
    psf: np.ndarray, max_terms: int
) -> list[tuple[float, np.ndarray, np.ndarray, np.ndarray]]:
    """SVD-cascade separable candidates, strongest first: unfold Z vs
    YX, then split each YX mode."""
    psf = np.asarray(psf, dtype=np.float64)
    nz, ny, nx = psf.shape
    u, s, vt = np.linalg.svd(psf.reshape(nz, ny * nx), full_matrices=False)
    candidates: list[tuple[float, np.ndarray, np.ndarray, np.ndarray]] = []
    for r in range(min(len(s), max_terms)):
        if s[r] <= 0:
            break
        plane = vt[r].reshape(ny, nx)
        pu, ps, pvt = np.linalg.svd(plane, full_matrices=False)
        for q in range(min(len(ps), max_terms)):
            weight = s[r] * ps[q]
            if weight <= 0:
                break
            candidates.append((weight, u[:, r], pu[:, q] * ps[q] * s[r], pvt[q]))
    candidates.sort(key=lambda c: -c[0])
    return candidates


def separable_decompose(
    psf: np.ndarray, tol: float = 1e-4, max_terms: int = 6
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]] | None:
    """Greedy rank-K separable decomposition ``psf ~ sum_k wz_k x wy_k x wx_k``
    within relative Frobenius error ``tol``; None when ``max_terms``
    terms cannot reach it."""
    psf = np.asarray(psf, dtype=np.float64)
    candidates = _separable_candidates(psf, max_terms)
    norm = np.linalg.norm(psf)
    recon = np.zeros_like(psf)
    terms: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for _, wz, wy, wx in candidates[: max_terms * max_terms]:
        terms.append(
            (wz.astype(np.float32), wy.astype(np.float32), wx.astype(np.float32))
        )
        recon = recon + np.einsum("z,y,x->zyx", wz, wy, wx)
        if np.linalg.norm(psf - recon) / max(norm, 1e-30) <= tol:
            if len(terms) > max_terms:
                return None
            return terms
    return None


def separable_truncate(
    psf: np.ndarray,
    max_terms: int = 6,
    plateau_rtol: float | None = None,
    stop_below: float | None = None,
) -> tuple[list[tuple[np.ndarray, np.ndarray, np.ndarray]], float]:
    """Best-effort top-K separable truncation: ``(terms, rel_residual)``
    (the measured-PSF denoiser; see the JAX module)."""
    psf = np.asarray(psf, dtype=np.float64)
    candidates = _separable_candidates(psf, max_terms)[:max_terms]
    norm = np.linalg.norm(psf)
    recon = np.zeros_like(psf)
    terms: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    residual = 1.0
    for _, wz, wy, wx in candidates:
        new = recon + np.einsum("z,y,x->zyx", wz, wy, wx)
        new_residual = float(np.linalg.norm(psf - new) / max(norm, 1e-30))
        if (
            plateau_rtol is not None
            and terms
            and residual - new_residual < plateau_rtol * residual
            and (stop_below is None or residual <= stop_below)
        ):
            # Noise plateau: more rank past the knee models iid noise.
            break
        terms.append(
            (wz.astype(np.float32), wy.astype(np.float32), wx.astype(np.float32))
        )
        recon = new
        residual = new_residual
    return terms, residual


def plan_separable_terms(
    psf_np: np.ndarray, settings
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]] | None:
    """Resolve the separable term set for a PSF under ``settings``:
    strict decomposition within ``separable_tol``, then at extended rank,
    then (``psf_denoise != 'off'``) rank-K truncation accepted below
    ``psf_denoise_max_residual``; otherwise None (the FFT path)."""
    psf_unit = np.asarray(psf_np, np.float64)
    psf_unit = psf_unit / psf_unit.sum()
    terms = separable_decompose(
        psf_unit, tol=settings.separable_tol, max_terms=settings.max_separable_terms
    )
    if terms is not None:
        return terms
    extended = max(settings.max_extended_terms, settings.max_separable_terms)
    if extended > settings.max_separable_terms:
        terms = separable_decompose(
            psf_unit, tol=settings.separable_tol, max_terms=extended
        )
        if terms is not None:
            logger.warning(
                "PSF needs extended rank %d (> max_separable_terms=%d) to "
                "reach tol=%g; separable path, cost linear in the rank",
                len(terms), settings.max_separable_terms,
                settings.separable_tol,
            )
            return terms
    if settings.psf_denoise == "off":
        logger.warning(
            "PSF not separable within tol=%g and psf_denoise='off': it "
            "needs the FFT path",
            settings.separable_tol,
        )
        return None
    terms, residual = separable_truncate(
        psf_unit,
        max_terms=extended,
        plateau_rtol=0.08,
        stop_below=settings.psf_denoise_max_residual,
    )
    if residual <= settings.psf_denoise_max_residual:
        logger.warning(
            "PSF not strictly separable: denoised to rank-%d (discarded "
            "residual %.2e Frobenius, treated as measurement noise); "
            "deconvolving with the truncated PSF on the separable path",
            len(terms),
            residual,
        )
        return terms
    logger.warning(
        "PSF rank-%d residual %.2e exceeds psf_denoise_max_residual=%g "
        "(non-separable structure beyond extended rank): it needs the "
        "FFT path",
        len(terms),
        residual,
        settings.psf_denoise_max_residual,
    )
    return None


def _crop_psf_support(psf_np: np.ndarray, rel_tol: float) -> np.ndarray:
    """Trim near-zero border planes, preserving the ``k // 2`` centre
    (symmetric margins; magnitude threshold ``rel_tol * max|psf|``)."""
    if rel_tol <= 0:
        return psf_np
    mask = np.abs(psf_np) > rel_tol * float(np.abs(psf_np).max())
    slices = []
    for ax in range(psf_np.ndim):
        other = tuple(a for a in range(psf_np.ndim) if a != ax)
        hit = np.argwhere(mask.any(axis=other)).ravel()
        if hit.size == 0:
            return psf_np
        margin = min(int(hit.min()), psf_np.shape[ax] - 1 - int(hit.max()))
        slices.append(slice(margin, psf_np.shape[ax] - margin))
    return psf_np[tuple(slices)]


def _pad_psf_to_odd(psf_np: np.ndarray) -> np.ndarray:
    """Append a zero plane to even-length PSF axes, so ``taps[::-1]``
    around ``k // 2`` is the adjoint (the centre element is unchanged)."""
    pad = [(0, 1 - n % 2) for n in psf_np.shape]
    if not any(hi for _, hi in pad):
        return psf_np
    return np.pad(psf_np, pad)


def gaussian_psf(
    shape_zyx: tuple[int, int, int], sigma_zyx: tuple[float, float, float]
) -> np.ndarray:
    """Separable Gaussian PSF (unit sum), centered at ``shape//2``."""
    axes = []
    for n, sigma in zip(shape_zyx, sigma_zyx):
        u = np.arange(n, dtype=np.float64) - n // 2
        axes.append(np.exp(-0.5 * (u / sigma) ** 2))
    psf = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return (psf / psf.sum()).astype(np.float32)


def prepare_psf(psf, settings) -> np.ndarray:
    """The working PSF: float32, support-cropped, odd on every axis."""
    psf_np = np.asarray(psf, dtype=np.float32)
    return _pad_psf_to_odd(_crop_psf_support(psf_np, settings.psf_crop_tol))


def check_ported(settings) -> None:
    """Raise :class:`NotImplementedError` for deconvolution settings the
    port does not run yet (never silently ignored)."""
    if settings.acceleration not in ("none", "biggs"):
        raise ValueError(f"unknown acceleration {settings.acceleration!r}")
    if settings.algorithm in ("fft", "hybrid"):
        raise NotImplementedError(
            f"algorithm={settings.algorithm!r} is not ported yet: ROADMAP "
            "queue 1 item 8 (non-separable and hybrid RL)"
        )
    if settings.fused_low_precision_iters > 0:
        raise NotImplementedError(
            "fused_low_precision_iters > 0 (2-pass bf16 TPU dots) is not "
            "ported: the CUDA kernel is float32 FMA throughout (ROADMAP "
            "queue 1 item 2)"
        )
    _check_backend(settings.separable_backend)


def _check_backend(backend: str) -> None:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown separable_backend {backend!r}")


def resolve_separable_backend(backend: str, image_shape, psf_shape) -> str:
    """The backend that runs a (Z, Y, X) ``image_shape`` with a PSF of
    ``psf_shape``: ``auto`` -> ``fused`` where the half-step kernels take
    the G grid and radii (:func:`~shrimpy_tpu_torch.ops.rl_fused.fused_bound_error`),
    else ``matmul`` (never ``fused_iter``); the others as named. Geometry
    only, so a setting that runs on the CPU runs on the card."""
    from shrimpy_tpu_torch.ops.rl_fused import fused_bound_error

    _check_backend(backend)
    if backend != "auto":
        return backend
    radii = tuple(k // 2 for k in psf_shape)
    g_shape = tuple(n + 2 * r for n, r in zip(image_shape, radii))
    return "fused" if fused_bound_error(g_shape, radii) is None else "matmul"


def plan_terms(psf_np: np.ndarray, settings):
    """Separable terms of the working PSF under ``settings`` (the FFT
    fallback of a non-separable PSF is not ported: it raises)."""
    terms = plan_separable_terms(psf_np, settings)
    if terms is None:
        if settings.algorithm == "separable":
            raise ValueError(
                "PSF is not separable within separable_tol="
                f"{settings.separable_tol} (<= {settings.max_separable_terms} terms) "
                "and rank-truncation denoising would discard more than "
                f"psf_denoise_max_residual={settings.psf_denoise_max_residual}; "
                "use algorithm='fft' or raise the tolerance"
            )
        raise NotImplementedError(
            "the PSF is not separable and the FFT RL path is not ported "
            "yet: ROADMAP queue 1 item 8"
        )
    return terms


def rl_separable(image, psf_np, terms, settings, iterations: int, *,
                 plain: bool = False, dtype: torch.dtype = torch.float32,
                 donate: bool = False) -> torch.Tensor:
    """Separable-path RL: resolve the backend for this image and run it
    (the single dispatch point shared by :func:`richardson_lucy` and the
    pipeline). ``plain``/``dtype`` as in :func:`richardson_lucy`; the
    ``matmul`` backend has no kernel, so ``plain`` does not change it.
    ``donate`` lets the backend consume ``image`` once its carries are
    built."""
    backend = resolve_separable_backend(settings.separable_backend, tuple(image.shape),
                                        psf_np.shape)
    if backend == "matmul":
        from shrimpy_tpu_torch.ops.rl_matmul import rl_matmul

        return rl_matmul(image, psf_np, terms, settings, iterations, dtype=dtype, donate=donate)
    if backend == "fused_iter":
        from shrimpy_tpu_torch.ops.rl_fused_iter import rl_fused_iter

        return rl_fused_iter(image, psf_np, terms, settings, iterations, plain=plain,
                             dtype=dtype, donate=donate)
    if backend == "fused":
        from shrimpy_tpu_torch.ops.rl_fused import rl_fused

        return rl_fused(image, psf_np, terms, settings, iterations, plain=plain, dtype=dtype,
                        donate=donate)
    return rl_conv3(image, psf_np, terms, settings, iterations,
                    boundary="zero" if backend == "linear_pallas" else "circular",
                    plain=plain, dtype=dtype, donate=donate)


def rl_conv3(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
             boundary: str, plain: bool = False,
             dtype: torch.dtype = torch.float32, donate: bool = False) -> torch.Tensor:
    """``linear_pallas`` (``boundary="zero"``, counterpart of
    ``_rl_sep_linear``) or ``zy_pallas`` (``"circular"``, ``_rl_sep_zy``)
    RL: the step ``est * conv3^T(data / max(conv3(est), eps))`` on the
    G grid, each conv3 one
    :func:`~shrimpy_tpu_torch.ops.conv3_cuda.conv3_half_step` (z+y
    kernel, then x), iterated by :func:`run_rl_outer`, Biggs-accelerated
    when ``settings.acceleration == "biggs"``. ``plain=True`` runs the
    plain versions on any device in ``dtype`` (the reference path).
    Float32 FMA throughout on the card (``matmul_precision`` is not read).
    ``donate`` consumes ``image`` once the carries exist.
    """
    from shrimpy_tpu_torch.ops.conv3_cuda import conv3_half_step, conv3_half_step_plain
    from shrimpy_tpu_torch.ops.rl_fused import crop_grid, start_on_grid
    from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer

    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype, donate=donate)
    del image
    kernel = not plain and est.is_cuda
    if kernel:
        scratch = [torch.empty_like(est) for _ in range(1 if len(terms) == 1 else 2)]
        ratio_buf = torch.empty_like(est)

    def step(v: torch.Tensor) -> torch.Tensor:
        # Updates v in place on the card: run_rl_outer never reads it again.
        if kernel:
            ratio = conv3_half_step(v, data, conv, "ratio", eps, boundary=boundary,
                                    out=ratio_buf, scratch=scratch)
            return conv3_half_step(ratio, v, adj, "mult", eps, boundary=boundary, out=v,
                                   scratch=scratch)
        half = conv3_half_step_plain if plain else conv3_half_step
        ratio = half(v, data, conv, "ratio", eps, boundary=boundary)
        return half(ratio, v, adj, "mult", eps, boundary=boundary)

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    return crop_grid(est, shape, conv.radii)


def richardson_lucy(
    image,
    psf,
    settings=None,
    *,
    iterations: int | None = None,
    terms=None,
    device=None,
    plain: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Richardson-Lucy deconvolution of a (Z, Y, X) ``image`` by ``psf``.

    ``image`` is a tensor, which stays on its device unless ``device``
    moves it, or a numpy array, which goes to ``device`` (the card when
    None, raising where there is none; ``"cpu"`` asks for the CPU).
    ``terms`` overrides the planned separable decomposition (a list of
    numpy ``(wz, wy, wx)`` triples, e.g. from
    ``shrimpy_tpu.ops.deconv.plan_separable_terms``). Returns a
    ``dtype`` tensor of ``image.shape`` on the image's device. With
    ``settings.donate_input`` the image tensor is consumed: it is left
    empty once the carries are built, and the caller must not read it
    afterwards (a numpy array is never touched).
    """
    settings = settings or deconvolve_settings()
    check_ported(settings)
    iters = iterations if iterations is not None else settings.iterations
    image = as_tensor(image, device)
    psf_np = prepare_psf(psf, settings)
    if (image.dim() != 3 or psf_np.ndim != 3) and settings.algorithm == "auto":
        # The JAX package sends these to its FFT RL (rl_fft).
        raise NotImplementedError(
            f"a {image.dim()}-D image with a {psf_np.ndim}-D PSF runs on the FFT RL path, "
            "which is not ported yet: ROADMAP queue 1 item 8 (non-separable and FFT RL)"
        )
    if image.dim() != 3 or psf_np.ndim != 3:
        raise ValueError(
            f"the separable path takes a 3-D image and PSF, got {tuple(image.shape)} "
            f"and {psf_np.shape}"
        )
    if terms is None:
        terms = plan_terms(psf_np, settings)
    return rl_separable(image, psf_np, terms, settings, iters, plain=plain, dtype=dtype,
                        donate=bool(settings.donate_input))
