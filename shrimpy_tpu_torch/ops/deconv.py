"""Richardson-Lucy deconvolution, separable path (counterpart of the
slice's part of ``shrimpy_tpu/ops/deconv.py``).

The host numpy helpers — PSF support cropping and odd padding, the
separable decomposition with its denoise and extended-rank tiers, the
nonnegative CP decomposition of the hybrid's warm phase, the FFT grid
and z chunk, the two float64 oracles and ``gaussian_psf`` — are copies
of the JAX module's (which imports jax at
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
* ``algorithm: fft``, a PSF that no separable tier takes under ``auto``
  and a 1-D or 2-D image under ``auto`` run the FFT RL
  (:func:`shrimpy_tpu_torch.ops.rl_fft.rl_fft`, ``fft_backend`` resolved
  by :func:`resolve_fft_backend` as the JAX package resolves it off the
  TPU); ``algorithm: hybrid`` runs :func:`rl_hybrid`: separable warm
  iterations on a nonnegative CP decomposition of the PSF
  (:func:`plan_hybrid_terms`), then the FFT RL from there.
* ``fused_low_precision_iters > 0`` raises
  :class:`NotImplementedError` naming the ROADMAP item that ports it.
  Nothing is silently ignored. ``matmul_precision`` chooses MXU dot passes on the
  TPU; the port's kernels are float32 FMA throughout, and its products
  are float32 with TF32 off (see :mod:`~shrimpy_tpu_torch.ops.rl_matmul`).
"""

from __future__ import annotations

import logging
from collections import OrderedDict

import numpy as np
import torch

from shrimpy_tpu_torch.config import deconvolve_settings
from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.fft import next_fast_len, next_fast_len_tpu
from shrimpy_tpu_torch.utils.shapes import round_up
from shrimpy_tpu_torch.utils.timing import span

logger = logging.getLogger(__name__)

_BACKENDS = ("auto", "fused", "fused_iter", "linear_pallas", "zy_pallas", "matmul")
FFT_BACKENDS = ("auto", "fft3", "fft2z", "dft2z", "dft3", "dftz")


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
    if settings.fused_low_precision_iters > 0:
        raise NotImplementedError(
            "fused_low_precision_iters > 0 (2-pass bf16 TPU dots) is not "
            "ported: the CUDA kernel is float32 FMA throughout (ROADMAP "
            "queue 1 item 2)"
        )
    _check_backend(settings.separable_backend)
    resolve_fft_backend(settings, 3)  # raises on an unknown fft_backend


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
    """Separable terms of the working PSF under ``settings``, or None
    where it needs the FFT path (``algorithm: separable`` raises there)."""
    terms = plan_separable_terms(psf_np, settings)
    if terms is None and settings.algorithm == "separable":
        raise ValueError(
            "PSF is not separable within separable_tol="
            f"{settings.separable_tol} (<= {settings.max_separable_terms} terms) "
            "and rank-truncation denoising would discard more than "
            f"psf_denoise_max_residual={settings.psf_denoise_max_residual}; "
            "use algorithm='fft' or raise the tolerance"
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
    with span("shrimpy.rl.start"):
        conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype,
                                             donate=donate)
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


def _padded_grid_shape(
    image_shape: tuple[int, ...],
    psf_shape: tuple[int, ...],
    tpu_lanes: bool = True,
    transform: str = "xla",
) -> tuple[tuple[int, ...], tuple[tuple[int, int], ...]]:
    """FFT grid shape and per-axis (lo, hi) image padding: the PSF
    half-width on each side, then up to a 5-smooth length (``xla``; the
    last axis to a 5-smooth multiple of 128 with ``tpu_lanes``) or to
    multiples of 8, and 128 on the last axis (``matmul``). The JAX
    package's grid, kept so both packages wrap at the same distance."""
    assert len(image_shape) == len(psf_shape)
    assert transform in ("xla", "matmul"), transform
    grid = []
    pads = []
    for ax, (n, k) in enumerate(zip(image_shape, psf_shape)):
        half = k // 2
        target = n + 2 * half
        last = ax == len(image_shape) - 1
        if transform == "matmul":
            fast = round_up(target, 128 if last else 8)
        elif tpu_lanes and last:
            fast = next_fast_len_tpu(target)
        else:
            fast = next_fast_len(target)
        extra = fast - target
        lo = half + extra // 2
        hi = half + extra - extra // 2
        grid.append(fast)
        pads.append((lo, hi))
    return tuple(grid), tuple(pads)


def _fft2z_chunk(grid_z: int, requested: int) -> int:
    """Largest divisor of ``grid_z`` that is <= ``requested`` (>= 1)."""
    best = 1
    for d in range(1, min(requested, grid_z) + 1):
        if grid_z % d == 0:
            best = d
    return best


def resolve_fft_backend(settings, ndim: int) -> str:
    """The backend ``fft_backend: auto`` resolves to, as the JAX package
    resolves it off the TPU (``ops/dft.py::default_transform`` is
    ``xla`` there): ``fft2z`` for a 3-D volume, ``fft3`` otherwise."""
    backend = settings.fft_backend
    if backend not in FFT_BACKENDS:
        raise ValueError(f"unknown fft_backend {backend!r}")
    if backend == "auto":
        backend = "fft2z" if ndim == 3 else "fft3"
    return backend


_NONNEG_CP_CACHE: OrderedDict = OrderedDict()
_NONNEG_CP_CACHE_SIZE = 8


def nonneg_cp_decompose(
    psf: np.ndarray, n_terms: int, sweeps: int = 200
) -> tuple[list[tuple[np.ndarray, np.ndarray, np.ndarray]], float]:
    """Nonnegative rank-K CP decomposition ``psf ~ sum_k a_k x b_k x c_k``
    by HALS, started from the magnitudes of the SVD cascade's modes:
    ``(terms, rel_residual)``. A nonnegative warm operator keeps RL
    positive where a signed truncation diverges on dark regions (see the
    JAX module). Memoized per (psf, K, sweeps)."""
    psf = np.asarray(psf, np.float64)
    key = (psf.tobytes(), psf.shape, n_terms, sweeps)
    if key in _NONNEG_CP_CACHE:
        _NONNEG_CP_CACHE.move_to_end(key)
        return _NONNEG_CP_CACHE[key]
    nz, ny, nx = psf.shape
    cands = _separable_candidates(np.abs(psf) + 1e-30, n_terms)
    rng = np.random.default_rng(0)
    a = np.zeros((nz, n_terms))
    b = np.zeros((ny, n_terms))
    c = np.zeros((nx, n_terms))
    for k in range(n_terms):
        if k < len(cands):
            w, wz, wy, wx = cands[k]
            a[:, k] = np.abs(wz)
            b[:, k] = np.abs(wy) * abs(w) ** 0.5
            c[:, k] = np.abs(wx)
        else:
            a[:, k] = rng.random(nz)
            b[:, k] = rng.random(ny)
            c[:, k] = rng.random(nx)
    t1 = psf.reshape(nz, -1)
    t2 = np.moveaxis(psf, 1, 0).reshape(ny, -1)
    t3 = np.moveaxis(psf, 2, 0).reshape(nx, -1)
    for _ in range(sweeps):
        for m, tm, p, q in ((a, t1, b, c), (b, t2, a, c), (c, t3, a, b)):
            kr = (p[:, None, :] * q[None, :, :]).reshape(-1, n_terms)
            gram = (p.T @ p) * (q.T @ q)
            w = tm @ kr
            for k in range(n_terms):
                num = w[:, k] - m @ gram[:, k] + m[:, k] * gram[k, k]
                m[:, k] = np.maximum(num / max(gram[k, k], 1e-30), 0.0)
    recon = np.einsum("zk,yk,xk->zyx", a, b, c)
    residual = float(np.linalg.norm(psf - recon) / np.linalg.norm(psf))
    terms = [
        (a[:, k].astype(np.float32), b[:, k].astype(np.float32), c[:, k].astype(np.float32))
        for k in range(n_terms)
    ]
    result = (terms, residual)
    _NONNEG_CP_CACHE[key] = result
    if len(_NONNEG_CP_CACHE) > _NONNEG_CP_CACHE_SIZE:
        _NONNEG_CP_CACHE.popitem(last=False)
    return result


def plan_hybrid_terms(
    psf_np: np.ndarray, settings
) -> tuple[list[tuple[np.ndarray, np.ndarray, np.ndarray]], float]:
    """Warm-phase terms of ``algorithm: hybrid``: the smallest
    nonnegative rank-K CP factorization on the ladder 2, 4, 6, 8, 12, 16,
    24 (and the settings' cap) whose residual clears 0.15, else the best
    up to the cap, accepted at any residual (the exact tail owns
    correctness)."""
    psf_unit = np.asarray(psf_np, np.float64)
    psf_unit = psf_unit / psf_unit.sum()
    extended = max(settings.max_extended_terms, settings.max_separable_terms)
    best: tuple[list, float] | None = None
    ladder = sorted({n for n in (2, 4, 6, 8, 12, 16, 24, extended)})
    for n in ladder:
        if n > extended and best is not None:
            break
        terms, residual = nonneg_cp_decompose(psf_unit, min(n, extended))
        if best is None or residual < best[1]:
            best = (terms, residual)
        if residual <= 0.15:
            break
    terms, residual = best
    logger.info(
        "hybrid warm phase: nonneg rank-%d CP PSF (residual %.2e Frobenius); the "
        "exact FFT tail corrects the model error",
        len(terms), residual,
    )
    return terms, residual


def rl_hybrid(image: torch.Tensor, psf_np, warm_terms, settings, iterations: int, *,
              plain: bool = False, dtype: torch.dtype = torch.float32,
              donate: bool = False) -> torch.Tensor:
    """``hybrid_separable_iters`` separable iterations on the
    nonnegative ``warm_terms`` (:func:`rl_separable`, the backend that
    ``separable_backend`` resolves to), then ``iterations`` exact FFT
    iterations (:func:`~shrimpy_tpu_torch.ops.rl_fft.rl_fft`) from that
    start. A warm voxel that is not finite or negative starts from
    ``max(image, 0)`` instead (JAX's safety net). With Biggs both phases
    accelerate and alpha restarts at the boundary. ``donate`` consumes
    ``image`` in the exact phase, which still reads it."""
    from shrimpy_tpu_torch.ops.rl_fft import rl_fft

    warm = None
    if settings.hybrid_separable_iters:
        warm = rl_separable(image, psf_np, warm_terms, settings,
                            settings.hybrid_separable_iters, plain=plain, dtype=dtype)
        img_pos = torch.clamp_min(image.to(dtype), 0.0)
        warm = torch.where(torch.isfinite(warm) & (warm >= 0.0), warm, img_pos)
        del img_pos
    return rl_fft(image, psf_np, settings, iterations, init=warm, plain=plain, dtype=dtype,
                  donate=donate)


def _circulant(n: int, taps: np.ndarray) -> np.ndarray:
    """N x N float32 circulant of a centred circular convolution."""
    k = len(taps)
    r = k // 2
    mat = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for i in range(k):
        mat[rows, (rows - (i - r)) % n] += taps[i]
    return mat


def _toeplitz_banded(n: int, taps: np.ndarray) -> np.ndarray:
    """N x N float32 banded Toeplitz: centred zero-boundary convolution."""
    k = len(taps)
    r = k // 2
    mat = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for i in range(k):
        cols = rows - (i - r)
        ok = (cols >= 0) & (cols < n)
        mat[rows[ok], cols[ok]] += taps[i]
    return mat


def richardson_lucy_reference_separable(
    image: np.ndarray,
    psf: np.ndarray,
    iterations: int = 20,
    *,
    epsilon: float = 1e-6,
    pad_mode: str = "reflect",
    tol: float = 1e-4,
    max_terms: int = 6,
    pads: tuple[tuple[int, int], ...] | None = None,
    boundary: str = "circular",
    terms: list | None = None,
    psf_crop_tol: float = 1e-5,
) -> np.ndarray:
    """Float64 numpy oracle of the separable paths: dense circulant
    (``circular``) or banded Toeplitz (``zero``) matrices per axis and
    term, on the ``_sep_pads`` grid unless ``pads`` says otherwise."""
    from shrimpy_tpu_torch.ops.rl_matmul import _sep_pads

    image = np.asarray(image, dtype=np.float64)
    psf = _pad_psf_to_odd(_crop_psf_support(np.asarray(psf, np.float64), psf_crop_tol))
    psf_unit = psf / psf.sum()
    if terms is None:
        terms = separable_decompose(psf_unit, tol=tol, max_terms=max_terms)
    assert terms is not None, "PSF not separable within tol"
    if pads is None:
        pads = _sep_pads(tuple(image.shape), tuple(psf.shape))
    grid = tuple(n + lo + hi for n, (lo, hi) in zip(image.shape, pads))
    build = _circulant if boundary == "circular" else _toeplitz_banded
    mats = []
    for which in (1, -1):
        for axis in range(3):
            mats.append(np.stack([build(grid[axis], t[axis][::which]).astype(np.float64)
                                  for t in terms]))
    cz, cy, cx, tz, ty, tx = mats

    def conv3(v, az, ay, ax_):
        out = np.zeros_like(v)
        for i in range(az.shape[0]):
            w = np.einsum("ab,byx->ayx", az[i], v)
            w = np.einsum("ab,zbx->zax", ay[i], w)
            out = out + np.einsum("ab,zyb->zya", ax_[i], w)
        return out

    padded = np.pad(image, pads, mode=pad_mode)
    data = np.maximum(padded, 0.0)
    est = np.maximum(padded, epsilon)
    for _ in range(iterations):
        conv = conv3(est, cz, cy, cx)
        est = est * conv3(data / np.maximum(conv, epsilon), tz, ty, tx)
    crop = tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, image.shape))
    return est[crop].astype(np.float32)


def richardson_lucy_reference(
    image: np.ndarray,
    psf: np.ndarray,
    iterations: int = 20,
    *,
    epsilon: float = 1e-6,
    pad_mode: str = "reflect",
    psf_crop_tol: float = 1e-5,
    grid_transform: str = "xla",
) -> np.ndarray:
    """Float64 numpy oracle of the FFT path: the same update on the same
    grid (``grid_transform`` "matmul" for the tile-rounded grid of
    ``dft2z``, ``dft3`` and ``dftz``)."""
    image = np.asarray(image, dtype=np.float64)
    psf = _pad_psf_to_odd(_crop_psf_support(np.asarray(psf, np.float64), psf_crop_tol))
    grid, pads = _padded_grid_shape(tuple(image.shape), tuple(psf.shape),
                                    transform=grid_transform)
    padded = np.pad(image, pads, mode=pad_mode)
    psf_n = psf / psf.sum()
    embedded = np.zeros(grid, dtype=np.float64)
    embedded[tuple(slice(0, s) for s in psf.shape)] = psf_n
    embedded = np.roll(embedded, [-(s // 2) for s in psf.shape], axis=tuple(range(psf.ndim)))
    otf = np.fft.rfftn(embedded)
    axes = tuple(range(len(grid)))
    data = np.maximum(padded, 0.0)
    est = np.maximum(padded, epsilon)
    for _ in range(iterations):
        conv = np.fft.irfftn(np.fft.rfftn(est) * otf, s=grid, axes=axes)
        ratio = data / np.maximum(conv, epsilon)
        est = est * np.fft.irfftn(np.fft.rfftn(ratio) * np.conj(otf), s=grid, axes=axes)
    crop = tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, image.shape))
    return est[crop].astype(np.float32)


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
    """Richardson-Lucy deconvolution of ``image`` by ``psf`` (same ndim).

    Dispatches as the JAX package does: ``auto`` and ``separable`` run
    the separable path where the PSF decomposes (``separable`` raises
    where it does not), ``auto`` otherwise and ``fft`` run
    :func:`~shrimpy_tpu_torch.ops.rl_fft.rl_fft`, ``hybrid`` runs
    :func:`rl_hybrid` (the FFT path alone with
    ``hybrid_separable_iters: 0``). A 1-D or 2-D image takes the FFT
    path; ``separable`` and ``hybrid`` need a 3-D PSF.

    ``image`` is a tensor, which stays on its device unless ``device``
    moves it, or a numpy array, which goes to ``device`` (the card when
    None, raising where there is none; ``"cpu"`` asks for the CPU).
    ``terms`` overrides the planned decomposition: the separable terms,
    or the warm terms under ``hybrid`` (a list of numpy ``(wz, wy, wx)``
    triples). Returns a ``dtype`` tensor of ``image.shape`` on the
    image's device. ``plain=True`` runs the plain versions of the
    kernels in ``dtype`` (the reference path). With
    ``settings.donate_input`` the image tensor is consumed: it is left
    empty once the carries are built, and the caller must not read it
    afterwards (a numpy array is never touched).
    """
    from shrimpy_tpu_torch.ops.rl_fft import rl_fft

    settings = settings or deconvolve_settings()
    check_ported(settings)
    iters = iterations if iterations is not None else settings.iterations
    image = as_tensor(image, device)
    psf_np = prepare_psf(psf, settings)
    if image.dim() != psf_np.ndim:
        raise ValueError(f"image {tuple(image.shape)} and PSF {psf_np.shape} differ in ndim")
    if settings.algorithm in ("separable", "hybrid") and psf_np.ndim != 3:
        raise ValueError(
            f"algorithm='{settings.algorithm}' needs a 3-D PSF (got {psf_np.ndim}-D); "
            "use algorithm='fft'"
        )
    donate = bool(settings.donate_input)
    kw = {"plain": plain, "dtype": dtype, "donate": donate}
    if settings.algorithm == "hybrid":
        if settings.hybrid_separable_iters:
            warm = terms if terms is not None else plan_hybrid_terms(psf_np, settings)[0]
            return rl_hybrid(image, psf_np, warm, settings, iters, **kw)
        return rl_fft(image, psf_np, settings, iters, **kw)
    if settings.algorithm in ("auto", "separable") and psf_np.ndim == 3:
        if terms is None:
            terms = plan_terms(psf_np, settings)
        if terms is not None:
            return rl_separable(image, psf_np, terms, settings, iters, **kw)
    return rl_fft(image, psf_np, settings, iters, **kw)
