"""Richardson-Lucy on the FFT grid, for any PSF (counterpart of the FFT
paths of ``shrimpy_tpu/ops/deconv.py``: ``_embed_psf`` :108, ``_rl_jit``
:130, ``_rl_fft2z_jit`` :340, ``rl_fft`` :1605).

The update is ``est <- est * corr(psf, data / max(conv(psf, est), eps))``
with ``conv`` and ``corr`` circular on the padded grid of
:func:`~shrimpy_tpu_torch.ops.deconv._padded_grid_shape` (the JAX
package's, so both wrap at the same distance), ``data = max(g, 0)`` and
``est = max(g, eps)`` of the image ``g`` padded with ``pad_mode``, or of
``init`` padded so (the hybrid's warm start: ``data`` stays the image's).
The transforms are cuFFT's on the card, as JAX leaves them to XLA
outside any Pallas kernel: ``torch.fft`` in :func:`rl_fft3`, plans on the
loop's own buffers in :func:`rl_fft2z`, whose kernels are the banded
z-sum (:mod:`~shrimpy_tpu_torch.ops.zband_cuda`) and the update's two
elementwise passes (:mod:`~shrimpy_tpu_torch.ops.fft_cuda`).

How each ``fft_backend`` maps (the port has no matmul-DFT: ``ops/dft.py``
exists for the TPU's FFT):

==========  ==========================================  ======================================
Setting     JAX off the TPU                             Port
==========  ==========================================  ======================================
``auto``    ``fft2z`` (3-D) / ``fft3``                  the same
``fft3``    ``jnp.fft`` 3-D on the 5-smooth grid        :func:`rl_fft3`, same grid
``fft2z``   banded z-sum between 2-D ``jnp.fft``        :func:`rl_fft2z`, same grid
``dft2z``   ``fft2z``'s math, matmul-DFT, tile grid     :func:`rl_fft2z` on the tile-rounded grid
``dft3``    exact circular conv by matmul-DFT, tile     :func:`rl_fft3` on the tile-rounded grid
``dftz``    the same, z by a dense DFT, tile grid       :func:`rl_fft3` on the tile-rounded grid
==========  ==========================================  ======================================

Each loop takes ``plain=`` (the plain band and torch calls in place of
the kernels and plans),
``dtype=`` (float32, or float64 for the reference path) and ``init=``,
and iterates through :func:`~shrimpy_tpu_torch.ops.rl_outer.run_rl_outer`
(Biggs with ``acceleration: biggs``). ``donate`` consumes the image once
the carries exist, as on the separable path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shrimpy_tpu_torch.ops import fft_cuda
from shrimpy_tpu_torch.ops.deconv import _fft2z_chunk, _padded_grid_shape, resolve_fft_backend
from shrimpy_tpu_torch.ops.rl_fused import consume
from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer
from shrimpy_tpu_torch.ops.zband_cuda import zband, zband_plain
from shrimpy_tpu_torch.utils.fft import _pad
from shrimpy_tpu_torch.utils.timing import span


def _unit_psf(psf_np, dtype: torch.dtype, device) -> torch.Tensor:
    psf = torch.from_numpy(np.ascontiguousarray(psf_np)).to(device=device, dtype=dtype)
    return psf / psf.sum()


def embed_psf(psf_np, grid, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """The unit-sum PSF on ``grid`` with its centre voxel (``shape // 2``)
    rolled to index 0, so its OTF carries no phase at DC. (The loops
    below scale their OTFs by the inverse transform's 1 / n and run the
    inverse unscaled, ``norm="forward"``: the same function, one
    elementwise pass fewer a transform.)"""
    psf = _unit_psf(psf_np, dtype, device)
    out = torch.zeros(tuple(grid), dtype=dtype, device=device)
    out[tuple(slice(0, s) for s in psf.shape)] = psf
    return torch.roll(out, [-(s // 2) for s in psf.shape], dims=tuple(range(psf.dim())))


def plane_otfs(psf_np, grid, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Per-z-plane OTFs (kz, gy, gx // 2 + 1) of the unit-sum PSF, each
    plane embedded at the (y, x) origin as :func:`embed_psf` does."""
    psf = _unit_psf(psf_np, dtype, device)
    kz, ky, kx = psf.shape
    _, gy, gx = grid
    planes = torch.zeros((kz, gy, gx), dtype=dtype, device=device)
    planes[:, :ky, :kx] = psf
    planes = torch.roll(planes, (-(ky // 2), -(kx // 2)), dims=(1, 2))
    return torch.fft.rfft2(planes)


def _start(image: torch.Tensor, init, pads, settings, dtype: torch.dtype, donate: bool):
    """``data = max(g, 0)`` and ``est = max(g, eps)`` of the padded image
    ``g`` (``est`` from the padded ``init`` where given); ``donate``
    consumes ``image`` once both exist."""
    eps = float(settings.epsilon)
    g = _pad(image.to(dtype), pads, settings.pad_mode)
    # Not in place: with zero pads g may be the caller's image itself.
    data = torch.clamp_min(g, 0.0)
    if init is None:
        est = torch.clamp_min(g, eps)
    else:
        est = torch.clamp_min(_pad(init.to(dtype), pads, settings.pad_mode), eps)
    del g
    if donate:
        consume(image)
    return data, est


def _crop(est: torch.Tensor, shape, pads) -> torch.Tensor:
    with span("shrimpy.rl.crop"):
        return est[tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, shape))].contiguous()


def rl_fft3(image: torch.Tensor, psf_np, settings, iterations: int, *, grid, pads,
            init=None, dtype: torch.dtype = torch.float32,
            donate: bool = False) -> torch.Tensor:
    """RL with whole-grid ``rfftn``/``irfftn`` over every axis, any ndim
    (``_rl_jit``). No kernel of the repository runs here."""
    shape = tuple(image.shape)
    eps = float(settings.epsilon)
    grid = tuple(grid)
    with span("shrimpy.rl.start"):
        data, est = _start(image, init, pads, settings, dtype, donate)
        del image
        otf = torch.fft.rfftn(embed_psf(psf_np, grid, dtype, est.device)).div_(math.prod(grid))
        otf_adj = otf.conj()

    def step(v: torch.Tensor) -> torch.Tensor:
        # Updates v in place: run_rl_outer never reads it again.
        conv = torch.fft.irfftn(torch.fft.rfftn(v) * otf, s=grid, norm="forward")
        ratio = torch.div(data, conv.clamp_min_(eps), out=conv)
        return v.mul_(torch.fft.irfftn(torch.fft.rfftn(ratio) * otf_adj, s=grid,
                                       norm="forward"))

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    return _crop(est, shape, pads)


def rl_fft2z(image: torch.Tensor, psf_np, settings, iterations: int, *, grid, pads,
             z_chunk: int, init=None, plain: bool = False,
             dtype: torch.dtype = torch.float32, donate: bool = False) -> torch.Tensor:
    """RL with the z axis outside the transforms (``_rl_fft2z_jit``):
    each half-step is batched 2-D ``rfft2`` of ``z_chunk`` planes a call
    into the half spectrum, one banded z-sum over the whole spectrum
    (:func:`~shrimpy_tpu_torch.ops.zband_cuda.zband`, mode ``conv`` then
    ``corr``), and ``irfft2`` back in chunks. The same circular update
    as :func:`rl_fft3` on the same grid: the embedded PSF spans kz
    planes, so the 3-D convolution is, per plane of the spectrum, a sum
    of kz per-plane OTFs times the spectrum kz planes around it.

    The transforms and the update go through
    :mod:`~shrimpy_tpu_torch.ops.fft_cuda` (on the card: cuFFT plans for
    the chunk's shape, reading and writing these buffers, and one kernel
    for each update). Memory: est, data, the spectrum and the band's
    output over the whole grid (four carries; complex ones of gz x gy x
    (gx // 2 + 1)), one real chunk of ``z_chunk`` planes, and cuFFT's work
    area. ``plain=True`` runs the plain versions on any device in
    ``dtype``: :func:`~shrimpy_tpu_torch.ops.zband_cuda.zband_plain` and
    the torch calls of :data:`~shrimpy_tpu_torch.ops.fft_cuda.PLAIN`."""
    shape = tuple(image.shape)
    eps = float(settings.epsilon)
    gz, gy, gx = grid
    with span("shrimpy.rl.start"):
        data, est = _start(image, init, pads, settings, dtype, donate)
        del image
        taps = plane_otfs(psf_np, grid, dtype, est.device).div_(gy * gx)
        spec = torch.empty((gz, gy, gx // 2 + 1), dtype=fft_cuda.COMPLEX[dtype],
                           device=est.device)
        band_out = None if plain or not est.is_cuda else torch.empty_like(spec)
        # Each chunk's inverse transform and update: the loop's one real scratch.
        real = torch.empty((min(z_chunk, gz), gy, gx), dtype=dtype, device=est.device)
    chunks = [(a, min(a + z_chunk, gz)) for a in range(0, gz, z_chunk)]
    r2c, c2r_, ratio_, scale_ = fft_cuda.PLAIN if plain else fft_cuda.WRAPPERS

    def band(mode: str) -> torch.Tensor:
        if plain:
            return zband_plain(spec, taps, mode)
        return zband(spec, taps, mode, out=band_out)

    def step(v: torch.Tensor) -> torch.Tensor:
        # Updates v in place: run_rl_outer never reads it again. On the card
        # c2r_ destroys its chunk of the band's output: nothing reads that
        # again before the next band launch rewrites all of it.
        for a, b in chunks:
            r2c(v[a:b], spec[a:b])
        acc = band("conv")
        for a, b in chunks:
            x = c2r_(acc[a:b], real[:b - a])
            r2c(ratio_(x, data[a:b], eps), spec[a:b])
        acc = band("corr")
        for a, b in chunks:
            scale_(v[a:b], c2r_(acc[a:b], real[:b - a]))
        return v

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    # The loop's buffers are freed before the crop makes its copy.
    del step, band, data, taps, spec, band_out, real
    return _crop(est, shape, pads)


def rl_fft(image: torch.Tensor, psf_np, settings, iterations: int, *, init=None,
           plain: bool = False, dtype: torch.dtype = torch.float32,
           donate: bool = False) -> torch.Tensor:
    """FFT-path RL of ``image`` by the working PSF ``psf_np`` (cropped and
    odd), the backend resolved from ``settings.fft_backend``:

    ==========  ======================================================
    Setting     Runs
    ==========  ======================================================
    ``auto``    ``fft2z`` for a 3-D volume, ``fft3`` otherwise (JAX's
                choice off the TPU)
    ``fft3``    :func:`rl_fft3` on the 5-smooth grid
    ``fft2z``   :func:`rl_fft2z` on the 5-smooth grid
    ``dft2z``   :func:`rl_fft2z` on the tile-rounded grid
    ``dft3``    :func:`rl_fft3` on the tile-rounded grid
    ``dftz``    :func:`rl_fft3` on the tile-rounded grid
    ==========  ======================================================

    ``fft_z_chunk`` is the planes a batched 2-D transform takes (rounded
    down to a divisor of the grid's z, as JAX's chunk is); the result
    does not depend on it. ``init`` (image-shaped, positive) warm-starts
    the iteration; ``plain``/``dtype``/``donate`` as in
    :func:`~shrimpy_tpu_torch.ops.deconv.richardson_lucy`.
    """
    backend = resolve_fft_backend(settings, image.dim())
    if backend in ("fft2z", "dft2z", "dft3", "dftz") and image.dim() != 3:
        raise ValueError(f"fft_backend='{backend}' needs a 3-D volume (got {image.dim()}-D); "
                         "use fft_backend='fft3'")
    grid, pads = _padded_grid_shape(
        tuple(image.shape), tuple(psf_np.shape),
        transform="matmul" if backend in ("dft2z", "dft3", "dftz") else "xla")
    if backend in ("fft2z", "dft2z"):
        return rl_fft2z(image, psf_np, settings, iterations, grid=grid, pads=pads,
                        z_chunk=_fft2z_chunk(grid[0], settings.fft_z_chunk), init=init,
                        plain=plain, dtype=dtype, donate=donate)
    return rl_fft3(image, psf_np, settings, iterations, grid=grid, pads=pads, init=init,
                   dtype=dtype, donate=donate)
