"""FFT phase cross-correlation (counterpart of ``shrimpy_tpu/ops/pcc.py``:
``phase_cross_correlation``, ``_pcc_jit``, ``_dft_refine_jit``).

The same estimator on ``torch.fft``:

* operands cast to float32, mean-subtracted and zero-padded (or
  center-cropped) to ``fast_fft_shape(max(ref, mov) * maximum_shift)``;
* correlation surface ``fftshift(|irfftn(rfftn(ref) * conj(rfftn(mov)))|)``;
* ``shift = shape // 2 - argmax`` per axis (positive: the moving image
  is displaced in the positive direction), the first maximum in C order
  on a tie;
* ``upsample="parabolic"``: a 3-point parabola per axis through the
  integer peak, clipped to +-0.5, kept at the integer estimate on the
  rim of an axis;
* ``upsample="dft"``: Guizar-Sicairos matrix-DFT upsampling around the
  coarse peak, ``2 * factor + 1`` points of ``1 / factor`` px per axis,
  as complex64 ``tensordot``s on the full spectrum ``fftn``.

``transform`` takes the JAX package's values: ``"xla"`` is ``jnp.fft``
and ``"matmul"`` runs the same DFT as matrix products for the TPU's
matrix unit (``shrimpy_tpu/ops/dft.py``); ``"auto"`` picks one by
platform. All three compute the same DFT, and all three map to
``torch.fft`` (cuFFT on the card) here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.fft import fast_fft_shape, match_shape

TRANSFORMS = ("auto", "xla", "matmul")


def _prepare(x: torch.Tensor, fft_shape, dtype: torch.dtype) -> torch.Tensor:
    x = x.to(dtype)
    return match_shape(x - torch.mean(x), fft_shape, mode="constant")


def _pcc(ref, mov, fft_shape, subpixel: bool, dtype: torch.dtype) -> np.ndarray:
    """Integer (or parabolic sub-pixel) shift, float32 (``_pcc_jit``)."""
    ref, mov = _prepare(ref, fft_shape, dtype), _prepare(mov, fft_shape, dtype)
    corr = torch.fft.irfftn(torch.fft.rfftn(ref) * torch.conj(torch.fft.rfftn(mov)),
                            s=fft_shape)
    corr = torch.fft.fftshift(torch.abs(corr))
    peak = np.unravel_index(int(torch.argmax(corr)), corr.shape)
    shift = np.array([s // 2 for s in corr.shape]) - np.array(peak)
    if not subpixel:
        return shift.astype(np.float32)
    refined = []
    for ax, n in enumerate(corr.shape):
        p = int(peak[ax])

        def take(i, ax=ax):
            sel = list(peak)
            sel[ax] = i
            return np.float32(corr[tuple(sel)].item())

        cm, c0, cp = take(max(p - 1, 0)), take(p), take(min(p + 1, n - 1))
        denom = cm - np.float32(2.0) * c0 + cp
        delta = np.float32(0.5) * (cm - cp) / denom if abs(denom) > 1e-12 else np.float32(0.0)
        delta = np.clip(delta, np.float32(-0.5), np.float32(0.5))
        if not 0 < p < n - 1:
            delta = np.float32(0.0)
        refined.append(np.float32(shift[ax]) - delta)
    return np.array(refined, np.float32)


def _dft_refine(ref, mov, coarse: np.ndarray, fft_shape, factor: int,
                halfwidth: int, dtype: torch.dtype) -> np.ndarray:
    """Matrix-DFT upsampling around ``coarse`` (``_dft_refine_jit``)."""
    ref, mov = _prepare(ref, fft_shape, dtype), _prepare(mov, fft_shape, dtype)
    out = torch.fft.fftn(ref) * torch.conj(torch.fft.fftn(mov))
    n_pts = 2 * halfwidth * factor + 1
    dev = out.device
    for ax, n in enumerate(fft_shape):
        freqs = torch.fft.fftfreq(n, device=dev, dtype=dtype)
        offs = torch.tensor(coarse[ax], dtype=dtype, device=dev) + (
            torch.arange(n_pts, dtype=dtype, device=dev) - halfwidth * factor) / factor
        # exp(-2i pi k d / N): the correlation at displacement d, which
        # peaks at d = +shift (the sign convention above).
        phase = (-2.0 * math.pi) * (offs[:, None] * freqs[None, :])
        mat = torch.polar(torch.ones_like(phase), phase)
        out = torch.movedim(torch.tensordot(mat, out, dims=([1], [ax])), 0, ax)
    surface = torch.abs(out)
    peak = np.unravel_index(int(torch.argmax(surface)), surface.shape)
    deltas = np.array([(np.float32(p) - halfwidth * factor) / factor for p in peak], np.float32)
    return coarse.astype(np.float32) + deltas


def phase_cross_correlation(ref, mov, maximum_shift: float = 1.0, *,
                            upsample: str | None = None, upsample_factor: int = 10,
                            transform: str = "auto", device=None,
                            dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Pixel shift of ``mov`` relative to ``ref`` (axis order preserved),
    as a float32 numpy array.

    ``upsample``: None (integer shift), ``"parabolic"`` or ``"dft"`` (to
    ``1 / upsample_factor`` px). ``ref`` and ``mov`` are tensors, which
    stay on their device unless ``device`` moves them, or numpy arrays,
    which go to ``device`` (the card when None; ``"cpu"`` asks for the
    CPU). ``transform`` is one of :data:`TRANSFORMS`, each ``torch.fft``.
    ``dtype`` is the arithmetic's type (float64 for a reference run).
    """
    if transform not in TRANSFORMS:
        raise ValueError(f"transform {transform!r} not in {TRANSFORMS}")
    if upsample not in (None, "parabolic", "dft"):
        raise ValueError(f"upsample {upsample!r} not in (None, 'parabolic', 'dft')")
    ref, mov = as_tensor(ref, device), as_tensor(mov, device)
    if mov.device != ref.device:
        mov = mov.to(ref.device)
    if ref.dim() != mov.dim():
        raise ValueError(f"ref is {ref.dim()}-D, mov {mov.dim()}-D")
    fft_shape = fast_fft_shape(tuple(max(a, b) for a, b in zip(ref.shape, mov.shape)),
                               maximum_shift)
    shift = _pcc(ref, mov, fft_shape, upsample == "parabolic", dtype)
    if upsample == "dft":
        shift = _dft_refine(ref, mov, shift, fft_shape, int(upsample_factor), 1, dtype)
    return shift
