"""Normalized cross-correlation template matching (counterpart of
``shrimpy_tpu/ops/match.py``).

The valid-mode NCC surface of a template over a moving volume
(``skimage.feature.match_template`` semantics, the reference's archived
``template_matching`` tracking method), computed the Lewis way on the
tensor's device:

* numerator: the correlation of the moving volume with the zero-mean
  template, ``irfftn(rfftn(mov) * conj(rfftn(tz)))`` on the 5-smooth grid
  ``fast_fft_shape(mov.shape)``, whose first ``mov - tmpl + 1`` samples per
  axis are the linear valid region;
* denominator: the moving volume's variance per window from windowed sums
  of ``M`` and ``M**2`` (:func:`_window_sums`, integral images by
  ``cumsum``), times the template's sum of squared deviations;
* a window whose ``var * ssd`` is at most ``sqrt(eps_float32)`` gets NCC 0
  (skimage's masked division).

``transform`` takes the JAX package's values; ``"xla"`` and ``"matmul"``
(a DFT as matrix products for the TPU's matrix unit) compute the same
transform, and all of ``"auto"``, ``"xla"`` and ``"matmul"`` map to
``torch.fft`` here, as in :mod:`shrimpy_tpu_torch.ops.pcc`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shrimpy_tpu_torch.ops.pcc import TRANSFORMS
from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.fft import fast_fft_shape

FLAT_WINDOW = float(np.sqrt(np.finfo(np.float32).eps))


def _window_sums(x: torch.Tensor, win: tuple[int, ...]) -> torch.Tensor:
    """Valid-mode windowed sums via per-axis integral images: output shape
    ``x.shape - win + 1``; axis k takes a cumulative sum with a zero
    prepended, so ``sum[i] = c[i + w] - c[i]``."""
    out = x
    for ax, w in enumerate(win):
        c = torch.cumsum(out, dim=ax)
        c = torch.cat([torch.zeros_like(c.narrow(ax, 0, 1)), c], dim=ax)
        n = out.shape[ax]
        out = c.narrow(ax, w, n + 1 - w) - c.narrow(ax, 0, n + 1 - w)
    return out


def _ncc_surface(mov: torch.Tensor, tmpl: torch.Tensor, fft_shape: tuple[int, ...],
                 dtype: torch.dtype) -> torch.Tensor:
    mov = mov.to(dtype)
    tmpl = tmpl.to(dtype)
    n = float(math.prod(tmpl.shape))
    tz = tmpl - torch.mean(tmpl)
    ssd_t = torch.sum(tz * tz)
    # rfftn with s= zero-pads at the end of each axis, as JAX's jnp.pad.
    corr = torch.fft.irfftn(torch.fft.rfftn(mov, s=fft_shape)
                            * torch.conj(torch.fft.rfftn(tz, s=fft_shape)), s=fft_shape)
    valid = tuple(ms - ts + 1 for ms, ts in zip(mov.shape, tmpl.shape))
    num = corr[tuple(slice(0, v) for v in valid)]
    s1 = _window_sums(mov, tuple(tmpl.shape))
    s2 = _window_sums(mov * mov, tuple(tmpl.shape))
    var = s2 - s1 * s1 / n
    denom2 = torch.clamp(var, min=0.0) * ssd_t
    safe = denom2 > FLAT_WINDOW
    return torch.where(safe, num / torch.sqrt(torch.where(safe, denom2, 1.0)), 0.0)


def match_template(mov, tmpl, *, transform: str = "auto", device=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Valid-mode NCC surface of ``tmpl`` over ``mov``, shape
    ``mov.shape - tmpl.shape + 1``, values in [-1, 1] up to roundoff, a
    ``dtype`` tensor on ``mov``'s device (``tmpl`` follows it). A numpy
    ``mov`` goes to ``device`` (the card when None)."""
    if transform not in TRANSFORMS:
        raise ValueError(f"transform {transform!r} not in {TRANSFORMS}")
    mov = as_tensor(mov, device)
    tmpl = as_tensor(tmpl, mov.device)
    if mov.dim() != tmpl.dim():
        raise ValueError(f"template is {tmpl.dim()}-D, moving volume {mov.dim()}-D")
    if any(t > m for t, m in zip(tmpl.shape, mov.shape)):
        raise ValueError(
            f"template {tuple(tmpl.shape)} does not fit moving volume {tuple(mov.shape)}"
        )
    fft_shape = fast_fft_shape(tuple(mov.shape), 1.0)
    return _ncc_surface(mov, tmpl, fft_shape, dtype)


def template_match_shift(ref, mov, slice_zyx: tuple[tuple[int, int], ...], *,
                         transform: str = "auto", device=None,
                         dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Shift of ``mov`` relative to ``ref`` from a template NCC peak:
    ``peak - start`` per axis (float64 numpy), positive where the object
    moved in the positive direction (the PCC's convention).

    ``slice_zyx`` gives per-axis ``(start, stop)`` of the template inside
    ``ref``. ``ref`` may stay on the host (a numpy array or CPU tensor):
    only its template window moves to ``mov``'s device. ``mov`` as in
    :func:`match_template`.
    """
    if not isinstance(ref, torch.Tensor):
        ref = torch.from_numpy(np.asarray(ref))
    starts, sel = [], []
    for ax, (start, stop) in enumerate(slice_zyx):
        if not 0 <= start < stop <= ref.shape[ax]:
            raise ValueError(
                f"template slice {slice_zyx[ax]} out of bounds for axis "
                f"{ax} of size {ref.shape[ax]}"
            )
        starts.append(start)
        sel.append(slice(start, stop))
    surface = match_template(mov, ref[tuple(sel)], transform=transform, device=device,
                             dtype=dtype)
    peak = np.unravel_index(int(torch.argmax(surface)), tuple(surface.shape))
    return np.asarray(peak, dtype=np.float64) - np.asarray(starts, dtype=np.float64)
