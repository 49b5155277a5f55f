"""FFT sizing and shape-matching helpers (counterpart of
``shrimpy_tpu/utils/fft.py``: ``next_fast_len``, ``fast_fft_shape``,
``center_crop``, ``pad_to_shape``, ``match_shape``).

Sizes are computed in Python; only the padding and cropping touch the
tensor, on its own device. ``next_fast_len_tpu`` (a copy) rounds a last
axis to a 5-smooth multiple of 128: the FFT RL's padded grid keeps the
JAX package's rule (``ops/deconv.py::_padded_grid_shape``), so both
packages convolve on the same circular grid. The ``tpu_lanes`` option of
``fast_fft_shape`` (the PCC's grid) is not ported: asking for it raises.

Padding goes through an index per axis made by :func:`numpy.pad` on
``arange(n)``, so every mode has numpy's (and ``jnp.pad``'s) meaning,
also where a reflection is wider than its axis, which
``torch.nn.functional.pad`` refuses.
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.utils.shapes import round_up


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= ``n`` (prime factors only 2, 3, 5)."""
    if n <= 1:
        return 1
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def next_fast_len_tpu(n: int, lane_multiple: int = 128) -> int:
    """Smallest 5-smooth multiple of ``lane_multiple`` >= ``n`` (128 =
    2**7 is 5-smooth, so one exists)."""
    n = round_up(max(n, lane_multiple), lane_multiple)
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += lane_multiple


def center_crop(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Crop the center of ``x`` to ``shape`` (every dim <= x's)."""
    if x.dim() != len(shape):
        raise ValueError(f"center_crop: {x.dim()}-D tensor, {len(shape)}-D shape")
    starts = tuple((cur - s) // 2 for cur, s in zip(x.shape, shape))
    if not all(s >= 0 for s in starts):
        raise ValueError(f"center_crop: {tuple(x.shape)} is smaller than {tuple(shape)}")
    return x[tuple(slice(s, s + d) for s, d in zip(starts, shape))]


def _pad(x: torch.Tensor, pad_width, mode: str) -> torch.Tensor:
    """``jnp.pad(x, pad_width, mode)`` for ``constant`` (zeros) and the
    index modes of :func:`numpy.pad` (``reflect``, ``edge``, ``symmetric``,
    ``wrap``)."""
    if mode == "constant":
        out = x.new_zeros(tuple(n + lo + hi for n, (lo, hi) in zip(x.shape, pad_width)))
        out[tuple(slice(lo, lo + n) for n, (lo, _) in zip(x.shape, pad_width))] = x
        return out
    for axis, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=mode)
            x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


def pad_to_shape(x: torch.Tensor, shape: tuple[int, ...], mode: str = "reflect") -> torch.Tensor:
    """Pad ``x`` symmetrically to ``shape`` (every dim >= x's).

    A ``reflect`` pad as wide as its axis or wider degrades that axis to
    edge padding, as the JAX package does.
    """
    if x.dim() != len(shape):
        raise ValueError(f"pad_to_shape: {x.dim()}-D tensor, {len(shape)}-D shape")
    diffs = [s - a for s, a in zip(shape, x.shape)]
    if not all(d >= 0 for d in diffs):
        raise ValueError(f"pad_to_shape: {tuple(x.shape)} is larger than {tuple(shape)}")
    if all(d == 0 for d in diffs):
        return x
    pad_width = tuple((d // 2, d - d // 2) for d in diffs)
    if mode == "reflect":
        ok = [(lo < n and hi < n) or (lo == hi == 0) for (lo, hi), n in zip(pad_width, x.shape)]
        if not all(ok):
            x = _pad(x, tuple((0, 0) if good else w for good, w in zip(ok, pad_width)), "edge")
            return _pad(x, tuple(w if good else (0, 0) for good, w in zip(ok, pad_width)), mode)
    return _pad(x, pad_width, mode)


def match_shape(x: torch.Tensor, shape: tuple[int, ...], mode: str = "reflect") -> torch.Tensor:
    """Pad or crop ``x`` per axis to exactly ``shape``: pad any short
    axis, then center-crop any long one."""
    if any(s > d for s, d in zip(shape, x.shape)):
        x = pad_to_shape(x, tuple(max(d, s) for d, s in zip(x.shape, shape)), mode=mode)
    if any(s < d for s, d in zip(shape, x.shape)):
        x = center_crop(x, tuple(shape))
    return x


def fast_fft_shape(shape: tuple[int, ...], maximum_shift: float = 1.0,
                   tpu_lanes: bool = False) -> tuple[int, ...]:
    """FFT shape for cross-correlating volumes of ``shape``: each axis
    scaled by ``maximum_shift``, then rounded up to a 5-smooth length.
    ``tpu_lanes`` (the TPU's 128-lane rounding) raises."""
    if tpu_lanes:
        raise NotImplementedError(
            "tpu_lanes rounds the last axis to the TPU's 128 lanes; the port "
            "has no such rule (cuFFT takes any 5-smooth length)"
        )
    return tuple(next_fast_len(int(max(1, round(s * maximum_shift)))) for s in shape)
