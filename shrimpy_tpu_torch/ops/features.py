"""Tracking features: blur, histogram percentile, multi-Otsu, masks and
centroids (counterpart of ``shrimpy_tpu/ops/features.py``).

The same functions on tensors, on the tensor's device:

* :func:`gaussian_blur`: separable 1-D convolutions with unit-sum taps of
  radius ``round(4 sigma)`` (:func:`_gaussian_kernel`, a copy), numpy's
  ``"symmetric"`` boundary (the edge sample repeated; scipy's
  ``mode="reflect"``), by index, so a radius past the axis length wraps
  as ``jnp.pad`` does. ``F.conv1d`` runs it with TF32 off: cuDNN runs a
  float32 convolution on the tensor cores in TF32 unless told not to.
* :func:`histogram_percentile` and :func:`multi_otsu` share
  :func:`_histogram`: JAX's float32 binning ``((x - lo) / span * bins)``
  truncated to int32 and clipped, counted by ``torch.bincount`` (not
  ``torch.histc``, whose bin edges are its own), int32 counts, the CDF cast
  to float32 before ``>= target``. Multi-Otsu searches all (t1 < t2) bin
  pairs in one broadcast (bins x bins) evaluation, the first maximum in C
  order on a tie.
* :func:`center_of_mass` falls back to the geometric centre when the total
  weight is 0; it sums the per-axis marginals (one reduction a pass).
* :func:`multi_otsu_reference` is the float64 brute-force oracle, a copy.

JAX computes all of these with XLA ops outside any Pallas kernel, so these
PyTorch versions are the port. ``dtype`` (float32; float64 for the
reference run on the card) is the arithmetic's type. A tensor stays on its
device; a numpy array goes to ``device`` (the card when None; ``"cpu"``
asks for the CPU).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.fft import _pad


def _gaussian_kernel(sigma: float) -> np.ndarray:
    """1-D unit-sum Gaussian taps, radius = round(4 sigma) (scipy default)."""
    radius = max(1, int(4.0 * sigma + 0.5))
    u = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (u / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _exact_convolutions():
    """cuDNN with TF32 off for the float32 convolutions inside (the other
    cuDNN flags as they are); nothing to set off the card."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _conv_along(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Edge-mirrored (numpy ``"symmetric"``) 1-D convolution along ``axis``."""
    radius = taps.shape[0] // 2
    moved = torch.movedim(x, axis, -1)
    lead, n = moved.shape[:-1], moved.shape[-1]
    flat = moved.reshape(-1, 1, n)
    padded = _pad(flat, ((0, 0), (0, 0), (radius, radius)), "symmetric")
    out = F.conv1d(padded, taps.reshape(1, 1, -1))
    return torch.movedim(out.reshape(*lead, n), -1, axis)


def gaussian_blur(vol, sigma, *, device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Separable N-D Gaussian blur; ``sigma`` scalar or per-axis tuple.

    Oracle: ``scipy.ndimage.gaussian_filter(mode='reflect')``.
    """
    out = as_tensor(vol, device).to(dtype)
    if np.isscalar(sigma):
        sigma = (float(sigma),) * out.dim()
    ctx = _exact_convolutions() if out.is_cuda else contextlib.nullcontext()
    with ctx:
        for axis, s in enumerate(sigma):
            if s > 0:
                taps = torch.from_numpy(_gaussian_kernel(float(s))).to(out.device, dtype)
                out = _conv_along(out, taps, axis)
    return out


def _histogram(flat: torch.Tensor, bins: int):
    """(lo, span, int32 counts) shared by the percentile and Otsu: JAX's
    binning in the input's type; int32 counts (a float32 accumulator stops
    at 2**24, and a production stack's background bin holds more)."""
    lo = torch.min(flat)
    span = torch.clamp(torch.max(flat) - lo, min=1e-12)
    idx = torch.clamp(((flat - lo) / span * bins).to(torch.int32), 0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).to(torch.int32)
    return lo, span, counts


def _bin_edge(lo: torch.Tensor, k: torch.Tensor, bins: int, span: torch.Tensor) -> torch.Tensor:
    """``lo + k / bins * span`` rounded once, in float64, to ``lo``'s type:
    XLA on the CPU contracts the product and the sum into one fused
    multiply-add, so a float32 product rounded on its own can land an ulp
    away from JAX's edge."""
    return (lo.double() + k.double() / bins * span.double()).to(lo.dtype)


def histogram_percentile(vol, q: float, bins: int = 4096, *, device=None,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Approximate percentile via a fixed-bin histogram: the upper edge of
    the smallest bin whose cumulative count reaches ``q`` % of the voxels
    (a 0-D tensor on the input's device). Max error = one bin width."""
    flat = as_tensor(vol, device).to(dtype).reshape(-1)
    lo, span, counts = _histogram(flat, bins)
    cdf = torch.cumsum(counts, 0)
    target = torch.tensor(q, dtype=torch.float32) / 100.0 * flat.shape[0]
    bin_idx = torch.argmax((cdf.to(torch.float32) >= target.to(flat.device)).to(torch.uint8))
    return _bin_edge(lo, bin_idx + 1, bins, span)


def otsu_objective(vol, bins: int = 256, *, device=None, dtype: torch.dtype = torch.float32):
    """``(lo, span, var)``: the histogram's lower edge and span, and the
    3-class inter-class variance of every bin pair ``var[t1, t2]`` (the
    classes ``[0, t1)``, ``[t1, t2)``, ``[t2, bins)``; ``-inf`` where
    ``t1 >= t2``), a (bins, bins) tensor on the input's device."""
    flat = as_tensor(vol, device).to(dtype).reshape(-1)
    lo, span, hist = _histogram(flat, bins)
    dev = flat.device
    p = hist.to(dtype) / flat.shape[0]
    centers = lo + (torch.arange(bins, dtype=dtype, device=dev) + 0.5) / bins * span
    zero = torch.zeros(1, dtype=dtype, device=dev)
    w = torch.cat([zero, torch.cumsum(p, 0)])
    mu = torch.cat([zero, torch.cumsum(p * centers, 0)])

    def class_term(a, b):
        wk = w[b] - w[a]
        muk = mu[b] - mu[a]
        return torch.where(wk > 0, muk**2 / torch.clamp(wk, min=1e-12), 0.0)

    t1 = torch.arange(bins, device=dev)[:, None]
    t2 = torch.arange(bins, device=dev)[None, :]
    var = class_term(0, t1) + class_term(t1, t2) + class_term(t2, bins)
    return lo, span, torch.where(t1 < t2, var, -torch.inf)


def multi_otsu(vol, classes: int = 3, bins: int = 256, *, device=None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Multi-Otsu thresholds (3 classes -> 2 thresholds, a (2,) tensor on
    the input's device): the bin pair that maximizes
    :func:`otsu_objective`, each threshold the upper edge of its class's
    last bin."""
    if classes != 3:
        raise NotImplementedError("multi_otsu supports classes=3 (reference parity)")
    lo, span, var = otsu_objective(vol, bins, device=device, dtype=dtype)
    best = torch.argmax(var)
    return _bin_edge(lo, torch.stack([best // bins, best % bins]), bins, span)


def multi_otsu_reference(vol: np.ndarray, bins: int = 256) -> np.ndarray:
    """Brute-force fp64 oracle over the identical histogram."""
    flat = np.asarray(vol, dtype=np.float64).ravel()
    lo, hi = flat.min(), flat.max()
    span = max(hi - lo, 1e-12)
    idx = np.clip(((flat - lo) / span * bins).astype(np.int64), 0, bins - 1)
    p = np.bincount(idx, minlength=bins).astype(np.float64) / flat.size
    centers = lo + (np.arange(bins) + 0.5) / bins * span
    w = np.concatenate([[0.0], np.cumsum(p)])
    mu = np.concatenate([[0.0], np.cumsum(p * centers)])

    best, best_pair = -np.inf, (0, 1)
    for a in range(bins):
        for b in range(a + 1, bins):
            total = 0.0
            for lo_i, hi_i in ((0, a), (a, b), (b, bins)):
                wk = w[hi_i] - w[lo_i]
                if wk > 0:
                    muk = mu[hi_i] - mu[lo_i]
                    total += muk * muk / wk
            if total > best:
                best, best_pair = total, (a, b)
    a, b = best_pair
    return np.array([lo + a / bins * span, lo + b / bins * span])


def binary_mask(vol, threshold, *, device=None, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """``vol > threshold`` as ``dtype``."""
    return (as_tensor(vol, device) > threshold).to(dtype)


def center_of_mass(weights, *, device=None, dtype: torch.dtype = torch.float32
                   ) -> torch.Tensor:
    """Intensity-weighted centroid in voxel coordinates (ZYX... order), a
    tensor on the input's device; the geometric centre when the total
    weight is zero."""
    w = as_tensor(weights, device).to(dtype)
    total = torch.sum(w)
    coords = []
    for axis in range(w.dim()):
        others = tuple(a for a in range(w.dim()) if a != axis)
        marginal = torch.sum(w, dim=others) if others else w
        grid = torch.arange(w.shape[axis], dtype=dtype, device=w.device)
        proj = torch.sum(marginal * grid)
        center_default = (w.shape[axis] - 1) / 2.0
        coords.append(torch.where(total > 0, proj / torch.clamp(total, min=1e-12),
                                  torch.tensor(center_default, dtype=dtype, device=w.device)))
    return torch.stack(coords)


def otsu_component_mask(vol, component: int = 0, sigma: float = 0.0, bins: int = 256, *,
                        device=None, dtype: torch.dtype = torch.float32):
    """Blur -> multi-Otsu -> threshold ABOVE the selected component:
    ``(mask, blurred)``. ``component`` 0 takes the lower threshold (middle
    and bright classes), 1 the upper (the brightest class only), as the
    reference's ``otsu_component`` does."""
    vol = as_tensor(vol, device).to(dtype)
    if sigma > 0:
        vol = gaussian_blur(vol, sigma, dtype=dtype)
    thresholds = multi_otsu(vol, bins=bins, dtype=dtype)
    if component in (0, 1):
        return (vol > thresholds[component]).to(dtype), vol
    raise ValueError(
        f"otsu_component must be 0 (lower threshold) or 1 (upper), "
        f"got {component}"
    )
