"""In-focus slice selection by midband spatial-frequency power
and the demo PFS (counterpart of ``shrimpy_tpu/engine/autofocus.py``:
``_focus_metric_jit``, :func:`focus_from_transverse_band` and
:class:`DemoAutofocus`).

Per z slice, the power of the mean-subtracted slice's spectrum inside the
transverse band ``lo..hi`` of the incoherent cutoff ``2 NA / lambda``, on
``torch.fft.rfft2``: the input is real and the band depends only on
``|f|``, so the half spectrum with the interior x bins counted twice gives
the full spectrum's sum. The band's mask is computed in float32 as JAX
computes it (``fftfreq`` as ``k / (d n)`` with ``d n`` in float32), so a
float64 run (``dtype``, the reference on the card) sums the same bins.
``transform`` takes the JAX package's values (``"matmul"`` computes the
same half spectrum as matrix products for the TPU's matrix unit); all map
to ``torch.fft`` here.

:class:`DemoAutofocus`, the simulated PFS, is the JAX class statement for
statement (``tests/test_torch_position.py`` pins it). It reads its plan by
attribute: an ``AutofocusPlan`` of either package or
:func:`shrimpy_tpu_torch.config.autofocus_plan`, so this module imports
neither ``engine/plan.py`` nor pydantic, and loads where the card's host has
only torch.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

import numpy as np
import torch

from shrimpy_tpu_torch.ops.pcc import TRANSFORMS
from shrimpy_tpu_torch.utils.device import as_tensor

if TYPE_CHECKING:
    from shrimpy_tpu_torch.engine.plan import AutofocusPlan

logger = logging.getLogger(__name__)


class DemoAutofocus:
    """Simulated PFS: deterministic failures + seeded random success."""

    def __init__(self, plan: AutofocusPlan, n_positions: int):
        self.plan = plan
        self.n_positions = n_positions
        self._rng = np.random.default_rng(plan.seed)

    def engage(self, t: int, p_index: int) -> bool:
        """True when focus locks; False on failure (caller skips/pads)."""
        if not self.plan.enabled:
            return True
        flat = t * self.n_positions + p_index
        if self.plan.fail_at_indices is not None and flat in self.plan.fail_at_indices:
            logger.warning("autofocus: deterministic failure at t=%d p=%d", t, p_index)
            return False
        if self._rng.random() > self.plan.success_rate:
            logger.warning("autofocus: simulated failure at t=%d p=%d", t, p_index)
            return False
        return True


def band_weights(ny: int, nx: int, pixel_size_um: float, lambda_um: float, na_det: float,
                 band: tuple[float, float]) -> torch.Tensor:
    """(ny, nx // 2 + 1) float32 weight of each half-spectrum bin: 0 outside
    the band, 2 inside it on an interior x bin, 1 on x bin 0 and, for an
    even ``nx``, on the last."""
    f32 = torch.float32
    d = torch.tensor(pixel_size_um, dtype=f32)
    i = torch.arange(ny, dtype=f32)
    fy = ((i + ny // 2) % ny - ny // 2) / (d * ny)
    fx = torch.arange(nx // 2 + 1, dtype=f32) / (d * nx)
    cutoff = 2.0 * torch.tensor(na_det, dtype=f32) / torch.tensor(lambda_um, dtype=f32)
    lo, hi = band
    f = torch.sqrt(fy[:, None] ** 2 + fx[None, :] ** 2)
    mask = (f >= lo * cutoff) & (f <= hi * cutoff)
    cx = np.full(nx // 2 + 1, 2.0, np.float32)
    cx[0] = 1.0
    if nx % 2 == 0:
        cx[-1] = 1.0
    return mask.to(f32) * torch.from_numpy(cx)[None, :]


def focus_power(stack_zyx, *, pixel_size_um: float, wavelength_um: float = 0.55,
                na_det: float = 1.35, band: tuple[float, float] = (0.125, 0.25),
                device=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Midband transverse power per z slice, a (Z,) ``dtype`` tensor on the
    stack's device (``_focus_metric_jit``)."""
    stack = as_tensor(stack_zyx, device).to(dtype)
    _, ny, nx = stack.shape
    weights = band_weights(ny, nx, pixel_size_um, wavelength_um, na_det, band)
    centered = stack - torch.mean(stack, dim=(1, 2), keepdim=True)
    power = torch.abs(torch.fft.rfft2(centered)) ** 2
    return torch.sum(power * weights.to(stack.device, dtype)[None], dim=(1, 2))


def focus_from_transverse_band(
    stack_zyx,
    *,
    pixel_size_um: float,
    wavelength_um: float = 0.55,
    na_det: float = 1.35,
    band: tuple[float, float] = (0.125, 0.25),
    threshold: float = 0.0,
    transform: str = "auto",
    device=None,
    dtype: torch.dtype = torch.float32,
) -> int | None:
    """Index of the in-focus slice: argmax of midband spectral power.

    Returns None when the peak is not prominent (max power below
    ``threshold`` times the median): the caller extends the scan range.
    A tensor stays on its device; a numpy array goes to ``device`` (the
    card when None; ``"cpu"`` asks for the CPU). Only the Z powers leave it.
    """
    if transform not in TRANSFORMS:
        raise ValueError(f"transform {transform!r} not in {TRANSFORMS}")
    power = focus_power(stack_zyx, pixel_size_um=pixel_size_um, wavelength_um=wavelength_um,
                        na_det=na_det, band=band, device=device, dtype=dtype).cpu().numpy()
    idx = int(np.argmax(power))
    if threshold > 0:
        med = float(np.median(power))
        if med <= 0:
            # A zero median with a positive peak is the MOST prominent
            # case (most slices carry no midband power at all), not a
            # failure; only an all-zero stack has no focus.
            return idx if power[idx] > 0 else None
        if power[idx] < threshold * med:
            return None
    return idx
