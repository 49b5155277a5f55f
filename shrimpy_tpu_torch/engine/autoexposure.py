"""Autoexposure: the reference's three algorithms + escalation policy.

Parity with the archived production autoexposure (reference
``shrimpy/mantis/archive/pycromanager/autoexposure.py:22-285``): each
algorithm returns ``(flag, exposure_ms, laser_power)`` with flag -1
(underexposed), 0 (well exposed), +1 (overexposed), or None (no
change possible); plus the per-well manual CSV loader
(``docs/illumination.csv`` schema) and the laser-power-first
escalation (``:257-285``).

The port's own copy of ``shrimpy_tpu/engine/autoexposure.py`` (numpy only),
pinned statement for statement by ``tests/test_torch_config.py``
(``COPIES``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# Nominal laser power of the brightness model (the engine renders
# brightness scaled by power / NOMINAL_LASER_POWER; see
# engine/engine.py, which re-exports this constant).
NOMINAL_LASER_POWER = 10.0


@dataclass
class AutoexposureSettings:
    """Bounds + targets (reference ``AcquisitionSettings.py`` dataclass)."""

    min_intensity: float = 100.0
    max_intensity: float = 60000.0
    target_intensity: float = 30000.0
    min_exposure_ms: float = 1.0
    max_exposure_ms: float = 500.0
    default_exposure_ms: float = 10.0
    min_laser_power: float = 1.0
    max_laser_power: float = 100.0
    relative_exposure_step: float = 0.8
    percentile: float = 99.99
    hot_pixel_percentile: float = 99.999


def mean_intensity(
    image: np.ndarray,
    exposure_ms: float,
    laser_power: float,
    settings: AutoexposureSettings,
) -> tuple[int | None, float, float]:
    """Scale exposure so the mean hits the target (reference ``:67-118``)."""
    mean = float(np.mean(image))
    if settings.min_intensity <= mean <= settings.max_intensity:
        return 0, exposure_ms, laser_power
    flag = -1 if mean < settings.min_intensity else 1
    if mean <= 0:
        return flag, settings.max_exposure_ms, laser_power
    new_exposure = float(
        np.clip(
            exposure_ms * settings.target_intensity / mean,
            settings.min_exposure_ms,
            settings.max_exposure_ms,
        )
    )
    if new_exposure == exposure_ms:
        return flag, exposure_ms, laser_power
    return flag, new_exposure, laser_power


def masked_mean_intensity(
    image: np.ndarray,
    exposure_ms: float,
    laser_power: float,
    settings: AutoexposureSettings,
) -> tuple[int | None, float, float]:
    """Mean over foreground with hot pixels masked (reference ``:121-179``)."""
    hot_cutoff = np.percentile(image, settings.hot_pixel_percentile)
    # The mask exists to drop a handful of hot/dead-bright PIXELS; a
    # large population at the cutoff is genuine overexposure that the
    # mask must not hide (a 60%-saturated frame would otherwise read
    # 'well exposed' from its background alone). BUT only when that
    # population is actually bright: a dark or quantized frame has >=1%
    # of pixels tied at its own maximum too, and halving exposure there
    # drives an underexposed sample darker forever.
    if (
        float(np.mean(image >= hot_cutoff)) > 0.01
        and hot_cutoff > settings.max_intensity
    ):
        return 1, max(exposure_ms / 2.0, settings.min_exposure_ms), laser_power
    valid = image[image < hot_cutoff]
    if valid.size == 0:
        valid = image.ravel()
    foreground = valid[valid >= np.percentile(valid, 50)]
    if foreground.size == 0:
        return -1, settings.max_exposure_ms, laser_power
    return mean_intensity(foreground, exposure_ms, laser_power, settings)


def intensity_percentile(
    image: np.ndarray,
    exposure_ms: float,
    laser_power: float,
    settings: AutoexposureSettings,
) -> tuple[int | None, float, float]:
    """Judge by the 99.99th-percentile intensity (reference ``:182-235``)."""
    p = float(np.percentile(image, settings.percentile))
    if settings.min_intensity <= p <= settings.max_intensity:
        return 0, exposure_ms, laser_power
    if p > settings.max_intensity:
        # Overexposed: shrink exposure multiplicatively.
        new_exposure = float(
            np.clip(
                exposure_ms * settings.relative_exposure_step,
                settings.min_exposure_ms,
                settings.max_exposure_ms,
            )
        )
        return 1, new_exposure, laser_power
    if p <= 0:
        return -1, settings.max_exposure_ms, laser_power
    new_exposure = float(
        np.clip(
            exposure_ms * settings.target_intensity / p,
            settings.min_exposure_ms,
            settings.max_exposure_ms,
        )
    )
    return -1, new_exposure, laser_power


ALGORITHMS = {
    "mean_intensity": mean_intensity,
    "masked_mean_intensity": masked_mean_intensity,
    "intensity_percentile": intensity_percentile,
}


def autoexpose_with_escalation(
    acquire_fn,
    settings: AutoexposureSettings,
    *,
    algorithm: str = "intensity_percentile",
    exposure_ms: float | None = None,
    laser_power: float = 10.0,
    max_rounds: int = 5,
) -> tuple[float, float, bool]:
    """Iterate until well-exposed; raise laser power before exposure when
    underexposure persists at max exposure (reference ``:257-285``).

    ``acquire_fn(exposure_ms, laser_power) -> image``.
    Returns (exposure_ms, laser_power, converged).
    """
    algo = ALGORITHMS[algorithm]
    # `is None` (not falsy-or): an explicit 0.0 is a bad upstream value
    # to surface via clipping, not silently replace with the default.
    exposure = (
        settings.default_exposure_ms if exposure_ms is None
        # Clamp BOTH sides: an initial exposure above max_exposure_ms
        # would be acquired beyond the declared hardware bound and
        # could be returned as the 'converged' result.
        else float(np.clip(
            exposure_ms, settings.min_exposure_ms, settings.max_exposure_ms
        ))
    )
    for _ in range(max_rounds):
        image = acquire_fn(exposure, laser_power)
        flag, new_exposure, laser_power = algo(image, exposure, laser_power, settings)
        if flag == 0:
            return new_exposure, laser_power, True
        if (
            flag == -1
            and new_exposure >= settings.max_exposure_ms
            and laser_power < settings.max_laser_power
        ):
            # Laser-power-first escalation: double power, reset exposure.
            laser_power = min(laser_power * 2.0, settings.max_laser_power)
            new_exposure = settings.default_exposure_ms
            logger.info("autoexposure: escalating laser power to %.1f", laser_power)
        exposure = new_exposure
    return exposure, laser_power, False


def load_manual_exposures(csv_path: str | Path) -> dict[str, tuple[float, float]]:
    """Per-well manual exposures: ``well,exposure_ms,laser_power`` rows
    (reference ``docs/illumination.csv`` + loader ``:22-40``)."""
    import csv

    out: dict[str, tuple[float, float]] = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            # Missing/empty laser_power defaults to the NOMINAL power:
            # the engine multiplies brightness by power/nominal, so a
            # 0.0 default would render those wells all-black.
            out[row["well"]] = (
                float(row["exposure_ms"]),
                float(row.get("laser_power") or NOMINAL_LASER_POWER),
            )
    return out
