"""PSF measurement: bead detection, extraction, characterization
(counterpart of ``shrimpy_tpu/psf.py``).

Everything but :func:`measure_psf` is the JAX module's host code (numpy and
scipy), copied and pinned statement for statement by
``tests/test_torch_psf.py``. :func:`measure_psf` reads the bead stack from
a store and hands it to :func:`measure_volume_psf`, which deskews a
light-sheet stack on the device (``ops/deskew.py::deskew_volume``, the
hand-written kernel on the card) and measures the PSF on the host. The
deskew settings are read by attribute (``config.deskew_settings`` or the
schema's ``DeskewSettings``).
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
from scipy import ndimage

logger = logging.getLogger(__name__)

# Reference per-geometry detection/patch settings (measure_psf.py:20-50):
# axis labels are (SCAN, TILT, COVERSLIP) for raw LS data, ZYX otherwise.
GEOMETRY_SETTINGS = {
    "epi": {"patch_size_zyx": (31, 31, 31), "axis_labels": ("Z", "Y", "X")},
    "lightsheet": {
        "patch_size_zyx": (41, 31, 31),
        "axis_labels": ("SCAN", "TILT", "COVERSLIP"),
    },
    "deskewed": {"patch_size_zyx": (31, 41, 41), "axis_labels": ("Z", "Y", "X")},
}


def detect_beads(
    vol_zyx: np.ndarray,
    *,
    threshold_percentile: float = 99.5,
    min_distance: int = 10,
    exclude_border: int | tuple[int, int, int] = 8,
    max_beads: int = 200,
) -> np.ndarray:
    """(N, 3) voxel coordinates of isolated bead peaks.

    Local-maximum detection over a thresholded volume (the role of the
    reference's ``detect_peaks`` call into biahub).
    """
    vol = np.asarray(vol_zyx, dtype=np.float32)
    smoothed = ndimage.gaussian_filter(vol, 1.0)
    threshold = np.percentile(smoothed, threshold_percentile)
    footprint = np.ones((min_distance,) * 3, bool)
    local_max = smoothed == ndimage.maximum_filter(smoothed, footprint=footprint)
    candidates = np.argwhere(local_max & (smoothed > threshold))

    # Drop beads too close to the volume border for a full patch
    # (scalar or per-axis; c >= b and c < n - b matches extract_psf's
    # in-bounds criterion when b is the patch half-width).
    border = np.asarray(exclude_border)
    shape = np.asarray(vol.shape)
    ok = np.all(
        (candidates >= border) & (candidates < shape - border), axis=1
    )
    candidates = candidates[ok]
    # Brightest first, capped.
    order = np.argsort(-smoothed[tuple(candidates.T)])
    return candidates[order[:max_beads]]


def extract_psf(
    vol_zyx: np.ndarray,
    peaks: np.ndarray,
    patch_size_zyx: tuple[int, int, int] = (31, 31, 31),
    *,
    return_count: bool = False,
):
    """Background-subtracted, normalized average of centered bead patches.

    With ``return_count`` returns ``(psf, n_averaged)`` — the number of
    patches that actually contributed (out-of-bounds and flat/negative
    patches are dropped), which is what a report should call n_beads.
    """
    vol = np.asarray(vol_zyx, dtype=np.float64)
    half = [p // 2 for p in patch_size_zyx]
    patches = []
    for z, y, x in peaks:
        sl = tuple(
            slice(c - h, c - h + p) for c, h, p in zip((z, y, x), half, patch_size_zyx)
        )
        if any(s.start < 0 or s.stop > n for s, n in zip(sl, vol.shape)):
            continue
        patch = vol[sl].copy()
        patch -= np.median(patch)  # local background
        if patch.max() <= 0:
            continue
        patches.append(patch / patch.max())
    if not patches:
        return (None, 0) if return_count else None
    psf = np.mean(patches, axis=0)
    psf = np.clip(psf, 0.0, None)
    total = psf.sum()
    if total <= 0:
        return (None, 0) if return_count else None
    psf = (psf / total).astype(np.float32)
    return (psf, len(patches)) if return_count else psf


def _fwhm_1d(profile: np.ndarray, scale: float) -> float:
    """Full width at half maximum of a 1-D profile, linearly interpolated."""
    profile = np.asarray(profile, dtype=np.float64)
    peak_idx = int(np.argmax(profile))
    half = profile[peak_idx] / 2.0

    def cross(idxs):
        for i in idxs:
            j = i + 1 if i < peak_idx else i - 1
            lo, hi = sorted((profile[i], profile[j]))
            if lo <= half <= hi and profile[i] != profile[j]:
                frac = (half - profile[i]) / (profile[j] - profile[i])
                return i + frac * (j - i)
        return None

    left = cross(range(0, peak_idx))
    right = cross(range(len(profile) - 1, peak_idx, -1))
    if left is None or right is None:
        return float("nan")
    return abs(right - left) * scale


@dataclass
class PsfReport:
    n_beads: int
    fwhm_um_zyx: tuple[float, float, float]
    peak_voxel: tuple[int, int, int]
    shape: tuple[int, int, int]
    scale_zyx_um: tuple[float, float, float]
    axis_labels: tuple[str, str, str] = ("Z", "Y", "X")
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "n_beads": self.n_beads,
            "fwhm_um_zyx": list(self.fwhm_um_zyx),
            "peak_voxel": list(self.peak_voxel),
            "shape": list(self.shape),
            "scale_zyx_um": list(self.scale_zyx_um),
            "axis_labels": list(self.axis_labels),
            **self.extra,
        }


def characterize_psf(
    psf: np.ndarray,
    scale_zyx_um: tuple[float, float, float],
    *,
    n_beads: int = 0,
    axis_labels: tuple[str, str, str] = ("Z", "Y", "X"),
) -> PsfReport:
    """FWHM per axis through the peak voxel (reference
    ``_characterize_psf`` role)."""
    psf = np.asarray(psf, dtype=np.float64)
    peak = np.unravel_index(int(np.argmax(psf)), psf.shape)
    profiles = (
        psf[:, peak[1], peak[2]],
        psf[peak[0], :, peak[2]],
        psf[peak[0], peak[1], :],
    )
    fwhm = tuple(
        _fwhm_1d(p, s) for p, s in zip(profiles, scale_zyx_um)
    )
    return PsfReport(
        n_beads=n_beads,
        fwhm_um_zyx=fwhm,
        peak_voxel=tuple(int(v) for v in peak),
        shape=tuple(psf.shape),
        scale_zyx_um=tuple(float(s) for s in scale_zyx_um),
        axis_labels=axis_labels,
    )


def measure_psf(
    input_store: str | Path,
    output_path: str | Path,
    *,
    geometry: str = "epi",
    deskew=None,
    threshold_percentile: float = 99.5,
    timepoint: int = 0,
    channel: int = 0,
    device=None,
) -> PsfReport:
    """Full pipeline: bead stack store -> detected/averaged PSF on disk.

    With ``deskew`` settings and ``geometry='lightsheet'``, the raw
    bead stack is deskewed before extraction (the reference deskews
    with ``average_n_slices=3`` via biahub, ``measure_psf.py:223-250``)
    and the ``deskewed`` patch geometry applies. The deskew runs on
    ``device``, the card when None (``"cpu"`` asks for the CPU).
    """
    from shrimpy_tpu_torch.io.ngff import open_ngff

    pos = open_ngff(input_store).position()
    vol = pos.volume(timepoint, channel).astype(np.float32)
    return measure_volume_psf(
        vol, pos.zyx_scale, output_path, geometry=geometry, deskew=deskew,
        threshold_percentile=threshold_percentile, device=device,
    )


def measure_volume_psf(
    vol,
    scale_zyx_um: tuple[float, float, float],
    output_path: str | Path,
    *,
    geometry: str = "epi",
    deskew=None,
    threshold_percentile: float = 99.5,
    device=None,
) -> PsfReport:
    """:func:`measure_psf` on a bead stack in memory: ``vol`` (Z, Y, X) is a
    numpy array or a tensor (a light-sheet stack's deskew runs on its
    device, or on ``device`` for a numpy array) and ``scale_zyx_um`` its
    voxel size. Writes ``output_path`` with suffixes ``.npy`` (the PSF) and
    ``.json`` (the report)."""
    import torch

    scale = scale_zyx_um
    if deskew is not None and geometry == "lightsheet":
        from shrimpy_tpu_torch.ops.deskew import deskew_volume, get_deskewed_shape

        raw_shape = tuple(vol.shape)
        vol = deskew_volume(vol, deskew, device=device).cpu().numpy()
        _, scale = get_deskewed_shape(raw_shape, deskew, pixel_size_um=scale[1])
        geometry = "deskewed"
    elif isinstance(vol, torch.Tensor):
        vol = vol.cpu().numpy()

    settings = GEOMETRY_SETTINGS[geometry]
    # Exclude beads whose patch would exceed the volume: extract_psf
    # silently drops them, so detecting them would both inflate
    # n_beads and displace in-bounds beads from the brightness cap.
    border = tuple(k // 2 for k in settings["patch_size_zyx"])
    peaks = detect_beads(
        vol,
        threshold_percentile=threshold_percentile,
        exclude_border=border,
    )
    if len(peaks) == 0:
        raise ValueError(
            "no beads detected away from the patch border; lower "
            "threshold_percentile or use a larger field"
        )
    psf, n_averaged = extract_psf(
        vol, peaks, settings["patch_size_zyx"], return_count=True
    )
    if psf is None:
        raise ValueError("bead patches were empty after background subtraction")

    # n_beads = patches actually averaged (flat/negative patches are
    # dropped by extract_psf), not raw detections.
    report = characterize_psf(
        psf, scale, n_beads=n_averaged,
        axis_labels=tuple(settings["axis_labels"]),
    )
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(output_path.with_suffix(".npy"), psf)
    with open(output_path.with_suffix(".json"), "w") as f:
        json.dump(report.as_dict(), f, indent=2)
    logger.info(
        "measured PSF from %d beads, FWHM(um) zyx=%s",
        report.n_beads,
        [round(v, 3) for v in report.fwhm_um_zyx],
    )
    return report
