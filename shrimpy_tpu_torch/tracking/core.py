"""Tracking core: shift computation, limits/dampening, stage mapping, journal
(counterpart of ``shrimpy_tpu/tracking/core.py``).

The host post-processing (:func:`shift_px_to_um`, :func:`apply_limits`,
:func:`apply_dampening`, :func:`image_to_stage_shift`,
:func:`corrected_position`, :func:`process_shift`), the CSV journal
(:data:`JOURNAL_FIELDS`, :class:`ShiftJournal`) and :class:`TrackerResult`
are copies of the JAX module's, pinned statement for statement by
``tests/test_torch_tracking.py``.

:class:`Tracker` runs the six methods of the JAX tracker on tensors, on the
card unless its ``device`` says otherwise: the stack stays where it is, and
only the shifts (three numbers) leave the device. Each position's reference
stays on the host, in pinned memory when the card holds the stack (a
deskewed production stack is 2.37 GB, and a 96-position plate would not fit
the card), and goes to the device at each update; ``timer`` holds the
seconds of both moves (``reference_to_host``, ``reference_to_device``).
``template_matching`` moves only its template window. ``roi_center_pcc``'s
Gaussian-blob template is built on the stack's device
(:func:`_gaussian_blob`, the float32 arithmetic of
``io/synthetic.py::gaussian_blob``; the port's ``io/synthetic.py`` imports
the store layer, ``io/ngff.py``). With ``config.debug`` on, a
``debug_writer`` (``tracking/debug.py::DebugWriter``) records each updated
stack where the JAX tracker records it; the stack goes to the host for it.
"""

from __future__ import annotations

import csv
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from shrimpy_tpu_torch.ops.features import (
    center_of_mass,
    gaussian_blur,
    histogram_percentile,
    otsu_component_mask,
)
from shrimpy_tpu_torch.ops.match import template_match_shift
from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
from shrimpy_tpu_torch.utils.device import as_tensor
from shrimpy_tpu_torch.utils.timing import StageTimer

if TYPE_CHECKING:
    from shrimpy_tpu_torch.config.schemas import ShiftSettings

AXES = ("z", "y", "x")


# ---------------------------------------------------------------------------
# Pure shift post-processing (host copies)
# ---------------------------------------------------------------------------


def shift_px_to_um(
    shift_px_zyx: np.ndarray, scale_zyx_um: tuple[float, float, float]
) -> np.ndarray:
    """Pixel shift -> microns via the per-axis voxel size."""
    return np.asarray(shift_px_zyx, dtype=np.float64) * np.asarray(scale_zyx_um)


def apply_limits(
    shift_um_zyx: np.ndarray, limits: dict[str, tuple[float, float]] | None
) -> np.ndarray:
    """Deadband + clip per axis: ``limits[axis] = (lo, hi)`` in microns;
    |shift| < lo -> 0; |shift| > hi -> clip to hi preserving sign."""
    out = np.asarray(shift_um_zyx, dtype=np.float64).copy()
    if not limits:
        return out
    for i, axis in enumerate(AXES):
        if axis not in limits:
            continue
        lo, hi = limits[axis]
        mag = abs(out[i])
        if mag < lo:
            out[i] = 0.0
        elif mag > hi:
            out[i] = np.sign(out[i]) * hi
    return out


def apply_dampening(
    shift_um_zyx: np.ndarray, dampening: tuple[float, float, float] | None
) -> np.ndarray:
    """Multiply the (z, y, x) shift by per-axis gains."""
    if dampening is None:
        return np.asarray(shift_um_zyx, dtype=np.float64)
    return np.asarray(shift_um_zyx, dtype=np.float64) * np.asarray(dampening)


def image_to_stage_shift(
    shift_um_zyx: np.ndarray, matrix_xyz: np.ndarray | list | None
) -> np.ndarray:
    """Map an image-frame ZYX shift to stage axes (XYZ order) by the 3x3
    ``image_to_stage_matrix_xyz``; identity when no matrix is set."""
    shift_xyz = np.asarray(shift_um_zyx, dtype=np.float64)[::-1]
    if matrix_xyz is None:
        return shift_xyz
    return np.asarray(matrix_xyz, dtype=np.float64) @ shift_xyz


def corrected_position(
    baseline_xyz: np.ndarray, stage_shift_xyz: np.ndarray
) -> np.ndarray:
    """Baseline-relative correction: commanded position minus drift."""
    return np.asarray(baseline_xyz, dtype=np.float64) - np.asarray(stage_shift_xyz)


def process_shift(
    shift_px_zyx: np.ndarray,
    *,
    scale_zyx_um: tuple[float, float, float],
    settings: ShiftSettings,
    matrix_xyz: np.ndarray | list | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """px -> um -> limits -> dampening -> stage:
    ``(shift_um_zyx, stage_shift_xyz)``."""
    um = shift_px_to_um(shift_px_zyx, scale_zyx_um)
    um = apply_limits(um, settings.limits)
    um = apply_dampening(um, settings.dampening)
    return um, image_to_stage_shift(um, matrix_xyz)


# ---------------------------------------------------------------------------
# Shift journal (host copy)
# ---------------------------------------------------------------------------

JOURNAL_FIELDS = (
    "wall_time",
    "timepoint",
    "position",
    "method",
    "shift_z_px",
    "shift_y_px",
    "shift_x_px",
    "shift_z_um",
    "shift_y_um",
    "shift_x_um",
    "stage_dx_um",
    "stage_dy_um",
    "stage_dz_um",
    "reanchored",
)


class ShiftJournal:
    """Append-only CSV journal of every computed shift, written right
    after each computation so a crash loses at most one row."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self.path.exists():
            with open(self.path, "w", newline="") as f:
                csv.writer(f).writerow(JOURNAL_FIELDS)

    def append(
        self,
        *,
        timepoint: int,
        position: int | str,
        method: str,
        shift_px_zyx,
        shift_um_zyx,
        stage_shift_xyz,
        reanchored: bool,
    ) -> None:
        row = [
            f"{time.time():.3f}",
            timepoint,
            position,
            method,
            *(f"{v:.4f}" for v in shift_px_zyx),
            *(f"{v:.4f}" for v in shift_um_zyx),
            *(f"{v:.4f}" for v in stage_shift_xyz),
            int(reanchored),
        ]
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def rows(self) -> list[dict[str, str]]:
        with open(self.path, newline="") as f:
            return list(csv.DictReader(f))


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------


@dataclass
class TrackerResult:
    shift_px_zyx: np.ndarray
    shift_um_zyx: np.ndarray
    stage_shift_xyz: np.ndarray
    reanchored: bool
    skipped: bool = False


def _gaussian_blob(shape_zyx, center_zyx, sigma_zyx, *, device, dtype: torch.dtype,
                   amplitude: float = 1000.0) -> torch.Tensor:
    """``io/synthetic.py::gaussian_blob`` on ``device`` in ``dtype``: one
    separable 3-D Gaussian, each factor from an ``arange`` in ``dtype``."""
    g = [torch.exp(-0.5 * ((torch.arange(n, dtype=dtype, device=device) - c) / s) ** 2)
         for n, c, s in zip(shape_zyx, center_zyx, sigma_zyx)]
    return amplitude * g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]


@dataclass
class Tracker:
    """Holds the references and applies the configured method.

    ``update(stack, t, p)`` returns the processed shift for one
    (timepoint, position) volume; the caller owns stage motion. ``stack``
    is a tensor, which stays on its device unless ``device`` moves it, or a
    numpy array, which goes to ``device`` (the card when None; ``"cpu"``
    asks for the CPU). ``dtype`` is the arithmetic's type (float64 for a
    reference run). ``config`` is a ``DynaTrackConfig`` of either package
    or :func:`shrimpy_tpu_torch.config.dynatrack_settings`.
    """

    config: object
    scale_zyx_um: tuple[float, float, float] = (1.0, 1.0, 1.0)
    journal: ShiftJournal | None = None
    debug_writer: object | None = None  # tracking.debug.DebugWriter
    device: str | torch.device | None = None
    dtype: torch.dtype = torch.float32
    timer: StageTimer = field(default_factory=StageTimer)
    _references: dict = field(default_factory=dict)  # per-position host tensors
    # (shape, sigma, device, dtype) -> blob template (roi_center_pcc)
    _template_cache: dict = field(default_factory=dict)

    def update(self, stack_zyx, t: int, p: int | str = 0) -> TrackerResult:
        cfg = self.config
        if cfg.tracking_interval > 1 and t % cfg.tracking_interval != 0:
            # Distinct arrays: a caller mutating one field in place
            # (e.g. accumulating drift) must not corrupt the others.
            return TrackerResult(
                np.zeros(3), np.zeros(3), np.zeros(3),
                reanchored=False, skipped=True,
            )
        stack = as_tensor(stack_zyx, self.device).to(self.dtype)

        shift_px, reanchored = self._compute_shift(stack, t, p)
        shift_um, stage_xyz = process_shift(
            shift_px,
            scale_zyx_um=self.scale_zyx_um,
            settings=cfg.shift,
            matrix_xyz=cfg.image_to_stage_matrix_xyz,
        )
        if self.journal is not None:
            self.journal.append(
                timepoint=t,
                position=p,
                method=cfg.tracking_method,
                shift_px_zyx=shift_px,
                shift_um_zyx=shift_um,
                stage_shift_xyz=stage_xyz,
                reanchored=reanchored,
            )
        if self.debug_writer is not None and cfg.debug:
            # Debug artifacts (reference tracking.py:1315-1474).
            self.debug_writer.record(
                stack.cpu().numpy(), t, str(p), shift_px_zyx=shift_px
            )
        return TrackerResult(shift_px, shift_um, stage_xyz, reanchored)

    def _compute_shift(self, stack: torch.Tensor, t: int, p: int | str
                       ) -> tuple[np.ndarray, bool]:
        cfg = self.config
        method = cfg.tracking_method

        if method == "intensity_center_of_mass":
            return self._roi_center_shift(stack, use_otsu=False), False
        if method == "multiotsu_center_of_mass":
            return self._roi_center_shift(stack, use_otsu=True), False
        if method == "roi_center_pcc":
            return self._roi_template_pcc(stack), False

        # Reference-based methods: pcc / multiotsu_pcc / template_matching.
        target = stack
        if method == "multiotsu_pcc":
            mask, blurred = otsu_component_mask(
                stack,
                component=cfg.segmentation.otsu_component,
                sigma=cfg.segmentation.otsu_sigma,
                dtype=self.dtype,
            )
            target = mask * blurred

        ref = self._references.get(p)
        interval = cfg.reference_update_interval
        if ref is None or (interval > 0 and t > 0 and t % interval == 0):
            # (Re)anchor: adopt the current stack as the new reference and
            # apply NO correction this timepoint (the reference's policy:
            # correcting against a reference about to be discarded would be
            # re-measured against the new anchor and applied twice).
            self._references[p] = self._keep_on_host(target, ref)
            return np.zeros(3), True

        if method == "template_matching":
            # Same sign convention as PCC (positive = object moved positive).
            shift = template_match_shift(ref, target, cfg.template.slice_zyx,
                                         dtype=self.dtype)
            return shift, False

        with self.timer.stage("reference_to_device", log=False):
            ref = ref.to(target.device, non_blocking=True)
        shift = phase_cross_correlation(
            ref, target, maximum_shift=cfg.shift.maximum, dtype=self.dtype
        ).astype(np.float64)
        return shift, False

    def _keep_on_host(self, target: torch.Tensor, old: torch.Tensor | None) -> torch.Tensor:
        """A host copy of ``target`` (callers may reuse their buffers), into
        ``old`` where it has the shape and type, else into new memory,
        pinned when ``target`` is on the card."""
        with self.timer.stage("reference_to_host", log=False):
            if old is None or old.shape != target.shape or old.dtype != target.dtype:
                old = torch.empty(target.shape, dtype=target.dtype,
                                  pin_memory=target.is_cuda)
            return old.copy_(target)

    def _roi_center_shift(self, stack: torch.Tensor, use_otsu: bool) -> np.ndarray:
        """Referenceless: displacement of the mass centre from the volume
        centre; positive means the object moved in the positive direction."""
        cfg = self.config
        if use_otsu:
            weights, _ = otsu_component_mask(
                stack,
                component=cfg.segmentation.otsu_component,
                sigma=cfg.segmentation.otsu_sigma,
                dtype=self.dtype,
            )
        else:
            vol = stack
            rc = cfg.roi_center
            if rc.blur_sigma > 0:
                vol = gaussian_blur(vol, rc.blur_sigma, dtype=self.dtype)
            if rc.background_percentile is not None:
                vol = vol - histogram_percentile(vol, rc.background_percentile,
                                                 dtype=self.dtype)
            # Clamp even without a background floor: negative values (phase
            # data) must not pull the centroid the wrong way.
            weights = torch.clamp(vol, min=0.0)
        com = center_of_mass(weights, dtype=self.dtype).cpu().numpy().astype(np.float64)
        center = (np.asarray(stack.shape, dtype=np.float64) - 1.0) / 2.0
        return com - center

    def _roi_template_pcc(self, stack: torch.Tensor) -> np.ndarray:
        """Referenceless PCC against a centred Gaussian-blob template."""
        sigma = self.config.roi_center.blob_sigma
        # The template depends only on (shape, sigma): built once on the
        # stack's device, one geometry live at a time.
        cache_key = (tuple(stack.shape), float(sigma), stack.device, stack.dtype)
        template = self._template_cache.get(cache_key)
        if template is None:
            center = tuple((n - 1) / 2.0 for n in stack.shape)
            template = _gaussian_blob(stack.shape, center, (sigma,) * 3,
                                      device=stack.device, dtype=stack.dtype)
            self._template_cache.clear()
            self._template_cache[cache_key] = template
        # PCC(template, stack) = displacement of the object from the volume
        # centre: the convention of com - center above.
        return phase_cross_correlation(
            template, stack, maximum_shift=self.config.shift.maximum, dtype=self.dtype
        ).astype(np.float64)

    # -- reference management ------------------------------------------------
    def reset_reference(self, p: int | str | None = None) -> None:
        if p is None:
            self._references.clear()
        else:
            self._references.pop(p, None)

    def has_reference(self, p: int | str = 0) -> bool:
        return p in self._references
