"""Live deskew preview from ring-buffer row gathers.

The reference previews deskewed side views during acquisition by
gathering ONE tilt row across all scan slots of the shared-memory ring
(~MBs instead of the full volume, reference ``ring_buffer.py:98-112``
+ the external ``napari-deskew-preview`` package,
``_napari_process.py:22-28,202-291``).

Geometry: at fixed tilt row ``t``, the lab coordinates of raw samples
are ``z = t sin(theta)`` (constant) and ``y = s / r + t cos(theta)`` —
a single tilt row IS a single lab z-plane, just stretched by ``1/r``
along scan. The preview is therefore a cheap 1-D resample, no volume
deskew needed.

The JAX package's module but for two named differences, pinned by
``tests/test_torch_viewer.py``: ``settings`` is annotated by name only (no
import of ``config.schemas``, so no pydantic), and its ratio is read with
``config.require_ratio(settings)``: a pydantic ``DeskewSettings`` and a
namespace (``config.deskew_settings``) alike.
"""

from __future__ import annotations

import math

import numpy as np

from shrimpy_tpu_torch.config import require_ratio


def deskew_preview_plane(
    rows_sx: np.ndarray, settings: "DeskewSettings"
) -> np.ndarray:
    """(scan, X) gathered tilt-row stack -> lab-frame (y, X) plane.

    Linear 1-D resample of the scan axis onto the isotropic lab grid
    (spacing = camera pixel): ``y_lab = s / px_to_scan_ratio``.
    """
    r = require_ratio(settings)
    ns, nx = rows_sx.shape
    ny = int(math.floor((ns - 1) / r)) + 1
    y = np.arange(ny, dtype=np.float64)
    s = y * r
    s0 = np.floor(s).astype(np.int64)
    frac = (s - s0).astype(np.float32)
    s0 = np.clip(s0, 0, ns - 1)
    s1 = np.clip(s0 + 1, 0, ns - 1)
    rows = np.asarray(rows_sx, np.float32)
    return (1.0 - frac)[:, None] * rows[s0] + frac[:, None] * rows[s1]


def preview_from_ring(
    ring, slots: list[int], tilt_row: int, settings: "DeskewSettings"
) -> np.ndarray:
    """Gather ``tilt_row`` across the scan ``slots`` and deskew it.

    ``slots`` are the ring slots of one volume's frames in scan order
    (the feeder's per-volume slot list).
    """
    rows = ring.read_rows(tilt_row, slots)
    return deskew_preview_plane(rows, settings)
