"""DynaTrack-parity tracking: shift estimation, limits, journaling
(counterpart of ``shrimpy_tpu/tracking``; ``position.py`` and ``debug.py``
are ROADMAP queue 1 item 12)."""

from shrimpy_tpu_torch.tracking.core import (  # noqa: F401
    ShiftJournal,
    Tracker,
    TrackerResult,
    apply_dampening,
    apply_limits,
    image_to_stage_shift,
    shift_px_to_um,
)
