"""DynaTrack-parity tracking: shift estimation, limits, journaling
(counterpart of ``shrimpy_tpu/tracking``). The position store and its
update manager are ``tracking/position.py``, the debug artifacts
``tracking/debug.py``; as in the JAX package, this package exports the
tracker's names only."""

from shrimpy_tpu_torch.tracking.core import (  # noqa: F401
    ShiftJournal,
    Tracker,
    TrackerResult,
    apply_dampening,
    apply_limits,
    image_to_stage_shift,
    shift_px_to_um,
)
