"""DynaTrack debug artifacts: preprocessed-stack store + overlay PNGs.

Parity with the reference's debug outputs (reference
``shrimpy/dynatrack/tracking.py:1315-1474``): when ``debug`` is on, the
tracker persists every tracked stack (HCS-layout ``dynatrack_debug.zarr``,
one well per position, timepoints appended) and saves a mid-slice PNG
with the detected shift/centroid overlaid — the artifacts an operator
inspects when tracking misbehaves.

The port's own copy of ``shrimpy_tpu/tracking/debug.py`` over the port's
``io/ngff.py``, pinned statement for statement by
``tests/test_torch_config.py`` (``COPIES``). :meth:`DebugWriter.record`
takes a host array: the port's ``Tracker`` hands it the stack's host copy.
A PNG that matplotlib cannot draw (or a host without matplotlib) is
logged and skipped; the store write does not depend on it.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.io import ngff

logger = logging.getLogger(__name__)


class DebugWriter:
    """Accumulates per-(t, p) debug stacks and overlay images."""

    def __init__(self, out_dir: str | Path, *, max_timepoints: int = 256):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.store_path = self.out_dir / "dynatrack_debug.zarr"
        self.max_timepoints = max_timepoints
        self._store: ngff.NgffStore | None = None
        self._positions: dict[str, ngff.NgffPosition] = {}
        self._cap_warned = False
        # A previous run's debug store in the same directory would make
        # every create_array fail with ALREADY_EXISTS — and because the
        # never-raise guard spans the whole record(), that silently
        # killed the PNGs too. Each run starts a fresh store.
        if self.store_path.exists():
            import shutil

            shutil.rmtree(self.store_path, ignore_errors=True)

    def _position(self, p: str, shape_zyx: tuple[int, int, int]) -> ngff.NgffPosition:
        if self._store is None:
            self._store = ngff.create_hcs(
                self.store_path, channel_names=["tracked"]
            )
        key = str(p).replace("/", "_")
        if key not in self._positions:
            pos = self._store.create_position("debug", key, "000",
                                              channel_names=["tracked"])
            pos.create_array(
                (self.max_timepoints, 1, *shape_zyx), dtype="float32"
            )
            self._positions[key] = pos
        return self._positions[key]

    def record(
        self,
        stack_zyx: np.ndarray,
        t: int,
        p: str,
        *,
        shift_px_zyx: np.ndarray | None = None,
        center_zyx: np.ndarray | None = None,
    ) -> None:
        """Persist one tracked stack + its overlay PNG (never raises)."""
        try:
            stack = np.asarray(stack_zyx, np.float32)
            if t < self.max_timepoints:
                self._position(p, tuple(stack.shape)).write((t, 0), stack)
            elif not self._cap_warned:
                # Fire-once on ANY t past the cap (tracking_interval > 1
                # skips exact-equality timepoints).
                self._cap_warned = True
                logger.warning(
                    "dynatrack debug store capped at %d timepoints; "
                    "later stacks keep PNG overlays only",
                    self.max_timepoints,
                )
            self._overlay_png(stack, t, p, shift_px_zyx, center_zyx)
        except Exception:
            logger.exception("dynatrack debug output failed (ignored)")

    def _overlay_png(self, stack, t, p, shift, center) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mid = stack[stack.shape[0] // 2]
        fig, ax = plt.subplots(figsize=(4, 4))
        ax.imshow(mid, cmap="gray")
        cy, cx = (mid.shape[0] - 1) / 2, (mid.shape[1] - 1) / 2
        if center is not None:
            ax.plot(center[2], center[1], "r+", markersize=12, label="centroid")
        if shift is not None and np.any(shift):
            ax.annotate(
                "",
                xy=(cx + shift[2], cy + shift[1]),
                xytext=(cx, cy),
                arrowprops=dict(color="cyan", arrowstyle="->", lw=2),
            )
        title = f"t={t} p={p}"
        if shift is not None:
            title += f"  shift(zyx)={np.round(np.asarray(shift), 2).tolist()}"
        ax.set_title(title, fontsize=8)
        ax.axis("off")
        name = f"debug_t{t:04d}_p{str(p).replace('/', '_')}.png"
        fig.savefig(self.out_dir / name, dpi=72, bbox_inches="tight")
        plt.close(fig)
