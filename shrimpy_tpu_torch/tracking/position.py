"""Position store + async update manager (DynaTrack concurrency parity).

Re-implements the reference's ``shrimpy/dynatrack/position_update.py``:

* :class:`PositionStore` — lock-guarded (x, y, z) coordinates per
  position, returning copies (``position_update.py:44-109``);
* :class:`PositionUpdateManager` — a single-worker executor decoupling
  shift computation from the acquisition loop
  (``position_update.py:272``), **acquisition-baseline capture**: the
  commanded coordinates are frozen per (t, p) when the event executes,
  so a late tracking result is applied against the coordinates the
  stack was actually acquired at, not whatever the store holds by then
  (the event pre-fetch race, ``position_update.py:216-222,324-348``);
  corrections with no baseline are skipped; ``drain_pending`` bounds the
  pipeline depth at timepoint boundaries (``:275-307``), and updater
  exceptions keep the previous position (``:409-413``).

The port's own copy of ``shrimpy_tpu/tracking/position.py``, pinned
statement for statement by ``tests/test_torch_config.py`` (``COPIES``). It
imports only numpy and the standard library at the top (the correction's
``tracking/core.py`` at first use), so it loads on a host with torch alone.

The "worker subprocess" of the reference (own GIL + GPU context,
``worker.py``) maps to a worker thread here. Under torch a thread is
enough: a kernel launch returns once it is queued, and the waits that
follow (``.cpu()`` of the three shift numbers, a stream synchronize)
release the GIL while the card works, so the acquisition thread keeps
running beside the worker. Crash isolation is handled by the exception
policy. CUDA's current device is a per-thread setting: the worker thread
starts on device 0, whatever ``torch.cuda.set_device`` the acquisition
thread made. With one card that is the card; an updater that must run on
another device names it on its tensors (``Tracker(device=...)``,
``Preprocessor(device=...)``) instead of relying on the current device.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Position:
    x: float
    y: float
    z: float

    def as_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], dtype=np.float64)


class PositionStore:
    """Thread-safe per-position coordinates; reads return copies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._positions: dict[str, Position] = {}

    def set(self, key: str, x: float, y: float, z: float) -> None:
        with self._lock:
            self._positions[key] = Position(float(x), float(y), float(z))

    def get(self, key: str) -> Position | None:
        with self._lock:
            return self._positions.get(key)

    def update(self, key: str, dx: float, dy: float, dz: float) -> Position:
        """Atomically add a delta; creates the position at the delta if new."""
        with self._lock:
            cur = self._positions.get(key, Position(0.0, 0.0, 0.0))
            new = Position(cur.x + dx, cur.y + dy, cur.z + dz)
            self._positions[key] = new
            return new

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._positions)

    def snapshot(self) -> dict[str, Position]:
        with self._lock:
            return dict(self._positions)


class PositionUpdateManager:
    """Asynchronous shift-update executor with baseline bookkeeping.

    ``updater(stack, t, p) -> stage_shift_xyz (um)`` is the pluggable
    computation (a :class:`shrimpy_tpu_torch.tracking.Tracker` adapter in
    production, a fake in tests — the reference's injected-updater seam,
    ``manager.py:62-68``).
    """

    def __init__(
        self,
        store: PositionStore,
        updater,
        *,
        drain_timeout_s: float = 120.0,
    ):
        self.store = store
        self.updater = updater
        self.drain_timeout_s = drain_timeout_s
        # Single worker: updates are serialized, at most one stack of
        # frames in flight (reference position_update.py:272,415-429).
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._baselines: dict[tuple[int, str], np.ndarray] = {}
        self._pending: list[Future] = []
        self._lock = threading.Lock()
        self._shutdown = False

    # -- baseline capture (the pre-fetch race fix) ---------------------------
    def record_acquisition(self, t: int, p: str) -> None:
        """Freeze the commanded coordinates for (t, p) at acquisition time."""
        pos = self.store.get(p)
        if pos is not None:
            with self._lock:
                self._baselines[(t, p)] = pos.as_array()

    def on_stack_complete(self, stack: np.ndarray, t: int, p: str) -> Future:
        """Submit the shift computation for a completed (t, p) stack."""
        if self._shutdown:
            raise RuntimeError("PositionUpdateManager is shut down")
        fut = self._executor.submit(self._compute_and_apply, stack, t, p)
        with self._lock:
            self._pending.append(fut)
            self._pending = [f for f in self._pending if not f.done()]
        return fut

    def _compute_and_apply(self, stack: np.ndarray, t: int, p: str) -> bool:
        with self._lock:
            baseline = self._baselines.pop((t, p), None)
        if baseline is None:
            # No commanded-coords baseline: applying a correction could
            # race a pre-fetched move; skip (position_update.py:326-348).
            logger.warning("no baseline for t=%d p=%s; skipping correction", t, p)
            return False
        try:
            stage_shift_xyz = np.asarray(self.updater(stack, t, p), dtype=np.float64)
        except Exception:
            # Keep the previous position on updater failure
            # (position_update.py:409-413).
            logger.exception("updater failed for t=%d p=%s; keeping position", t, p)
            return False
        from shrimpy_tpu_torch.tracking.core import corrected_position

        corrected = corrected_position(baseline, stage_shift_xyz)
        self.store.set(p, *corrected)
        logger.info(
            "position %s corrected by %s -> %s", p, stage_shift_xyz, corrected
        )
        return True

    # -- backpressure --------------------------------------------------------
    def drain_pending(self, timeout_s: float | None = None) -> bool:
        """Block until all submitted updates finish (timepoint boundary).

        Returns False when the drain timed out (logged and swallowed,
        reference ``position_update.py:285-287``).
        """
        timeout = timeout_s if timeout_s is not None else self.drain_timeout_s
        with self._lock:
            pending = list(self._pending)
        ok = True
        for fut in pending:
            try:
                fut.result(timeout=timeout)
            except TimeoutError:
                logger.error("drain_pending timed out after %.0fs", timeout)
                ok = False
            except Exception:
                logger.exception("pending update failed")
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
        return ok

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown = True
        self._executor.shutdown(wait=wait)
