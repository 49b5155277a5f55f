"""Viewer feeder: acquisition-side bridge to the monitor process.

Parity with the reference's ``ViewerFeeder`` (``viewer/feeder.py``):
never blocks and never raises into the acquisition (``feeder.py:9-13``),
drops frames when the monitor falls behind (bounded queue,
``:34-42``), sizes the shared-memory ring from a MB budget
(``:178-210``), and runs the consumer in a separate process for crash
isolation. The consumer here is a headless monitor that renders PNG
previews (mid-slice + max-projection) instead of the reference's napari
process — the hardware-free equivalent for a headless GPU host. A copy of
the JAX package's feeder; its spawned monitor runs the port's
:mod:`~shrimpy_tpu_torch.viewer.live`.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as queue_mod
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.viewer.ring import FrameRing

logger = logging.getLogger(__name__)

QUEUE_MAX = 16384  # reference feeder.py:34-42


class ViewerFeeder:
    """Publish acquired volumes to a monitor subprocess, best-effort."""

    def __init__(
        self,
        *,
        frame_shape: tuple[int, int],
        cache_mb: float = 512.0,
        preview_dir: str | Path | None = None,
        preview_interval_s: float = 0.5,
        n_z: int | None = None,
    ):
        self.frame_shape = tuple(frame_shape)
        self.n_slots = FrameRing.slots_for_budget(cache_mb, self.frame_shape)
        if n_z is not None and self.n_slots < n_z + 1:
            # A ring smaller than one volume self-evicts: writing nz
            # consecutive planes into fewer slots laps the volume's own
            # head, so the monitor's seq check rejects EVERY volume and
            # no preview ever renders. The budget is advisory; one
            # resident volume (+1 slot of slack) is the correctness
            # floor (production geometry: 1201 planes x 1.6 MB beats
            # the default 512 MB budget).
            floor = n_z + 1
            logger.warning(
                "viewer cache_mb=%.0f holds only %d frames < one "
                "%d-plane volume; growing the ring to %d slots",
                cache_mb, self.n_slots, n_z, floor,
            )
            self.n_slots = floor
        self.ring: FrameRing | None = None
        self._oversize_warned = False
        self.preview_dir = Path(preview_dir) if preview_dir else None
        self.preview_interval_s = preview_interval_s
        self._queue: mp.Queue | None = None
        self._proc: mp.Process | None = None
        self._seq = 0
        self.dropped = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self.preview_dir is not None:
            # Created parent-side so the contract holds even if the
            # monitor subprocess is still booting when acquisition ends.
            self.preview_dir.mkdir(parents=True, exist_ok=True)
        self.ring = FrameRing(
            None, n_slots=self.n_slots, frame_shape=self.frame_shape
        )
        if self.preview_dir is not None:
            # Ring descriptor + volume index: the attach surface for
            # external monitors (`shrimpy-tpu monitor --live`), the
            # file-based stand-in for the reference's queue handle.
            import json

            # A previous acquisition's volume index references a dead
            # ring (possibly with different slot counts): stale entries
            # would crash or pollute attaching monitors. Unlink BEFORE
            # publishing the new descriptor — a monitor attaching
            # between the two steps must never pair the new ring with
            # the old index.
            (self.preview_dir / "volumes.jsonl").unlink(missing_ok=True)
            (self.preview_dir / "ring.json").write_text(
                json.dumps(
                    {
                        "ring": self.ring.name,
                        "n_slots": self.n_slots,
                        "frame_shape": list(self.frame_shape),
                        "dtype": "float32",
                    }
                )
            )
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue(maxsize=QUEUE_MAX)
        self._proc = ctx.Process(
            target=_monitor_main,
            args=(
                self.ring.name,
                self.n_slots,
                self.frame_shape,
                str(self.preview_dir) if self.preview_dir else None,
                self.preview_interval_s,
                self._queue,
            ),
            daemon=True,
        )
        self._proc.start()
        logger.info(
            "viewer feeder: ring %s (%d slots), monitor pid=%s",
            self.ring.name,
            self.n_slots,
            self._proc.pid,
        )

    def stop(self) -> None:
        if self._queue is not None:
            try:
                self._queue.put_nowait(None)
            except queue_mod.Full:
                pass
        if self._proc is not None:
            self._proc.join(timeout=5)
            if self._proc.is_alive():
                self._proc.terminate()
        if self.ring is not None:
            self.ring.close()

    # -- acquisition-side hook (never raises: feeder.py:9-13) ----------------
    def on_volume(self, vol: np.ndarray, t: int, p, channel: str) -> None:
        """Engine viewer hook: publish each z-plane + a volume message."""
        try:
            if self.ring is None or self._queue is None:
                return
            if vol.shape[0] > self.n_slots:
                # Publishing would lap the volume's own head slots and
                # the monitor would reject it anyway — skip it loudly
                # instead of burning ring bandwidth on garbage.
                if not self._oversize_warned:
                    self._oversize_warned = True
                    logger.warning(
                        "volume has %d planes but the ring holds %d — "
                        "previews skipped; raise cache_mb or pass n_z",
                        vol.shape[0], self.n_slots,
                    )
                self.dropped += 1
                return
            seq0 = self._seq
            slots = []
            for z in range(vol.shape[0]):
                slots.append(self.ring.write(self._seq, vol[z]))
                self._seq += 1
            msg = {"type": "volume", "t": t, "p": str(p), "channel": channel,
                   "slots": slots, "seq0": seq0, "shape": tuple(vol.shape)}
            try:
                self._queue.put_nowait(msg)
            except queue_mod.Full:
                self.dropped += 1
            if self.preview_dir is not None:
                import json

                with open(self.preview_dir / "volumes.jsonl", "a") as f:
                    f.write(json.dumps(msg) + "\n")
        except Exception:
            logger.exception("viewer feeder failed (ignored)")


def _monitor_main(
    ring_name: str,
    n_slots: int,
    frame_shape: tuple[int, int],
    preview_dir: str | None,
    interval_s: float,
    q: mp.Queue,
) -> None:
    """Monitor subprocess: drain messages into a LiveMonitor.

    Renders are rate-limited to one pass per ``interval_s`` but never
    drop the final state: dirty layers accumulate in the monitor and
    are flushed on shutdown (the reference's 100 ms drain timer,
    ``_napari_process.py:47-50,496-509``).
    """
    import queue as _queue
    import time

    from shrimpy_tpu_torch.viewer.live import LiveMonitor

    ring = FrameRing(
        ring_name, n_slots=n_slots, frame_shape=frame_shape, create=False
    )
    out_dir = Path(preview_dir) if preview_dir else None
    monitor = LiveMonitor(ring, out_dir) if out_dir else None
    last_render = 0.0
    def best_effort(fn) -> None:
        # One bad render (e.g. an incomplete deskew.json) must not end
        # previews for the rest of the acquisition.
        try:
            fn()
        except Exception:  # pragma: no cover - best-effort preview
            logging.getLogger(__name__).exception("monitor render failed")

    try:
        while True:
            try:
                msg = q.get(timeout=interval_s)
            except _queue.Empty:
                msg = False  # idle tick: still poll control files
            if msg is None:
                break
            if msg and msg.get("type") == "volume" and monitor is not None:
                monitor.on_volume(msg)
            if monitor is not None:
                best_effort(monitor.refresh_controls)
                now = time.monotonic()
                if now - last_render >= interval_s:
                    last_render = now
                    best_effort(monitor.render_dirty)
        if monitor is not None:
            best_effort(monitor.refresh_controls)
            best_effort(monitor.render_dirty)
    except Exception:  # pragma: no cover - best-effort preview
        logging.getLogger(__name__).exception("monitor loop failed")
    finally:
        ring.close()
