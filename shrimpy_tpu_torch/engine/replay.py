"""Replay source: hardware-free frames from a pre-acquired OME-Zarr.

The counterpart of the reference's ``ReplayCamera``
(``shrimpy/replay_camera.py:86-591``): serves volumes/frames from a
single-FOV or HCS-plate store, with a one-volume LRU cache
(``replay_camera.py:293-308``) and timepoint wrap-around so a replay
plan can run longer than the source recording. The simulated stage
offset (``offset_px_zyx``) rolls the served volume — the seam that lets
tracking corrections visibly re-center a drifting sample in demo mode
(the reference tracks the z-stage the same way, ``:400-438``).

The port's own copy of ``shrimpy_tpu/engine/replay.py`` over the port's
``io/ngff.py`` (on the chunk engine), pinned statement for statement by
``tests/test_torch_config.py`` (``COPIES``).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.io import ngff


class ReplaySource:
    """Volume server over an OME-Zarr store (FOV or HCS plate)."""

    def __init__(self, path: str | Path):
        self.store = ngff.open_ngff(path)
        self.positions = self.store.positions()
        first = next(iter(self.positions.values()))
        self.shape_tczyx = first.shape
        self.channel_names = first.channel_names or [
            str(i) for i in range(self.shape_tczyx[1])
        ]
        self.zyx_scale = first.zyx_scale
        self._cache_key: tuple | None = None
        self._cache_vol: np.ndarray | None = None
        # One-volume LRU cache instrumentation (reference keeps exactly
        # one decoded volume resident, replay_camera.py:293-308).
        self.cache_misses = 0

    @property
    def position_keys(self) -> list[str]:
        return list(self.positions)

    @property
    def n_timepoints(self) -> int:
        return self.shape_tczyx[0]

    def channel_index(self, name: str) -> int:
        return self.channel_names.index(name)

    def volume(
        self,
        position: str,
        t: int,
        c: int,
        *,
        offset_px_zyx: tuple[int, int, int] = (0, 0, 0),
    ) -> np.ndarray:
        """One ZYX volume; ``t`` wraps modulo the source depth.

        ``offset_px_zyx`` simulates the stage offset: the volume is
        rolled by minus the offset (the FOV follows the stage).
        """
        key = (position, t % self.n_timepoints, c)
        if key != self._cache_key:
            pos = self.positions[position]
            vol = np.asarray(pos.volume(key[1], c))
            # Served zero-offset volumes/frames are views into this
            # cache; read-only so an in-place mutation by a caller
            # raises instead of silently corrupting every later read
            # of this (p, t, c).
            vol.flags.writeable = False
            self._cache_vol = vol
            self._cache_key = key
            self.cache_misses += 1
        vol = self._cache_vol
        if any(offset_px_zyx):
            vol = np.roll(
                vol, tuple(-int(round(o)) for o in offset_px_zyx), axis=(0, 1, 2)
            )
        return vol

    def frame(
        self,
        position: str,
        t: int,
        c: int,
        z: int,
        *,
        offset_px_zyx: tuple[int, int, int] = (0, 0, 0),
    ) -> np.ndarray:
        """A single YX plane (snap path, ``replay_camera.py:310-334``).

        Equivalent to ``volume(...)[clip(z)]`` but rolls ONLY the
        selected plane: camera-mode z sweeps snap nz frames per stack,
        and rolling the whole volume per snap would cost O(nz * Z*Y*X)
        copies once any tracking/grid offset is active.
        """
        vol = self.volume(position, t, c)
        oz, oy, ox = (int(round(o)) for o in offset_px_zyx)
        zi = int(np.clip(z, 0, vol.shape[0] - 1))
        plane = vol[(zi + oz) % vol.shape[0]]
        if oy or ox:
            plane = np.roll(plane, (-oy, -ox), axis=(0, 1))
        return plane


@dataclass
class AcqEvent:
    """One acquisition event: which frame the camera serves next.

    The first-party stand-in for a useq ``MDAEvent``: only the fields
    the replay camera consumes (reference ``replay_camera.py:470-521``).
    ``z_um`` is a stage target in micrometres; ``z_index`` addresses the
    source stack directly (sequenced bursts queue indices).
    """

    t: int = 0
    channel: str | None = None
    position: str | None = None
    z_um: float | None = None
    z_index: int | None = None


@dataclass
class SequencedBurst:
    """A hardware-triggered burst: one trigger, many frames.

    Mirrors the reference's ``SequencedEvent`` handling
    (``replay_camera.py:481-502``): timepoint/position/channel come from
    the first sub-event; the z-indices of ALL sub-events are queued and
    popped one per ``snap``.
    """

    events: list[AcqEvent] = field(default_factory=list)


class ReplayCamera:
    """Frame-level camera emulation over a :class:`ReplaySource`.

    Re-creates the reference ``ReplayCamera``'s snap semantics
    (``replay_camera.py:310-362``):

    * free-running mode: ``snap`` serves the current (position, t, c, z)
      and auto-increments the timepoint, wrapping at the dataset depth;
    * z-stage tracking: ``set_z_um`` moves a virtual focus stage; the
      served z index is ``z_center + round((z - origin) / z_step)``,
      clipped to the stack (``:395-438``);
    * event-driven mode: ``on_event`` pins t/position/channel from the
      event; a :class:`SequencedBurst` queues the z indices of all
      sub-events so each subsequent ``snap`` pops the next slice exactly
      as a hardware-sequenced sweep would (``:470-521``).

    The one-volume LRU cache lives in :class:`ReplaySource`, so a full
    z-sweep decodes the source volume once.
    """

    def __init__(self, source: ReplaySource, *, z_step_um: float | None = None):
        self.source = source
        self._nz = source.shape_tczyx[2]
        self._z_center = self._nz // 2
        self._z_step_um = float(z_step_um or source.zyx_scale[0])
        if not self._z_step_um > 0:
            raise ValueError(
                f"z step must be > 0 (got {self._z_step_um}; the store's "
                "NGFF z scale is a placeholder — pass z_step_um explicitly)"
            )
        self._z_origin_um = 0.0
        self._z_um = 0.0
        self._t = 0
        self._c = 0
        self._position = source.position_keys[0]
        self._z_queue: deque[int] = deque()
        self._event_driven = False
        # Simulated stage offset applied to every served frame (the
        # engine moves the "stage" here before each burst; tracking
        # corrections + grid-tile offsets ride this, reference
        # ``replay_camera.py:400-438``).
        self._offset_px_zyx: tuple[int, int, int] = (0, 0, 0)

    def set_stage_offset_px(self, offset_px_zyx: tuple[int, int, int]) -> None:
        self._offset_px_zyx = tuple(int(v) for v in offset_px_zyx)

    # -- z-stage tracking ----------------------------------------------------
    def connect_z_stage(self, origin_um: float = 0.0) -> None:
        """Capture the stage origin; it maps to the stack centre."""
        self._z_origin_um = float(origin_um)
        self._z_um = float(origin_um)

    def set_z_um(self, z_um: float) -> None:
        self._z_um = float(z_um)

    def _z_index(self) -> int:
        offset = round((self._z_um - self._z_origin_um) / self._z_step_um)
        return int(np.clip(self._z_center + offset, 0, self._nz - 1))

    # -- event tracking ------------------------------------------------------
    def on_event(self, event: AcqEvent | SequencedBurst) -> None:
        """Pin camera state from an MDA event; bursts queue z indices."""
        self._event_driven = True
        if isinstance(event, SequencedBurst):
            if not event.events:
                return
            first = event.events[0]
            self._apply_event(first, queue_z=False)
            self._z_queue.clear()
            for sub in event.events:
                if sub.z_index is not None:
                    self._z_queue.append(sub.z_index)
                elif sub.z_um is not None:
                    # A um stage target routes through the SAME z-stage
                    # model as a single event (set_z_um/_z_index), not
                    # a silent center-slice default.
                    self._z_um = float(sub.z_um)
                    self._z_queue.append(self._z_index())
                else:
                    self._z_queue.append(self._z_center)
        else:
            self._z_queue.clear()
            self._apply_event(event, queue_z=True)

    def _apply_event(self, event: AcqEvent, *, queue_z: bool) -> None:
        self._t = event.t
        if event.position is not None:
            if event.position not in self.source.positions:
                raise KeyError(f"unknown position {event.position!r}")
            self._position = event.position
        if event.channel is not None:
            self._c = self.source.channel_index(event.channel)
        if queue_z:
            if event.z_index is not None:
                self._z_queue.append(event.z_index)
            elif event.z_um is not None:
                self._z_um = float(event.z_um)

    # -- snap ----------------------------------------------------------------
    def snap(self) -> np.ndarray:
        """Serve the next frame; sequenced z-queues take precedence."""
        z = self._z_queue.popleft() if self._z_queue else self._z_index()
        frame = self.source.frame(
            self._position, self._t, self._c, z,
            offset_px_zyx=self._offset_px_zyx,
        )
        if not self._event_driven:
            self._t += 1  # free-running auto-increment (``:338-340``)
        return frame

    def snap_volume(self) -> np.ndarray:
        """Full z-sweep at the current state (drains any queued burst)."""
        if self._z_queue:
            return np.stack([self.snap() for _ in range(len(self._z_queue))])
        return np.stack(
            [
                self.source.frame(
                    self._position, self._t, self._c, z,
                    offset_px_zyx=self._offset_px_zyx,
                )
                for z in range(self._nz)
            ]
        )
