"""POSIX shared-memory frame ring (reference ``viewer/ring_buffer.py``).

One slot per frame; writers overwrite the oldest slot; readers may
observe a slot mid-overwrite — explicitly accepted for best-effort
preview, exactly the reference's contract (``ring_buffer.py:10-12``).
A per-slot sequence counter lets readers detect torn frames after the
fact. ``read_rows`` gathers a single tilt row across all scan slots for
the live deskew preview at a fraction of the volume's footprint
(``ring_buffer.py:98-112``).

The hot write/read path runs through the native seqlock core
(``shrimpy_tpu_torch/native/ring.c``) when a C compiler is available — the
role the reference fills with Micro-Manager's C++ circular buffer.
The native path adds the memory fences the numpy stores lack (a
reader on another core may otherwise observe the published sequence
before the frame bytes) and releases the GIL for the frame memcpy.
``SHRIMPY_NATIVE_RING=0`` forces the pure-numpy fallback, which keeps
the identical layout and torn-detection protocol minus the fences.
A copy of the JAX package's ring over the port's own build of the same
``ring.c``: either package attaches to a ring the other wrote.
"""

from __future__ import annotations

import logging
from multiprocessing import shared_memory

import numpy as np

from shrimpy_tpu_torch.native import load_ring

logger = logging.getLogger(__name__)

_HEADER_DTYPE = np.int64  # per-slot sequence number


class FrameRing:
    """Fixed-capacity ring of equally-shaped frames in shared memory."""

    def __init__(
        self,
        name: str | None,
        *,
        n_slots: int,
        frame_shape: tuple[int, int],
        dtype: str = "float32",
        create: bool = True,
    ):
        self.n_slots = int(n_slots)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        frame_bytes = int(np.prod(self.frame_shape)) * self.dtype.itemsize
        header_bytes = self.n_slots * np.dtype(_HEADER_DTYPE).itemsize
        total = header_bytes + self.n_slots * frame_bytes
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=total, name=name)
        else:
            assert name is not None
            self.shm = shared_memory.SharedMemory(name=name)
            # Non-owner handles must not let Python's resource tracker
            # unlink the segment when this process exits — only the
            # creator owns the lifetime (the reference carries the same
            # workaround, ring_buffer.py:69-78).
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self.shm._name, "shared_memory")
            except Exception:  # pragma: no cover - best effort
                logger.debug("resource_tracker unregister failed", exc_info=True)
        self._seq = np.ndarray(
            (self.n_slots,), dtype=_HEADER_DTYPE, buffer=self.shm.buf[:header_bytes]
        )
        self._frames = np.ndarray(
            (self.n_slots, *self.frame_shape),
            dtype=self.dtype,
            buffer=self.shm.buf[header_bytes:],
        )
        if create:
            self._seq[:] = -1
        self._owner = create
        self._lib = load_ring()
        self._frame_bytes = frame_bytes

    @property
    def name(self) -> str:
        return self.shm.name

    # -- write side ----------------------------------------------------------
    def write(self, seq: int, frame: np.ndarray) -> int:
        """Write frame with global sequence ``seq``; returns the slot."""
        slot = seq % self.n_slots
        if self._lib is not None:
            src = np.ascontiguousarray(frame, dtype=self.dtype)
            if src.shape == self.frame_shape:
                self._lib.shrimpy_ring_write(
                    self._seq.ctypes.data,
                    self._frames.ctypes.data,
                    self.n_slots,
                    self._frame_bytes,
                    int(seq),
                    src.ctypes.data,
                )
                return slot
        self._seq[slot] = -1  # torn-frame marker while writing
        self._frames[slot] = frame
        self._seq[slot] = seq
        return slot

    # -- read side -----------------------------------------------------------
    def read(self, slot: int) -> tuple[int, np.ndarray]:
        """(sequence, frame copy); sequence -1 marks a torn slot."""
        if self._lib is not None:
            out = np.empty(self.frame_shape, self.dtype)
            got = self._lib.shrimpy_ring_read(
                self._seq.ctypes.data,
                self._frames.ctypes.data,
                self.n_slots,
                self._frame_bytes,
                int(slot),
                out.ctypes.data,
            )
            return int(got), out
        seq = int(self._seq[slot])
        frame = self._frames[slot].copy()
        # Torn if overwritten while copying.
        if int(self._seq[slot]) != seq:
            seq = -1
        return seq, frame

    def latest(self) -> tuple[int, np.ndarray] | None:
        if self._seq.max() < 0:
            return None
        return self.read(int(np.argmax(self._seq)))

    def read_rows(self, row: int, slots: list[int | None]) -> np.ndarray:
        """Gather one Y-row from each listed slot -> (len(slots), X).

        The deskew-preview gather: one tilt row across the scan stack
        (~MBs instead of ~GBs, reference ``ring_buffer.py:98-112``).
        ``None`` slots (missing frames) yield a zero row, and present
        slots gather in ONE fancy-index copy — a per-slot Python loop
        over a production scan (~1200 slots) costs 1200 separate
        indexing ops per preview tick.
        """
        out = np.zeros((len(slots), self._frames.shape[2]), self._frames.dtype)
        if self._lib is not None:
            slot_arr = np.asarray(
                [-1 if s is None else int(s) for s in slots], np.int64
            )
            row_bytes = self._frames.shape[2] * self.dtype.itemsize
            self._lib.shrimpy_ring_read_rows(
                self._frames.ctypes.data,
                self._frame_bytes,
                int(row) * row_bytes,
                row_bytes,
                slot_arr.ctypes.data,
                len(slots),
                out.ctypes.data,
            )
            return out
        present = [i for i, s in enumerate(slots) if s is not None]
        if present:
            idx = [slots[i] for i in present]
            out[present] = self._frames[idx, row, :]
        return out

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self.shm.close()
        if self._owner:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass

    @staticmethod
    def slots_for_budget(
        cache_mb: float, frame_shape: tuple[int, int], dtype: str = "float32"
    ) -> int:
        """Slot count for a memory budget (reference ``feeder.py:178-210``)."""
        frame_bytes = int(np.prod(frame_shape)) * np.dtype(dtype).itemsize
        return max(2, int(cache_mb * 1024 * 1024 / max(frame_bytes, 1)))
