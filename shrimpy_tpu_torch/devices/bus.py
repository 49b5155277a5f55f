"""Virtual serial transport for the device-control layer.

The reference drives its physical instruments over serial transports
through vendor libraries (copylot's VortranLaser, pylablib's
KinesisPiezoMotor — reference
``shrimpy/mantis/archive/pycromanager/microscope_operations.py:296-358,617-635``).
A GPU host has no instrument bus, so this build keeps the DRIVER layer
real — byte-level wire protocols, framing, parsing, error handling —
and virtualizes only the TRANSPORT: a :class:`VirtualSerialPort` is an
in-process byte pipe whose far end is a protocol emulator. Swapping in
a physical ``pyserial`` port is a constructor argument; every driver
in this package talks to the :class:`SerialTransport` interface only.

Ports are named (``COM4``-style or any string) and bound in a process
registry so configuration can reference them the way the reference
references COM ports (``acq_engine.py:775-787``).
"""

from __future__ import annotations

import threading
from typing import Callable, Protocol


class SerialTransport(Protocol):
    """The byte-level contract drivers are written against."""

    def write(self, data: bytes) -> None: ...

    def read_until(self, terminator: bytes, timeout_s: float) -> bytes: ...

    def close(self) -> None: ...


class VirtualSerialPort:
    """In-process serial port: writes are handed to a device-side
    protocol handler, whose reply bytes become the read stream.

    The handler runs synchronously inside :meth:`write` (an instrument
    answering on its own clock adds nothing to protocol-level tests)
    but the read buffer is locked so a driver polled from another
    thread (e.g. the engine's watchdog) stays consistent.
    """

    def __init__(self, handler: Callable[[bytes], bytes],
                 handler_lock: "threading.Lock | None" = None):
        self._handler = handler
        # One emulator instance can back several ports (repeated opens
        # of the same port name = one physical instrument, the
        # replay-dual sharing model). Its handler mutates shared
        # device state, so all ports of one instrument must serialize
        # through the same lock — otherwise two arm engines writing
        # concurrently can interleave inside handle() and one arm
        # drains the other's reply. Drivers write whole
        # commands/frames per write() call, so under the lock each
        # write's reply routes back to its own port.
        self._handler_lock = handler_lock or threading.Lock()
        self._rx = bytearray()
        self._lock = threading.Lock()
        self._closed = False

    def write(self, data: bytes) -> None:
        if self._closed:
            raise OSError("port is closed")
        with self._handler_lock:
            reply = self._handler(bytes(data))
        if reply:
            with self._lock:
                self._rx.extend(reply)

    def read_until(self, terminator: bytes, timeout_s: float = 1.0) -> bytes:
        """Read through ``terminator``. The virtual far end replies
        inline, so data is either present or never coming — a missing
        terminator is a protocol error, not a wait."""
        if self._closed:
            raise OSError("port is closed")
        with self._lock:
            idx = self._rx.find(terminator)
            if idx < 0:
                raise TimeoutError(
                    f"no {terminator!r} in reply buffer "
                    f"(have {bytes(self._rx)!r})"
                )
            end = idx + len(terminator)
            out = bytes(self._rx[:end])
            del self._rx[:end]
            return out

    def read_exact(self, n: int, timeout_s: float = 1.0) -> bytes:
        if self._closed:
            raise OSError("port is closed")
        with self._lock:
            if len(self._rx) < n:
                raise TimeoutError(
                    f"wanted {n} bytes, have {len(self._rx)}"
                )
            out = bytes(self._rx[:n])
            del self._rx[:n]
            return out

    def close(self) -> None:
        self._closed = True


_PORTS: dict[str, Callable[[], VirtualSerialPort]] = {}
_PORTS_LOCK = threading.Lock()


def bind_port(name: str, factory: Callable[[], VirtualSerialPort]) -> None:
    """Register a port name -> emulator-backed port factory (one fresh
    port per open, like re-opening a physical COM port)."""
    with _PORTS_LOCK:
        _PORTS[name] = factory


def open_port(name: str) -> VirtualSerialPort:
    with _PORTS_LOCK:
        factory = _PORTS.get(name)
    if factory is None:
        raise FileNotFoundError(
            f"no device bound on port {name!r} "
            f"(bound: {sorted(_PORTS)}); bind an emulator with "
            "shrimpy_tpu_torch.devices.bus.bind_port or pass a transport "
            "object directly"
        )
    return factory()


def unbind_all() -> None:
    """Test hook: clear the registry."""
    with _PORTS_LOCK:
        _PORTS.clear()
