"""Vortran Stradus laser driver + emulator (ASCII serial protocol).

The reference controls its excitation lasers through copylot's
``VortranLaser`` wrapper: setup turns on digital modulation
(``laser.pulse_mode = 1``) and autoexposure escalation writes
``laser.pulse_power`` (reference
``shrimpy/mantis/archive/pycromanager/microscope_operations.py:617-635,667-675``
and ``acq_engine.py:766-787``). This module is the first-party
equivalent: :class:`VortranLaser` speaks the Stradus ASCII command
protocol (``CMD=value\\r`` writes, ``?CMD\\r`` queries, echo +
``CMD=value`` reply lines) over a :class:`~.bus.SerialTransport`, and
:class:`StradusEmulator` is the device side for instrument-free
operation. The driver never special-cases the emulator — a physical
pyserial port satisfies the same transport contract.
"""

from __future__ import annotations

import logging

from shrimpy_tpu_torch.devices.bus import SerialTransport, VirtualSerialPort, open_port

logger = logging.getLogger(__name__)

_TERM = b"\r\n"


class StradusEmulator:
    """Device-side protocol handler for a Stradus-style laser.

    Implements the command subset the driver uses: ``LP`` (laser power,
    mW), ``PUL`` (digital modulation aka pulse mode), ``EPC`` (external
    power control), ``LE`` (emission), and the read-only identity /
    limit queries ``?MAXP``, ``?LW`` (wavelength), ``?OBT`` (on time).
    Out-of-range power is clamped to ``[0, max_power]`` the way the
    instrument clamps, and unknown commands answer ``!UK`` like the
    hardware does rather than going silent.
    """

    def __init__(self, wavelength_nm: int = 488, max_power_mw: float = 100.0):
        import threading

        self.wavelength_nm = int(wavelength_nm)
        self.max_power_mw = float(max_power_mw)
        self.power_mw = 0.0
        self.pulse_mode = 0
        self.emission = 0
        self.journal: list[str] = []
        self._partial = bytearray()
        # Shared by every port of this instrument: serializes handle()
        # across concurrently writing clients (replay-dual arms share
        # one laser by port name).
        self._wire_lock = threading.Lock()

    def port(self) -> VirtualSerialPort:
        return VirtualSerialPort(self.handle, self._wire_lock)

    def handle(self, data: bytes) -> bytes:
        self._partial.extend(data)
        out = bytearray()
        while b"\r" in self._partial:
            line, _, rest = bytes(self._partial).partition(b"\r")
            self._partial = bytearray(rest)
            out += self._respond(line.decode("ascii", "replace").strip())
        return bytes(out)

    def _respond(self, cmd: str) -> bytes:
        self.journal.append(cmd)
        reply = self._eval(cmd)
        return (cmd + "\r\n" + reply).encode("ascii") + _TERM

    def _eval(self, cmd: str) -> str:
        c = cmd.upper()
        if c.startswith("?"):
            name = c[1:]
            if name == "LP":
                return f"LP={self.power_mw:.1f}"
            if name == "MAXP":
                return f"MAXP={self.max_power_mw:.1f}"
            if name == "LW":
                return f"LW={self.wavelength_nm}"
            if name == "PUL":
                return f"PUL={self.pulse_mode}"
            if name == "LE":
                return f"LE={self.emission}"
            return "!UK"
        name, _, value = c.partition("=")
        if not value:
            return "!UK"
        if name == "LP":
            self.power_mw = min(max(float(value), 0.0), self.max_power_mw)
            return f"LP={self.power_mw:.1f}"
        if name == "PUL":
            self.pulse_mode = int(value)
            return f"PUL={self.pulse_mode}"
        if name == "LE":
            self.emission = int(value)
            return f"LE={self.emission}"
        return "!UK"


class VortranLaser:
    """Stradus protocol driver.

    Mirrors the copylot attribute surface the reference leans on
    (``pulse_mode``, ``pulse_power``) so engine code reads the same,
    but is first-party down to the wire bytes.
    """

    def __init__(self, port: str | SerialTransport):
        self._io: SerialTransport = (
            open_port(port) if isinstance(port, str) else port
        )
        self.port_name = port if isinstance(port, str) else "<transport>"
        self.max_power = self._query_float("MAXP")
        self.wavelength = int(self._query_float("LW"))

    # -- wire level ----------------------------------------------------
    def _txn(self, cmd: str) -> str:
        """One command round-trip: write, consume the echo line, return
        the reply payload line."""
        self._io.write(cmd.encode("ascii") + b"\r")
        echo = self._io.read_until(_TERM, 1.0).decode("ascii").strip()
        if echo != cmd:
            raise IOError(f"laser echoed {echo!r} for {cmd!r}")
        reply = self._io.read_until(_TERM, 1.0).decode("ascii").strip()
        if reply.startswith("!"):
            raise IOError(f"laser rejected {cmd!r}: {reply}")
        return reply

    def _query_float(self, name: str) -> float:
        reply = self._txn(f"?{name}")
        return float(reply.partition("=")[2])

    def _set(self, name: str, value: str) -> str:
        return self._txn(f"{name}={value}")

    # -- copylot-shaped surface ---------------------------------------
    @property
    def pulse_mode(self) -> int:
        return int(self._query_float("PUL"))

    @pulse_mode.setter
    def pulse_mode(self, value: int) -> None:
        self._set("PUL", str(int(value)))

    @property
    def pulse_power(self) -> float:
        return self._query_float("LP")

    @pulse_power.setter
    def pulse_power(self, value: float) -> None:
        reply = self._set("LP", f"{float(value):.1f}")
        applied = float(reply.partition("=")[2])
        if abs(applied - float(value)) > 0.05:
            logger.warning(
                "laser on %s clamped power %.1f -> %.1f mW",
                self.port_name, float(value), applied,
            )

    @property
    def emission(self) -> bool:
        return bool(self._query_float("LE"))

    @emission.setter
    def emission(self, value: bool) -> None:
        self._set("LE", "1" if value else "0")

    def close(self) -> None:
        self._io.close()


def setup_vortran_laser(port: str | SerialTransport) -> VortranLaser:
    """Open a laser and turn on digital modulation, the reference's
    setup contract (``microscope_operations.py:617-635``)."""
    logger.debug("Setting up Vortran laser on port %s", port)
    laser = VortranLaser(port)
    laser.pulse_mode = 1
    return laser
