"""Thorlabs KIM101 piezo-motor driver + emulator (APT binary protocol).

The reference positions its O3 remote-refocus optics with a KIM101
inertial piezo controller through pylablib, with three semantic
obligations it layers on top (reference
``shrimpy/mantis/archive/pycromanager/microscope_operations.py:296-358``):
drive-parameter setup (max voltage / velocity / acceleration), a
manually tracked ``true_position`` in steps, and a directional travel
compensation factor applied to negative moves
(``KIM101_COMPENSATION_FACTOR``, unity on the reference instrument but
kept as the calibration knob).

This module is the first-party equivalent down to the wire: the driver
frames Thorlabs APT messages (6-byte little-endian header, data packets
flagged via ``dest | 0x80``) and the emulator executes them. Message
subset (IDs from the public APT protocol spec):

- ``MGMSG_MOD_IDENTIFY (0x0223)`` — flash the front panel (no reply)
- ``MGMSG_HW_REQ_INFO (0x0005)`` / ``HW_GET_INFO (0x0006)`` — serial no
- ``MGMSG_PZMOT_SET_PARAMS (0x08C0)`` sub-ID 0x0007 — drive params
  (max voltage, velocity, acceleration), the ``setup_drive`` payload
- ``MGMSG_MOT_MOVE_RELATIVE (0x0448)`` — jog by a signed step count
- ``MGMSG_MOT_MOVE_COMPLETED (0x0464)`` — completion event the driver's
  ``wait_move`` consumes
"""

from __future__ import annotations

import logging
import struct

from shrimpy_tpu_torch.devices.bus import SerialTransport, VirtualSerialPort, open_port

logger = logging.getLogger(__name__)

MGMSG_MOD_IDENTIFY = 0x0223
MGMSG_HW_REQ_INFO = 0x0005
MGMSG_HW_GET_INFO = 0x0006
MGMSG_PZMOT_SET_PARAMS = 0x08C0
MGMSG_MOT_MOVE_RELATIVE = 0x0448
MGMSG_MOT_MOVE_COMPLETED = 0x0464

_DRIVE_PARAMS_SUBID = 0x0007
_HOST = 0x01
_DEVICE = 0x50

# Directional travel compensation: inertia ("stick-slip") piezo steps
# cover slightly different distances in the two directions; the factor
# scales commanded negative travel. Unity on the reference instrument
# (microscope_operations.py:20) — kept as the per-rig calibration knob.
KIM101_COMPENSATION_FACTOR = 1.0


def _frame(msg_id: int, payload: bytes = b"",
           param1: int = 0, param2: int = 0, *,
           dest: int, source: int) -> bytes:
    if payload:
        return struct.pack(
            "<HHBB", msg_id, len(payload), dest | 0x80, source
        ) + payload
    return struct.pack("<HBBBB", msg_id, param1, param2, dest, source)


def _parse_header(buf: bytes) -> tuple[int, int, bool]:
    """-> (msg_id, payload_len, has_data). Header is always 6 bytes."""
    msg_id, = struct.unpack_from("<H", buf, 0)
    dest = buf[4]
    if dest & 0x80:
        length, = struct.unpack_from("<H", buf, 2)
        return msg_id, length, True
    return msg_id, 0, False


class KIM101Emulator:
    """Device-side APT handler: executes moves instantly (inertial
    steps are ~ms; the timing model lives in the DAQ/camera layer) and
    journals every state change for tests and the rig summary."""

    def __init__(self, serial_number: int = 74000291):
        import threading

        self.serial_number = int(serial_number)
        self.position_steps = 0
        self.drive_params: tuple[int, int, int] | None = None
        self.journal: list[tuple] = []
        self._buf = bytearray()
        # Shared by every port of this instrument (see StradusEmulator).
        self._wire_lock = threading.Lock()

    def port(self) -> VirtualSerialPort:
        return VirtualSerialPort(self.handle, self._wire_lock)

    def handle(self, data: bytes) -> bytes:
        self._buf.extend(data)
        out = bytearray()
        while len(self._buf) >= 6:
            msg_id, length, has_data = _parse_header(bytes(self._buf[:6]))
            if len(self._buf) < 6 + length:
                break
            payload = bytes(self._buf[6:6 + length])
            del self._buf[:6 + length]
            out += self._exec(msg_id, payload)
        return bytes(out)

    def _exec(self, msg_id: int, payload: bytes) -> bytes:
        if msg_id == MGMSG_MOD_IDENTIFY:
            self.journal.append(("identify",))
            return b""
        if msg_id == MGMSG_HW_REQ_INFO:
            info = struct.pack("<l8sH", self.serial_number, b"KIM101\x00\x00", 1)
            info += bytes(84 - len(info))
            return _frame(MGMSG_HW_GET_INFO, info,
                          dest=_HOST, source=_DEVICE)
        if msg_id == MGMSG_PZMOT_SET_PARAMS:
            sub_id, = struct.unpack_from("<H", payload, 0)
            if sub_id == _DRIVE_PARAMS_SUBID:
                # <sub_id u16, chan u16, max_voltage i32, velocity i32,
                #  acceleration i32>
                _, _, volt, vel, acc = struct.unpack_from("<HHlll", payload, 0)
                self.drive_params = (volt, vel, acc)
                self.journal.append(("drive_params", volt, vel, acc))
            return b""
        if msg_id == MGMSG_MOT_MOVE_RELATIVE:
            _, dist = struct.unpack_from("<Hl", payload, 0)
            self.position_steps += dist
            self.journal.append(("move_by", dist))
            done = struct.pack("<Hl", 1, self.position_steps)
            return _frame(MGMSG_MOT_MOVE_COMPLETED, done,
                          dest=_HOST, source=_DEVICE)
        logger.debug("KIM101 emulator ignoring message 0x%04x", msg_id)
        return b""


class KinesisPiezoMotor:
    """APT driver with the pylablib-shaped surface the reference uses
    (``setup_drive``, ``move_by``, ``wait_move``) plus the reference's
    own ``true_position`` bookkeeping contract."""

    def __init__(self, port: str | SerialTransport):
        self._io: SerialTransport = (
            open_port(port) if isinstance(port, str) else port
        )
        # The reference tracks the COMMANDED position in steps itself,
        # uncorrected by the compensation factor (:329-351).
        self.true_position = 0
        self._moving = False
        self.serial_number = self._read_serial()

    def _read_serial(self) -> int:
        self._io.write(_frame(MGMSG_HW_REQ_INFO, dest=_DEVICE, source=_HOST))
        raw = self._read_message(MGMSG_HW_GET_INFO)
        return struct.unpack_from("<l", raw, 0)[0]

    def _read_message(self, expect_id: int) -> bytes:
        head = self._io.read_exact(6, 1.0)
        msg_id, length, _ = _parse_header(head)
        payload = self._io.read_exact(length, 1.0) if length else b""
        if msg_id != expect_id:
            raise IOError(
                f"expected APT message 0x{expect_id:04x}, got 0x{msg_id:04x}"
            )
        return payload

    def setup_drive(self, max_voltage: int, velocity: int,
                    acceleration: int) -> None:
        payload = struct.pack(
            "<HHlll", _DRIVE_PARAMS_SUBID, 1,
            int(max_voltage), int(velocity), int(acceleration),
        )
        self._io.write(_frame(MGMSG_PZMOT_SET_PARAMS, payload,
                              dest=_DEVICE, source=_HOST))

    def move_by(self, steps: int) -> None:
        payload = struct.pack("<Hl", 1, int(steps))
        self._io.write(_frame(MGMSG_MOT_MOVE_RELATIVE, payload,
                              dest=_DEVICE, source=_HOST))
        self._moving = True

    def wait_move(self) -> int:
        """Block until the move-completed event; returns the device's
        reported absolute position in steps."""
        if not self._moving:
            return 0
        raw = self._read_message(MGMSG_MOT_MOVE_COMPLETED)
        self._moving = False
        return struct.unpack_from("<l", raw, 2)[0]

    def close(self) -> None:
        self._io.close()


def setup_kim101_stage(port: str | SerialTransport, max_voltage: int = 112,
                       velocity: int = 500,
                       acceleration: int = 1000) -> KinesisPiezoMotor:
    """Open + configure a KIM101 with the reference's default drive
    parameters (``microscope_operations.py:296-331``)."""
    stage = KinesisPiezoMotor(port)
    logger.debug(
        "KIM101 %s drive params: max voltage %s V, velocity %s steps/s, "
        "acceleration %s steps/s^2",
        stage.serial_number, max_voltage, velocity, acceleration,
    )
    stage.setup_drive(max_voltage, velocity, acceleration)
    stage.true_position = 0
    return stage


def set_relative_kim101_position(stage: KinesisPiezoMotor,
                                 distance: int) -> None:
    """Relative move with directional travel compensation
    (``microscope_operations.py:334-358``): ``true_position`` advances
    by the COMMANDED distance; the wire move scales negative travel by
    the compensation factor."""
    stage.true_position += int(distance)
    if distance < 0:
        distance = int(distance * KIM101_COMPENSATION_FACTOR)
    stage.move_by(int(distance))
    stage.wait_move()
