"""Instrument rig façade: the engine-facing bundle of device drivers.

Composes the per-device drivers (``vortran``/``kim101``/``daq``/
``shutter``) into the lifecycle the reference engine runs its hardware
through (reference
``shrimpy/mantis/archive/pycromanager/acq_engine.py``):

- run start: save + open the shutter (``:932-934``), lasers into
  digital-modulation mode (``:766-787``), DAQ counters armed from the
  acquisition rates (``:600-688``)
- per (t, p) burst: start the chained counters (post-camera hook,
  ``:1274``), per-channel z-counter rate updates (``:565-598``)
- autoexposure: laser power writes (``microscope_operations.py:667-675``)
- remote-refocus: KIM101 relative moves with compensated travel
  (``microscope_operations.py:334-358``)
- abort: stop sequences + counters (``microscope_operations.py:594-616``)
- run end: restore the saved shutter state (``:1023-1024``), emission
  off, and a device journal into the summary sidecar

The rig is transport-agnostic: unbound port names get fresh emulators
(the only option on a GPU host); tests may pre-bind emulators through
``devices.bus.bind_port`` to assert wire-level traffic.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from shrimpy_tpu_torch.devices import bus
from shrimpy_tpu_torch.devices.daq import (
    CounterTask,
    get_total_num_daq_counter_samples,
    setup_daq_counter,
    start_daq_counters,
)
from shrimpy_tpu_torch.devices.kim101 import (
    KIM101Emulator,
    KinesisPiezoMotor,
    set_relative_kim101_position,
    setup_kim101_stage,
)
from shrimpy_tpu_torch.devices.shutter import (
    Shutter,
    get_shutter_state,
    open_shutter,
    reset_shutter,
)
from shrimpy_tpu_torch.devices.vortran import (
    StradusEmulator,
    VortranLaser,
    setup_vortran_laser,
)

logger = logging.getLogger(__name__)


@dataclass
class LaserSpec:
    """One excitation line: which channel it illuminates and its
    identity/limits (used to build an emulator when ``port`` is not
    already bound)."""

    channel: str
    wavelength_nm: int = 488
    max_power_mw: float = 100.0
    power_mw: float = 10.0
    port: str | None = None


@dataclass
class HardwareRig:
    lasers: dict[str, VortranLaser] = field(default_factory=dict)
    o3_stage: KinesisPiezoMotor | None = None
    o3_steps_per_slice: int = 10
    shutter: Shutter | None = None
    channel_ctr: CounterTask | None = None
    z_ctr: CounterTask | None = None
    events: list[tuple] = field(default_factory=list)
    _saved_shutter: tuple[bool, bool] | None = None
    _aborted: bool = False

    # -- lifecycle -----------------------------------------------------
    def run_start(self) -> None:
        if self.shutter is not None:
            self._saved_shutter = get_shutter_state(self.shutter)
            open_shutter(self.shutter)
            self.events.append(("shutter_open",))
        for channel, laser in self.lasers.items():
            laser.emission = True
            self.events.append(
                ("laser_on", channel, laser.wavelength, laser.pulse_power)
            )

    def arm_counters(self, n_slices: int, n_channels: int,
                     slice_rate_hz: float, volume_time_s: float) -> None:
        """Build the LF-style counter topology from the camera model:
        a channel counter at the per-volume rate triggering a
        retriggerable z counter at the slice rate
        (``acq_engine.py:617-688``)."""
        self.channel_ctr = setup_daq_counter(
            CounterTask("Channel Counter"), "cDAQ1/_ctr0",
            freq=1.0 / max(volume_time_s, 1e-9), duty_cycle=0.1,
            samples_per_channel=n_channels,
            pulse_terminal="/cDAQ1/Ctr0InternalOutput",
        )
        self.z_ctr = setup_daq_counter(
            CounterTask("Z Counter"), "cDAQ1/_ctr2",
            freq=slice_rate_hz, duty_cycle=0.1,
            samples_per_channel=n_slices,
            pulse_terminal="/cDAQ1/PFI0",
        )
        self.z_ctr.cfg_dig_edge_start_trig(self.channel_ctr)
        self.z_ctr.retriggerable = True
        expected = get_total_num_daq_counter_samples(
            [self.channel_ctr, self.z_ctr]
        )
        self.events.append(("daq_armed", n_slices, n_channels, expected))

    def on_burst_start(self) -> None:
        """One (t, p) hardware burst: start the chained counters (the
        reference's post-camera hook, ``acq_engine.py:1274``)."""
        if self.channel_ctr is None:
            return
        # The engine only reaches the next burst after the previous
        # (t, p) visit's camera time was charged, i.e. the previous
        # finite train has elapsed — stop the tasks so the
        # stop-before-restart rule can rearm them (the reference polls
        # is_task_done for the same gate; the schedule model here has
        # no free-running clock to poll).
        for task in (self.z_ctr, self.channel_ctr):
            task.stop()
        start_daq_counters([self.z_ctr, self.channel_ctr])
        self.events.append(("burst",))

    def on_channel(self, channel: str, slice_rate_hz: float) -> None:
        """Per-channel z-rate update (the reference updates the LS Z
        counter frequency per channel, ``acq_engine.py:565-598``)."""
        if self.z_ctr is not None and self.z_ctr.freq != slice_rate_hz:
            self.z_ctr.freq = float(slice_rate_hz)
            self.events.append(("z_rate", channel, round(slice_rate_hz, 3)))

    def set_laser_power(self, channel: str, power_mw: float) -> None:
        laser = self.lasers.get(channel)
        if laser is None:
            return
        laser.pulse_power = power_mw
        self.events.append(("laser_power", channel, round(power_mw, 2)))

    def refocus_move(self, delta_slices: int) -> None:
        """Translate a remote-refocus correction (z slices) into a
        compensated KIM101 move."""
        if self.o3_stage is None or not delta_slices:
            return
        steps = int(delta_slices) * self.o3_steps_per_slice
        set_relative_kim101_position(self.o3_stage, steps)
        self.events.append(("o3_move", steps, self.o3_stage.true_position))

    def on_abort(self) -> None:
        """Stop sequences + counters (the reference's
        ``abort_acquisition_sequence``)."""
        self._aborted = True
        for task in (self.z_ctr, self.channel_ctr):
            if task is not None:
                task.stop()
        self.events.append(("abort",))

    def run_end(self) -> None:
        for channel, laser in self.lasers.items():
            try:
                laser.emission = False
            except Exception:
                logger.exception("laser %s emission-off failed", channel)
        if self.shutter is not None and self._saved_shutter is not None:
            reset_shutter(self.shutter, *self._saved_shutter)
            self.events.append(("shutter_reset", *self._saved_shutter))
        for task in (self.z_ctr, self.channel_ctr):
            if task is not None:
                task.stop()
                task.close()

    # -- reporting -----------------------------------------------------
    def summary(self) -> dict:
        """Device journal for the acquisition summary sidecar (the
        reference logs the final O3 position for chunk restore,
        ``acq_engine.py:478-481``)."""
        out: dict = {
            "lasers": {
                c: {
                    "wavelength_nm": laser.wavelength,
                    "power_mw": laser.pulse_power,
                    "port": laser.port_name,
                }
                for c, laser in self.lasers.items()
            },
            "events": [list(e) for e in self.events],
            "aborted": self._aborted,
        }
        if self.o3_stage is not None:
            out["o3_true_position_steps"] = self.o3_stage.true_position
        if self.channel_ctr is not None:
            out["daq_bursts"] = self.channel_ctr.starts
            out["daq_expected_frames_per_burst"] = (
                get_total_num_daq_counter_samples(
                    [self.channel_ctr, self.z_ctr]
                )
            )
        return out


def build_rig(laser_specs: list[LaserSpec], *, o3_port: str | None = None,
              o3_steps_per_slice: int = 10,
              with_shutter: bool = True) -> HardwareRig:
    """Open every device, creating emulators for unbound ports.

    A port name already registered on the virtual bus (or, on a real
    rig, resolvable as a physical serial device) is opened as-is;
    otherwise a fresh emulator is bound under that name so repeated
    opens see the same instrument state.
    """
    lasers: dict[str, VortranLaser] = {}
    for spec in laser_specs:
        port = spec.port or f"emu:{spec.channel}"
        try:
            laser = setup_vortran_laser(port)
        except FileNotFoundError:
            emu = StradusEmulator(spec.wavelength_nm, spec.max_power_mw)
            bus.bind_port(port, emu.port)
            laser = setup_vortran_laser(port)
        laser.pulse_power = spec.power_mw
        lasers[spec.channel] = laser
    o3 = None
    if o3_port is not None:
        try:
            o3 = setup_kim101_stage(o3_port)
        except FileNotFoundError:
            emu = KIM101Emulator()
            bus.bind_port(o3_port, emu.port)
            o3 = setup_kim101_stage(o3_port)
    return HardwareRig(
        lasers=lasers, o3_stage=o3,
        o3_steps_per_slice=int(o3_steps_per_slice),
        shutter=Shutter() if with_shutter else None,
    )
