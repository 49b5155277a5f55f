"""First-party instrument-control drivers over virtualized transports.

Fills the physical device-control surface of the reference's archived
microscope-operations library (reference
``shrimpy/mantis/archive/pycromanager/microscope_operations.py``) with
first-party drivers — Vortran Stradus lasers (ASCII serial), Thorlabs
KIM101 piezo motors (APT binary), NI-DAQ-style counter triggering, and
shutter state management — speaking real wire protocols against
in-process emulated transports (:mod:`.bus`), since a GPU host carries no
instrument bus. :mod:`.rig` bundles them into the acquisition-engine
lifecycle.

The port's own copies of ``shrimpy_tpu/devices/*.py``, pinned statement for
statement by ``tests/test_torch_config.py`` (``COPIES``). They use the
standard library alone, so they load on a host with torch and nothing else.
"""

from shrimpy_tpu_torch.devices.bus import VirtualSerialPort, bind_port, open_port
from shrimpy_tpu_torch.devices.daq import (
    CounterTask,
    get_daq_counter_names,
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
from shrimpy_tpu_torch.devices.rig import HardwareRig, LaserSpec, build_rig
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

__all__ = [
    "VirtualSerialPort", "bind_port", "open_port",
    "CounterTask", "setup_daq_counter", "start_daq_counters",
    "get_daq_counter_names", "get_total_num_daq_counter_samples",
    "KIM101Emulator", "KinesisPiezoMotor", "setup_kim101_stage",
    "set_relative_kim101_position",
    "Shutter", "get_shutter_state", "open_shutter", "reset_shutter",
    "StradusEmulator", "VortranLaser", "setup_vortran_laser",
    "HardwareRig", "LaserSpec", "build_rig",
]
