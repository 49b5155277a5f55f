"""PyTorch port of the instrument drivers (ROADMAP item 12c) against the JAX
package (CPU).

``shrimpy_tpu_torch/devices/`` is a copy of ``shrimpy_tpu/devices/``, pinned
statement for statement in ``tests/test_torch_config.py`` (``COPIES``). Here
the JAX tests of it (``tests/test_devices.py``: the wire protocols, the
device semantics, the engine's rig) run on both packages, each over its own
port registry.
"""

import json
import threading

import numpy as np
import pytest
import torch

from tests.acq_pkgs import PACKAGES, Pkg, package_logging  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture(autouse=True)
def _clean_bus(pkg):
    bus = pkg("devices.bus")
    bus.unbind_all()
    yield
    bus.unbind_all()


# -- Vortran Stradus (ASCII serial) -------------------------------------------

def test_vortran_setup_turns_on_pulse_mode(pkg):
    v = pkg("devices.vortran")
    emu = v.StradusEmulator(wavelength_nm=561, max_power_mw=50.0)
    laser = v.setup_vortran_laser(emu.port())
    assert laser.pulse_mode == 1
    assert laser.wavelength == 561
    assert laser.max_power == 50.0
    assert "PUL=1" in emu.journal


def test_vortran_power_roundtrip_and_clamp(pkg):
    v = pkg("devices.vortran")
    emu = v.StradusEmulator(max_power_mw=100.0)
    laser = v.VortranLaser(emu.port())
    laser.pulse_power = 12.5
    assert emu.power_mw == 12.5
    assert laser.pulse_power == 12.5
    laser.pulse_power = 500.0  # the instrument clamps; the driver reads back
    assert laser.pulse_power == 100.0


def test_vortran_unknown_command_raises(pkg):
    v = pkg("devices.vortran")
    laser = v.VortranLaser(v.StradusEmulator().port())
    with pytest.raises(IOError, match="rejected"):
        laser._txn("BOGUS=1")


def test_vortran_port_registry(pkg):
    v = pkg("devices.vortran")
    emu = v.StradusEmulator()
    pkg("devices.bus").bind_port("COM4", emu.port)
    laser = v.setup_vortran_laser("COM4")
    laser.emission = True
    assert emu.emission == 1
    with pytest.raises(FileNotFoundError, match="COM9"):
        v.VortranLaser("COM9")


# -- Thorlabs KIM101 (APT binary) ---------------------------------------------

def test_kim101_setup_drive_params_on_the_wire(pkg):
    k = pkg("devices.kim101")
    emu = k.KIM101Emulator(serial_number=74000291)
    stage = k.setup_kim101_stage(emu.port(), max_voltage=112, velocity=500, acceleration=1000)
    assert stage.serial_number == 74000291
    assert emu.drive_params == (112, 500, 1000)


def test_kim101_relative_move_and_completion_event(pkg):
    k = pkg("devices.kim101")
    emu = k.KIM101Emulator()
    stage = k.KinesisPiezoMotor(emu.port())
    stage.move_by(30)
    assert stage.wait_move() == 30
    stage.move_by(-10)
    assert stage.wait_move() == 20
    assert emu.position_steps == 20


def test_kim101_compensated_move_tracks_commanded_position(pkg, monkeypatch):
    k = pkg("devices.kim101")
    # The calibration factor scales only the wire travel of negative moves.
    monkeypatch.setattr(k, "KIM101_COMPENSATION_FACTOR", 2.0)
    emu = k.KIM101Emulator()
    stage = k.setup_kim101_stage(emu.port())
    k.set_relative_kim101_position(stage, 100)
    k.set_relative_kim101_position(stage, -40)
    assert stage.true_position == 60
    assert emu.position_steps == 100 - 80


def test_kim101_rejects_wrong_message_id(pkg):
    # A laser emulator on a KIM101 driver is a framing error, not a hang.
    emu = pkg("devices.vortran").StradusEmulator()
    with pytest.raises((IOError, TimeoutError)):
        pkg("devices.kim101").KinesisPiezoMotor(emu.port())


# -- DAQ counters --------------------------------------------------------------

def _lf_topology(daq, n_channels=2, n_slices=5, channel_hz=0.5, slice_hz=25.0):
    chan = daq.setup_daq_counter(daq.CounterTask("LF Channel Counter"), "cDAQ1/_ctr0",
                                 channel_hz, 0.1, n_channels, "/cDAQ1/Ctr0InternalOutput")
    z = daq.setup_daq_counter(daq.CounterTask("LF Z Counter"), "cDAQ1/_ctr2", slice_hz, 0.1,
                              n_slices, "/cDAQ1/PFI0")
    z.cfg_dig_edge_start_trig(chan)
    z.retriggerable = True
    return chan, z


def test_daq_total_samples_is_the_product(pkg):
    daq = pkg("devices.daq")
    chan, z = _lf_topology(daq, n_channels=3, n_slices=7)
    assert daq.get_total_num_daq_counter_samples([chan, z]) == 21


def test_daq_chained_schedule_one_train_per_parent_pulse(pkg):
    chan, z = _lf_topology(pkg("devices.daq"), n_channels=2, n_slices=3, channel_hz=1.0,
                           slice_hz=10.0)
    times = z.chained_pulse_times()
    assert len(times) == 6
    np.testing.assert_allclose(times, [0.0, 0.1, 0.2, 1.0, 1.1, 1.2], atol=1e-12)


def test_daq_unretriggerable_chain_is_an_error(pkg):
    chan, z = _lf_topology(pkg("devices.daq"))
    z.retriggerable = False
    with pytest.raises(RuntimeError, match="retriggerable"):
        z.chained_pulse_times()


def test_daq_start_requires_stop_first(pkg):
    daq = pkg("devices.daq")
    chan, _ = _lf_topology(daq)
    daq.start_daq_counters(chan)
    assert chan.starts == 1
    daq.start_daq_counters(chan)  # still running: skipped
    assert chan.starts == 1
    chan.stop()
    daq.start_daq_counters(chan)
    assert chan.starts == 2


def test_daq_schedule_matches_camera_model(pkg):
    """The pulse schedule a real DAQ would emit agrees with the CameraPlan
    charge the replay engine sleeps on."""
    daq = pkg("devices.daq")
    cam = pkg("engine.plan").CameraPlan(model_acquisition=True, mode="labelfree", max_fps=30)
    exposure_ms, n_slices = 20.0, 12
    rate = cam.slice_rate_hz(exposure_ms)
    z = daq.setup_daq_counter(daq.CounterTask("Z"), "cDAQ1/_ctr2", rate, 0.1, n_slices,
                              "/cDAQ1/PFI0")
    assert z.burst_seconds() == pytest.approx(
        cam.volume_time_s(n_slices, exposure_ms, channel_change=False))


# -- Shutter --------------------------------------------------------------------

def test_shutter_bracket_saves_opens_and_restores(pkg):
    sh_mod = pkg("devices.shutter")
    sh = sh_mod.Shutter()
    sh.set_auto_shutter(True)
    sh.set_open(False)
    saved = sh_mod.get_shutter_state(sh)
    sh_mod.open_shutter(sh)
    assert (sh.auto_shutter, sh.is_open) == (False, True)
    sh_mod.reset_shutter(sh, *saved)
    assert (sh.auto_shutter, sh.is_open) == saved
    tail = sh.journal[-2:]  # the open state first, then auto-shutter
    assert tail[0][0] == "open" and tail[1][0] == "auto"


def test_open_shutter_without_device_is_noop(pkg):
    sh_mod = pkg("devices.shutter")
    sh_mod.open_shutter(None)
    sh_mod.reset_shutter(None, True, False)


# -- Rig + engine integration ---------------------------------------------------

def test_build_rig_creates_emulators_for_unbound_ports(pkg):
    rig_mod = pkg("devices.rig")
    rig = rig_mod.build_rig([rig_mod.LaserSpec(channel="GFP", wavelength_nm=488, power_mw=15.0)],
                            o3_port="kim:o3")
    assert rig.lasers["GFP"].pulse_power == 15.0
    assert rig.o3_stage is not None
    laser2 = pkg("devices.vortran").VortranLaser(pkg("devices.bus").open_port("emu:GFP"))
    assert laser2.pulse_power == 15.0  # the same instrument state


def test_engine_acquisition_with_rig(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(2, 2, 4, 16, 16))
    plan = pkg.plan(
        time={"n_timepoints": 2},
        channels=[{"name": "ch0", "exposure_ms": 10.0}, {"name": "ch1", "exposure_ms": 10.0}],
        camera={"model_acquisition": True, "mode": "demo", "time_scale": 0.0},
        hardware={"enabled": True,
                  "lasers": [{"channel": "ch0", "wavelength_nm": 488, "power_mw": 12.0},
                             {"channel": "ch1", "wavelength_nm": 561, "power_mw": 8.0}],
                  "o3_port": "kim:o3"},
    )
    pkg.engine(pkg.source(tmp_path / "src.zarr")).acquire(tmp_path / "out", "acq", plan)
    summary = json.loads((tmp_path / "out" / "acq_summary_metadata.json").read_text())
    hw = summary["hardware"]
    assert hw is not None and not hw["aborted"]
    assert hw["lasers"]["ch0"]["wavelength_nm"] == 488
    assert hw["lasers"]["ch1"]["power_mw"] == 8.0
    events = [tuple(e) for e in hw["events"]]
    kinds = [e[0] for e in events]
    assert kinds.count("shutter_open") == 1
    assert kinds.count("shutter_reset") == 1
    assert hw["daq_bursts"] == 2  # one burst a (t, p) visit
    assert hw["daq_expected_frames_per_burst"] == 2 * 4
    assert ("daq_armed", 4, 2, 8) in events


def test_engine_rig_moves_o3_on_refocus(pkg, tmp_path):
    pkg("io.synthetic").synthetic_blob_fov(tmp_path / "src.zarr", shape_zyx=(9, 32, 32),
                                           n_timepoints=2, drift_zyx=(2.0, 0.0, 0.0))
    plan = pkg.plan(time={"n_timepoints": 2},
                    refocus={"enabled": True, "interval_timepoints": 1},
                    hardware={"enabled": True, "o3_port": "kim:o3", "o3_steps_per_slice": 5})
    pkg.engine(pkg.source(tmp_path / "src.zarr")).acquire(tmp_path / "out", "acq", plan)
    summary = json.loads((tmp_path / "out" / "acq_summary_metadata.json").read_text())
    hw = summary["hardware"]
    moves = [e for e in hw["events"] if e[0] == "o3_move"]
    total = sum(v for _, v in summary["refocus_total_z"].items())
    if total:
        assert moves, "refocus corrections must drive the O3 stage"
        assert hw["o3_true_position_steps"] == total * 5


def test_plan_validate_rejects_unknown_laser_channel(pkg):
    plan_mod = pkg("engine.plan")
    plan = plan_mod.AcquisitionPlan(channels=[{"name": "GFP", "exposure_ms": 10.0}],
                                    hardware={"enabled": True, "lasers": [{"channel": "mCherry"}]})
    assert any("mCherry" in p for p in plan_mod.validate_plan(plan))


def test_shared_emulator_is_thread_safe_across_ports(pkg):
    """Two arm engines can open the same port name (one instrument):
    concurrent round trips must not steal each other's replies."""
    v = pkg("devices.vortran")
    emu = v.StradusEmulator()
    pkg("devices.bus").bind_port("COM7", emu.port)
    errors: list[Exception] = []

    def hammer():
        try:
            laser = v.setup_vortran_laser("COM7")
            for i in range(200):
                laser.pulse_power = float(i % 50)
                _ = laser.pulse_power
                _ = laser.pulse_mode
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_hardware_plan_rejects_duplicate_and_overrange(pkg):
    hp = pkg("engine.plan").HardwarePlan
    with pytest.raises(ValueError, match="duplicate"):
        hp(enabled=True, lasers=[{"channel": "a"}, {"channel": "a"}])
    with pytest.raises(ValueError, match="exceeds"):
        hp(enabled=True, lasers=[{"channel": "a", "power_mw": 200.0, "max_power_mw": 100.0}])
