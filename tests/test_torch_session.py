"""PyTorch port of the engine's timing models and of a whole session
(ROADMAP item 12c) against the JAX package (CPU).

The JAX tests of the XY stage-speed model (``tests/test_stage_speed.py``),
of the camera slice-rate model (``tests/test_camera_model.py``) and the
full-session miniature (``tests/test_full_session.py``: replay with tracking
and an autofocus failure, then deskew + RL over the store and its resume) run
on both packages, the port's engine and reconstruction on the CPU (JAX's
reconstruction over its 8-device CPU mesh, the port's on one device: item 11
is the port's multi-GPU).
"""

import json
import math

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from tests.acq_pkgs import PACKAGES, Pkg, package_logging  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture()
def fov_source(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(2, 1, 3, 16, 16))
    return pkg.source(tmp_path / "src.zarr")


def _summary(tmp_path, name="acq"):
    return json.loads((tmp_path / "out" / f"{name}_summary_metadata.json").read_text())


# -- test_stage_speed.py -----------------------------------------------------------

TILES = {"plate": {"rows": 1, "columns": 1},
         "well_points_plan": {"rows": 1, "columns": 2, "overlap": [0.0, 50.0]}}  # pitch 8 um


def test_move_time_rule_matches_reference(pkg):
    stage = pkg("engine.plan").StagePlan(model_speed=True)
    assert stage.move_time_s(0.5) is None  # negligible (< 1 um)
    speed, t = stage.move_time_s(1000.0)  # short move: slow speed
    assert speed == 2.0 and t == pytest.approx(1.0 / 2.0)
    speed, t = stage.move_time_s(5000.0)  # long move: fast speed
    assert speed == 5.75 and t == pytest.approx(5.0 / 5.75)


def test_grid_tiles_record_slow_moves(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 2}, stage={"model_speed": True, "time_scale": 0.0},
                    stage_positions=TILES)
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    summary = _summary(tmp_path)
    moves = summary["stage_moves"]
    assert len(moves) == 3  # the first visit has no previous position
    for t, p_key, dist, speed, move_s in moves:
        assert dist == pytest.approx(8.0)
        assert speed == 2.0
        assert move_s == pytest.approx(8.0 / 1000.0 / 2.0, abs=1e-4)
    assert summary["stage_move_s"] == pytest.approx(sum(m[4] for m in moves), abs=1e-3)


def test_csv_homes_drive_fast_moves(pkg, tmp_path):
    pm = pkg("io.platemap")
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=2,
                                                 shape_tczyx=(1, 1, 2, 8, 8))
    pm.PositionList([
        pm.PositionEntry("A", row="0", col="0", fov="000", x_um=0.0, y_um=0.0),
        pm.PositionEntry("B", row="0", col="1", fov="001", x_um=3000.0, y_um=4000.0),
    ]).write(tmp_path / "positions.csv")
    plan = pkg.plan(positions_csv=str(tmp_path / "positions.csv"),
                    stage={"model_speed": True, "time_scale": 0.0})
    pkg.engine(pkg.source(tmp_path / "plate.zarr")).acquire(tmp_path / "out", "acq", plan)
    moves = _summary(tmp_path)["stage_moves"]
    assert len(moves) == 1  # the A -> B hop
    _, p_key, dist, speed, move_s = moves[0]
    assert p_key == "0/1/001"
    assert dist == pytest.approx(5000.0)
    assert speed == 5.75
    assert move_s == pytest.approx(5.0 / 5.75, abs=1e-3)


def test_same_position_revisit_is_negligible(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 3}, stage={"model_speed": True, "time_scale": 0.0})
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    summary = _summary(tmp_path)
    assert summary["stage_moves"] == []
    assert summary["stage_move_s"] == 0.0


def test_stage_model_off_records_nothing(pkg, tmp_path, fov_source):
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 2}))
    assert _summary(tmp_path)["stage_moves"] == []


def test_move_time_sleep_feeds_latency_budget(pkg, tmp_path, fov_source, monkeypatch):
    slept = []
    monkeypatch.setattr(pkg("engine.engine").time, "sleep", lambda s: slept.append(s))
    plan = pkg.plan(time={"n_timepoints": 2}, stage={"model_speed": True, "time_scale": 0.5},
                    stage_positions=TILES)
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    expected = 8.0 / 1000.0 / 2.0 * 0.5
    assert len([s for s in slept if np.isclose(s, expected, atol=1e-6)]) == 3


# -- test_camera_model.py ------------------------------------------------------------

def test_labelfree_rate_matches_reference(pkg):
    cam = pkg("engine.plan").CameraPlan(mode="labelfree", max_fps=47.5)
    assert cam.slice_rate_hz(2.0) == 47.0  # floor(47.5)
    assert cam.slice_rate_hz(50.0) == pytest.approx(1000.0 / 51.5)
    assert cam.effective_channel_change_ms() == 20.0
    assert cam.volume_time_s(10, 50.0) == pytest.approx(10 * 51.5 / 1000.0 + 0.020)


def test_lightsheet_rate_and_readout_constraint(pkg):
    cam = pkg("engine.plan").CameraPlan(mode="lightsheet", readout_ms=10.0)
    assert cam.slice_rate_hz(20.0) == pytest.approx(1000.0 / 30.05)
    assert cam.effective_channel_change_ms() == 200.0
    with pytest.raises(ValueError, match="exceed"):
        cam.slice_rate_hz(5.0)


def test_demo_rate_is_fps_capped(pkg):
    cam = pkg("engine.plan").CameraPlan(mode="demo", max_fps=30.0)
    assert cam.slice_rate_hz(100.0) == pytest.approx(10.0)
    assert cam.slice_rate_hz(1.0) == 30.0
    assert cam.effective_channel_change_ms() == 0.0


LABELFREE = {"model_acquisition": True, "mode": "labelfree", "max_fps": 40.0, "time_scale": 0.0}


def test_summary_records_modeled_acquisition(pkg, tmp_path, fov_source):
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq",
                                   pkg.plan(time={"n_timepoints": 2}, camera=LABELFREE))
    summary = _summary(tmp_path)
    rate = min(1000.0 / 11.5, math.floor(40.0))
    assert summary["camera_slice_rate_hz"] == {"ch0": pytest.approx(round(rate, 3))}
    assert summary["camera_acq_s"] == pytest.approx(2 * 3 / rate, abs=1e-3)  # no channel change


def test_channel_change_charged_per_transition(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src2.zarr", shape=(1, 2, 3, 16, 16))
    pkg.engine(pkg.source(tmp_path / "src2.zarr")).acquire(
        tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 1}, camera=LABELFREE))
    rate = min(1000.0 / 11.5, math.floor(40.0))
    assert _summary(tmp_path)["camera_acq_s"] == pytest.approx(2 * (3 / rate) + 0.020, abs=1e-3)


def _lightsheet(readout_ms):
    return {"model_acquisition": True, "mode": "lightsheet", "readout_ms": readout_ms,
            "time_scale": 0.0}


def test_timing_uses_physical_exposure_not_laser_power(pkg, tmp_path, fov_source):
    nominal = pkg("engine.autoexposure").NOMINAL_LASER_POWER
    (tmp_path / "man.csv").write_text(f"well,exposure_ms,laser_power\n0,20.0,{nominal / 2}\n")
    plan = pkg.plan(time={"n_timepoints": 1}, channels=None, source_exposure_ms=20.0,
                    camera=_lightsheet(15.0),
                    autoexposure={"enabled": True, "algorithm": "manual",
                                  "manual_csv": str(tmp_path / "man.csv")})
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    rate = 1000.0 / (20.0 + 15.0 + 0.05)  # the physical 20 ms exposure
    assert _summary(tmp_path)["camera_slice_rate_hz"]["ch0"] == pytest.approx(round(rate, 3))


def test_time_scale_scales_the_sleep(pkg, tmp_path, fov_source, monkeypatch):
    slept = []
    monkeypatch.setattr(pkg("engine.engine").time, "sleep", lambda s: slept.append(s))
    plan = pkg.plan(time={"n_timepoints": 2},
                    camera={"model_acquisition": True, "mode": "demo", "time_scale": 0.5})
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    per_vol = 3 / 30.0
    assert len([s for s in slept if np.isclose(s, per_vol * 0.5, atol=1e-9)]) == 2


def test_camera_model_off_records_nothing(pkg, tmp_path, fov_source):
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 1}))
    summary = _summary(tmp_path)
    assert summary["camera_slice_rate_hz"] == {}
    assert summary["camera_acq_s"] == 0.0


def test_sequenced_event_cap_matches_reference(pkg):
    cam_cls = pkg("engine.plan").CameraPlan
    cam_cls(model_acquisition=True, mode="labelfree").check_sequenced_events(600, 2)  # 1200
    with pytest.raises(ValueError, match="1200"):
        cam_cls(model_acquisition=True, mode="labelfree").check_sequenced_events(601, 2)
    with pytest.raises(ValueError, match="1200"):
        cam_cls(model_acquisition=True, mode="lightsheet",
                readout_ms=10.0).check_sequenced_events(601, 2)
    cam_cls(model_acquisition=True).check_sequenced_events(10_000, 4)  # demo: unlimited
    with pytest.raises(ValueError, match="hardware-sequence"):
        cam_cls(model_acquisition=True, max_sequenced_events=100).check_sequenced_events(101, 1)
    cam_cls(model_acquisition=True, mode="labelfree",
            max_sequenced_events=None).check_sequenced_events(10_000, 4)
    cam_cls(model_acquisition=False, mode="labelfree").check_sequenced_events(10_000, 4)


def test_engine_fails_fast_on_sequenced_event_cap(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 1},
                    camera={"model_acquisition": True, "max_sequenced_events": 2})
    with pytest.raises(ValueError, match="sequenced events"):
        pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)


def _validate(pkg, path):
    return CliRunner().invoke(pkg("cli.main").cli, ["plan", "validate", str(path)])


def test_plan_validate_enforces_sequenced_event_cap(pkg, tmp_path):
    bad = tmp_path / "bad.yml"
    bad.write_text("channels: [{name: GFP, exposure_ms: 20.0}, {name: RFP, exposure_ms: 20.0}]\n"
                   "z: {n_slices: 601}\ncamera: {model_acquisition: true, mode: labelfree}\n")
    result = _validate(pkg, bad)
    assert result.exit_code != 0
    assert "sequenced events" in result.output


def test_plan_validate_surfaces_camera_problems(pkg, tmp_path):
    bad = tmp_path / "bad.yml"
    bad.write_text("channels: [{name: GFP, exposure_ms: 5.0}]\n"
                   "camera: {model_acquisition: true, mode: lightsheet}\n")
    result = _validate(pkg, bad)
    assert result.exit_code != 0
    assert "camera model" in result.output and "GFP" in result.output


def test_plan_validate_reports_non_numeric_autoexposure_setting(pkg):
    plan_mod = pkg("engine.plan")
    plan = plan_mod.AcquisitionPlan(
        channels=[{"name": "GFP", "exposure_ms": 20.0}],
        camera={"model_acquisition": True, "mode": "lightsheet"},
        autoexposure={"enabled": True, "settings": {"min_exposure_ms": "15"}})
    problems = plan_mod.validate_plan(plan)
    assert any("min_exposure_ms" in p and "number" in p for p in problems), problems


def test_invalid_lightsheet_exposure_fails_fast(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 1},
                    camera={"model_acquisition": True, "mode": "lightsheet"})
    with pytest.raises(ValueError, match="exceed"):
        pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)


def test_lightsheet_autoexposure_floor_fails_before_run(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 1}, source_exposure_ms=20.0,
                    camera=_lightsheet(10.0), autoexposure={"enabled": True})
    with pytest.raises(ValueError, match="min_exposure_ms"):
        pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    assert not (tmp_path / "out" / "acq.zarr").exists()
    y = tmp_path / "p.yml"
    y.write_text("source_exposure_ms: 20.0\ncamera: {model_acquisition: true, mode: lightsheet}\n"
                 "autoexposure: {enabled: true}\n")
    r = _validate(pkg, y)
    assert r.exit_code != 0 and "min_exposure_ms" in r.output
    ok = pkg.plan(time={"n_timepoints": 1}, source_exposure_ms=20.0, camera=_lightsheet(10.0),
                  autoexposure={"enabled": True, "settings": {"min_exposure_ms": 12.0}})
    pkg.engine(fov_source).acquire(tmp_path / "out2", "acq", ok)


def test_lightsheet_manual_autoexposure_entries_checked(pkg, tmp_path, fov_source):
    (tmp_path / "man.csv").write_text("well,exposure_ms,laser_power\n0,5.0,50\n")
    plan = pkg.plan(time={"n_timepoints": 1}, source_exposure_ms=20.0, camera=_lightsheet(10.0),
                    autoexposure={"enabled": True, "algorithm": "manual",
                                  "manual_csv": str(tmp_path / "man.csv")})
    with pytest.raises(ValueError, match="well '0'"):
        pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)


def test_effective_rate_journaled_per_position(pkg, tmp_path, fov_source):
    (tmp_path / "man.csv").write_text("well,exposure_ms,laser_power\n0,40.0,100\n")
    plan = pkg.plan(time={"n_timepoints": 1}, source_exposure_ms=20.0, camera=_lightsheet(15.0),
                    autoexposure={"enabled": True, "algorithm": "manual",
                                  "manual_csv": str(tmp_path / "man.csv")})
    pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    summary = _summary(tmp_path)
    assert summary["camera_slice_rate_hz"]["ch0"] == pytest.approx(round(1000.0 / 35.05, 3))
    assert summary["camera_effective_rate_hz"] == {"0|ch0": pytest.approx(round(1000.0 / 55.05,
                                                                                3))}


# -- test_full_session.py --------------------------------------------------------------

@pytest.fixture()
def session_plate(pkg, tmp_path):
    """A 2-well plate, 3 timepoints, 2 channels, drifting blobs."""
    rng = np.random.default_rng(42)
    path = tmp_path / "session.zarr"
    store = pkg("io.ngff").create_hcs(path, channel_names=["BF", "GFP"])
    shape = (3, 2, 12, 32, 32)
    blob = pkg("io.synthetic").gaussian_blob
    for p in range(2):
        pos = store.create_position("0", str(p), "000", channel_names=["BF", "GFP"])
        pos.create_array(shape, dtype="float32")
        data = np.zeros(shape, np.float32)
        for t in range(3):
            center = (6.0, 16.0 + 2 * t, 16.0 - 3 * t)
            for c in range(2):
                data[t, c] = blob(shape[2:], center, (2.0, 3.0, 3.0), amplitude=100.0 * (c + 1))
        data += rng.normal(0, 0.5, shape).astype(np.float32)
        pos.write(Ellipsis, data)
    return path


def test_replay_track_reconstruct_session(pkg, tmp_path, session_plate):
    plan = pkg.plan(time={"n_timepoints": 3},
                    autofocus={"enabled": True, "fail_at_indices": [3]},  # t=1, p=1
                    metadata={"dynatrack": {
                        "input_channel": "BF", "tracking_channel": "BF",
                        "tracking_method": "pcc",
                        "image_to_stage_matrix_xyz": [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                                                      [0.0, 0.0, -1.0]]}})
    acq_path = pkg.engine(pkg.source(session_plate)).acquire(tmp_path / "acq", "session", plan)
    ngff = pkg("io.ngff")
    acq = ngff.open_ngff(acq_path)
    assert acq.is_plate
    keys = sorted(acq.positions())
    assert len(keys) == 2
    failed = acq.positions()[keys[1]].read()
    assert np.all(failed[1] == 0)  # the autofocus failure, zero-padded on disk
    assert failed[0].max() > 0
    journal = (tmp_path / "acq" / "session_dynatrack_log.csv").read_text().splitlines()
    assert len(journal) >= 1 + 4
    summary = json.loads((tmp_path / "acq" / "session_summary_metadata.json").read_text())
    assert summary["skipped_autofocus"] == [[1, keys[1]]]

    schemas = pkg("config.schemas")
    settings = schemas.ReconstructSettings(
        deskew=schemas.DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=0.386),
        deconvolve=schemas.DeconvolveSettings(iterations=2), channels=["BF"])
    run = pkg("runtime.stream").reconstruct_store
    kw = pkg.cpu if pkg.is_port else {"mesh": pkg("parallel").make_mesh(8)}
    out_path = tmp_path / "recon.zarr"
    assert run(acq_path, out_path, settings, **kw)["volumes"] == 6
    resumed = run(acq_path, out_path, settings, resume=True, **kw)
    assert resumed["volumes"] == 0
    assert resumed["skipped_resume"] == 6
    recon = ngff.open_ngff(out_path)
    assert sorted(recon.positions()) == keys
    vol = recon.positions()[keys[0]].volume(2, 0)
    assert np.isfinite(vol).all() and vol.max() > 0
    assert np.abs(recon.positions()[keys[1]].volume(1, 0)).max() < 1e-3
