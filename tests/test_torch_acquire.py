"""PyTorch port of the acquisition engine (ROADMAP item 12c) against the JAX
package (CPU): the JAX tests of the event loop run on both packages.

``shrimpy_tpu_torch/engine/engine.py`` is JAX's ``engine/engine.py``
statement for statement but for four differences
(``tests/test_torch_config.py::test_engine_is_the_original_but_for_its_four_differences``;
``tests/test_torch_replay.py`` tests each one). Here ``tests/test_engine.py``
(replay, SkipEvent zero-padding, naming, tracking, refocus, autoexposure,
pacing, plate maps, z striding, grids, camera mode) and the seven engine
tests of ``tests/test_control.py`` (pause, resume and abort, alone and in the
dual-arm session) run on both packages, the port's engine on the CPU.
"""

import csv
import json
import threading
import time

import numpy as np
import pytest
import torch
from scipy import ndimage

from tests.acq_pkgs import PACKAGES, Pkg, package_logging  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture()
def fov_source(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(2, 2, 4, 16, 16))
    return pkg.source(tmp_path / "src.zarr")


def _value(pkg, p, t, c, z):
    return pkg("io.synthetic").coordinate_encoded_value(p, t, c, z)


def _summary(path):
    return json.loads(path.read_text())


def _read(pkg, out):
    return pkg("io.ngff").open_ngff(out)


# -- test_engine.py -------------------------------------------------------------

def test_replay_source_serves_encoded_values(pkg, fov_source):
    vol = fov_source.volume("0", t=1, c=1)
    assert vol[2, 0, 0] == _value(pkg, 0, 1, 1, 2)
    vol = fov_source.volume("0", t=3, c=0)  # timepoint wrap-around
    assert vol[0, 0, 0] == _value(pkg, 0, 1, 0, 0)


def test_basic_acquisition_roundtrip(pkg, tmp_path, fov_source):
    out = pkg.engine(fov_source).acquire(tmp_path / "out", "acq",
                                         pkg.plan(time={"n_timepoints": 2}))
    pos = _read(pkg, out).position()
    assert pos.shape == (2, 2, 4, 16, 16)
    data = pos.read()
    for t in range(2):
        for c in range(2):
            for z in range(4):
                assert data[t, c, z, 0, 0] == _value(pkg, 0, t, c, z)
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["volumes_acquired"] == 4
    assert summary["skipped_autofocus"] == []
    env = summary["environment"]  # the port records torch where JAX records jax
    assert env["python"] and env["numpy"] and env["torch" if pkg.is_port else "jax"]


def test_name_auto_increment(pkg, tmp_path, fov_source):
    eng = pkg.engine(fov_source)
    out1 = eng.acquire(tmp_path / "out", "acq", pkg.plan())
    out2 = eng.acquire(tmp_path / "out", "acq", pkg.plan())
    assert out1.name == "acq.zarr"
    assert out2.name == "acq_1.zarr"
    assert pkg("engine.engine").resolve_acquisition_name(tmp_path / "out", "acq") == "acq_2"


def test_autofocus_failure_zero_pads_on_disk(pkg, tmp_path, fov_source):
    plan = pkg.plan(time={"n_timepoints": 2},
                    autofocus={"enabled": True, "fail_at_indices": [1]})  # t=1, p=0
    out = pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)
    data = _read(pkg, out).position().read()
    assert data[0, 0, 0, 0, 0] == _value(pkg, 0, 0, 0, 0)
    assert np.all(data[1] == 0)
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["skipped_autofocus"] == [[1, "0"]]


def test_hcs_plate_acquisition(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=2,
                                                 shape_tczyx=(1, 1, 3, 8, 8))
    out = pkg.engine(pkg.source(tmp_path / "plate.zarr")).acquire(tmp_path / "out", "plate_acq",
                                                                   pkg.plan())
    store = _read(pkg, out)
    assert store.is_plate
    keys = sorted(store.positions())
    assert keys == ["0/0/000", "0/1/001"]
    for p, key in enumerate(keys):
        assert store.positions()[key].read()[0, 0, 1, 0, 0] == _value(pkg, p, 0, 0, 1)


def test_viewer_hook_errors_are_contained(pkg, tmp_path, fov_source):
    calls = []

    def bad_hook(vol, t, p, channel):
        calls.append((t, channel))
        raise RuntimeError("viewer crashed")

    out = pkg.engine(fov_source, viewer_hooks=[bad_hook]).acquire(tmp_path / "out", "acq",
                                                                   pkg.plan())
    assert out.exists()
    assert len(calls) == 2  # one per channel, errors swallowed


MINUS_I = [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]


def test_tracking_recenters_drifting_blob(pkg, tmp_path):
    """DynaTrack's loop closes: the corrected stage offsets follow the
    drift, so later volumes are re-centred."""
    pkg("io.synthetic").synthetic_blob_fov(tmp_path / "drift.zarr", shape_zyx=(8, 48, 48),
                                           n_timepoints=4, drift_zyx=(0.0, 4.0, -6.0),
                                           noise=0.5, zyx_scale=(1.0, 1.0, 1.0))
    plan = pkg.plan(time={"n_timepoints": 4}, metadata={"dynatrack": {
        "input_channel": "BF", "tracking_channel": "BF", "tracking_method": "pcc",
        "image_to_stage_matrix_xyz": MINUS_I}})
    out = pkg.engine(pkg.source(tmp_path / "drift.zarr")).acquire(tmp_path / "out", "tracked",
                                                                   plan)
    journal = (tmp_path / "out" / "tracked_dynatrack_log.csv").read_text().splitlines()
    assert len(journal) == 1 + 4
    t3 = _read(pkg, out).position().read()[3, 0]
    peak = np.unravel_index(np.argmax(t3), t3.shape)
    uncorrected_err = np.linalg.norm([0, 3 * 4.0, 3 * -6.0])
    corrected_err = np.linalg.norm(np.array(peak) - np.array([4, 24, 24]))
    assert corrected_err < uncorrected_err, (peak, uncorrected_err)


def _defocus_source(pkg, path, *, nz, in_focus, n_t, seed):
    rng = np.random.default_rng(seed)
    sharp = rng.random((48, 48)).astype(np.float32)
    stack = np.stack([ndimage.gaussian_filter(sharp, abs(z - in_focus) * 0.9 + 0.01)
                      for z in range(nz)])
    pos = pkg("io.ngff").create_fov(path, shape=(n_t, 1, nz, 48, 48), dtype="float32",
                                    channel_names=["BF"], zyx_scale=(0.25, 0.116, 0.116))
    for t in range(n_t):
        pos.write((t, 0), stack)
    return pkg.source(path)


def test_periodic_refocus_recenters_z(pkg, tmp_path):
    """A defocused sample: refocus shifts z so the next timepoint is served
    re-centred."""
    nz, in_focus = 15, 11  # +4 from nz // 2
    source = _defocus_source(pkg, tmp_path / "src.zarr", nz=nz, in_focus=in_focus, n_t=2, seed=1)
    plan = pkg.plan(time={"n_timepoints": 2}, refocus={"enabled": True, "interval_timepoints": 1})
    out = pkg.engine(source).acquire(tmp_path / "out", "rf", plan)
    events = _summary(tmp_path / "out" / "rf_summary_metadata.json")["refocus_events"]
    assert events and events[0][2] == in_focus - nz // 2
    data = _read(pkg, out).position().read()
    idx1 = pkg("engine.autofocus").focus_from_transverse_band(data[1, 0], pixel_size_um=0.116,
                                                              **pkg.cpu)
    assert abs(idx1 - nz // 2) <= 1


def test_engine_autoexposure_records_per_position(pkg, tmp_path, fov_source):
    plan = pkg.plan(autoexposure={
        "enabled": True, "algorithm": "mean_intensity",
        "settings": {"min_intensity": 100.0, "max_intensity": 60000.0,
                     "target_intensity": 1000.0, "default_exposure_ms": 10.0,
                     "max_exposure_ms": 100.0}})
    pkg.engine(fov_source).acquire(tmp_path / "out", "ae", plan)
    summary = _summary(tmp_path / "out" / "ae_summary_metadata.json")
    exposure, power = summary["exposures"]["0"]
    assert exposure > 0 and power > 0


def test_engine_autoexposure_manual_csv(pkg, tmp_path, fov_source):
    csv_path = tmp_path / "illum.csv"
    csv_path.write_text("well,exposure_ms,laser_power\n0,12.5,30\n")
    plan = pkg.plan(autoexposure={"enabled": True, "algorithm": "manual",
                                  "manual_csv": str(csv_path)})
    pkg.engine(fov_source).acquire(tmp_path / "out", "ae", plan)
    assert _summary(tmp_path / "out" / "ae_summary_metadata.json")["exposures"]["0"] == [12.5, 30.0]


def test_tracking_with_deskew_preprocessing(pkg, tmp_path):
    """The tracker consumes the deskewed product when a preprocessing chain
    is configured: the journal holds the lab-frame motion."""
    render = pkg("io.synthetic").render_beads_skewed
    raw0 = render((48, 24, 24), np.array([[5.0, 40.0, 12.0]]))
    raw1 = render((48, 24, 24), np.array([[5.0, 44.0, 10.0]]))
    pos = pkg("io.ngff").create_fov(tmp_path / "src.zarr", shape=(2, 1, 48, 24, 24),
                                    dtype="float32", channel_names=["LS"],
                                    zyx_scale=(0.3, 0.116, 0.116))
    pos.write((0, 0), raw0)
    pos.write((1, 0), raw1)
    plan = pkg.plan(time={"n_timepoints": 2}, metadata={"dynatrack": {
        "input_channel": "LS", "tracking_channel": "LS", "tracking_method": "pcc",
        "preprocessing": ["deskew"],
        "deskew": {"ls_angle_deg": 30.0, "px_to_scan_ratio": 0.386}}})
    pkg.engine(pkg.source(tmp_path / "src.zarr")).acquire(tmp_path / "out", "pre", plan)
    journal = (tmp_path / "out" / "pre_dynatrack_log.csv").read_text().splitlines()
    assert len(journal) == 3
    row = list(csv.DictReader(iter(journal)))[1]
    assert abs(float(row["shift_y_px"]) - 4.0) <= 1.0
    assert abs(float(row["shift_x_px"]) + 2.0) <= 1.0


def test_refocus_offsets_survive_chunked_acquisitions(pkg, tmp_path):
    nz, in_focus = 15, 10  # +3 from the centre
    _defocus_source(pkg, tmp_path / "src.zarr", nz=nz, in_focus=in_focus, n_t=1, seed=2)
    plan = pkg.plan(refocus={"enabled": True, "interval_timepoints": 1})
    pkg.engine(pkg.source(tmp_path / "src.zarr")).acquire(tmp_path / "out", "chunked", plan)
    eng2 = pkg.engine(pkg.source(tmp_path / "src.zarr"))
    eng2.acquire(tmp_path / "out", "chunked", plan)
    assert eng2._refocus_z.get("0", 0) == in_focus - nz // 2
    assert _summary(tmp_path / "out" / "chunked_1_summary_metadata.json")["refocus_events"] == []


def test_timepoint_interval_pacing(pkg, tmp_path, fov_source):
    t0 = time.monotonic()
    pkg.engine(fov_source).acquire(tmp_path / "out", "paced",
                                   pkg.plan(time={"n_timepoints": 3, "interval_s": 0.15}))
    assert time.monotonic() - t0 >= 0.3  # two inter-timepoint gaps
    assert _summary(tmp_path / "out" / "paced_summary_metadata.json")["interval_overruns"] == []


def test_latency_budget_overrun_recorded(pkg, tmp_path, fov_source):
    """An updater slower than the interval blows the latency budget; the
    summary records each late timepoint."""
    position = pkg("tracking.position")

    class SlowTrackingEngine(pkg("engine.engine").AcquisitionEngine):
        def _setup_tracking(self, plan, channels, out_dir, acq_name=None):
            def slow_updater(stack, t, p):
                time.sleep(0.25)  # > interval_s
                return np.zeros(3)

            self._tracking = position.PositionUpdateManager(position.PositionStore(),
                                                            slow_updater)
            self._track_channel_idx = 0

    SlowTrackingEngine(fov_source, **pkg.cpu).acquire(
        tmp_path / "out", "slow", pkg.plan(time={"n_timepoints": 3, "interval_s": 0.05}))
    overruns = _summary(tmp_path / "out" / "slow_summary_metadata.json")["interval_overruns"]
    assert len(overruns) == 2
    assert all(lateness > 0 for _, lateness in overruns)


def test_positions_from_platemap_csv(pkg, tmp_path):
    pm = pkg("io.platemap")
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=2,
                                                 shape_tczyx=(1, 1, 3, 8, 8))
    pm.PositionList([pm.PositionEntry("B-000", row="0", col="1", fov="001")]).write(
        tmp_path / "positions.csv")
    out = pkg.engine(pkg.source(tmp_path / "plate.zarr")).acquire(
        tmp_path / "out", "subset", pkg.plan(positions_csv=str(tmp_path / "positions.csv")))
    assert sorted(_read(pkg, out).positions()) == ["0/1/001"]


def test_positions_csv_unknown_key_raises(pkg, tmp_path):
    pm = pkg("io.platemap")
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=1,
                                                 shape_tczyx=(1, 1, 2, 8, 8))
    pm.PositionList([pm.PositionEntry("X", row="9", col="9", fov="999")]).write(
        tmp_path / "bad.csv")
    with pytest.raises(ValueError, match="not in"):
        pkg.engine(pkg.source(tmp_path / "plate.zarr")).acquire(
            tmp_path / "out", "x", pkg.plan(positions_csv=str(tmp_path / "bad.csv")))


def test_engine_reuse_across_acquisitions(pkg, tmp_path, fov_source):
    """Per-run state resets at acquire(): a tracked run then an untracked one."""
    tracked = pkg.plan(time={"n_timepoints": 2}, metadata={"dynatrack": {
        "input_channel": "ch0", "tracking_channel": "ch0", "tracking_method": "pcc"}})
    eng = pkg.engine(fov_source)
    eng.acquire(tmp_path / "out", "first", tracked)
    out2 = eng.acquire(tmp_path / "out", "second", pkg.plan())
    assert out2.exists()
    assert eng._tracking is None
    assert _summary(tmp_path / "out" / "second_summary_metadata.json")["refocus_events"] == []


def test_plan_validation_errors_early(pkg, tmp_path, fov_source):
    with pytest.raises(ValueError, match="exceeds the source depth"):
        pkg.engine(fov_source).acquire(tmp_path / "o1", "x", pkg.plan(z={"n_slices": 99}))
    with pytest.raises(ValueError, match="not in the source store"):
        pkg.engine(fov_source).acquire(tmp_path / "o2", "x", pkg.plan(positions=["9/9/999"]))
    with pytest.raises(ValueError, match="interval_timepoints"):
        pkg.plan(refocus={"enabled": True, "interval_timepoints": 0})


def test_unrelated_acquisition_does_not_seed_refocus(pkg, tmp_path, fov_source):
    (tmp_path / "out").mkdir(parents=True)
    (tmp_path / "out" / "plate_ctrl_summary_metadata.json").write_text(
        json.dumps({"refocus_events": [[0, "0", 5]]}))
    pkg.engine(fov_source).acquire(tmp_path / "out", "plate",
                                   pkg.plan(refocus={"enabled": True}))
    summary = _summary(tmp_path / "out" / "plate_summary_metadata.json")
    assert [e for e in summary["refocus_events"] if e[2] == 5] == []


def test_z_step_um_strides_the_source(pkg, tmp_path, fov_source):
    out = pkg.engine(fov_source).acquire(tmp_path / "out", "acq", pkg.plan(z={"step_um": 2.0}))
    pos = _read(pkg, out).position()
    assert pos.shape[2] == 2  # slices 0, 2 of 4
    assert pos.read()[0, 0, 1, 0, 0] == _value(pkg, 0, 0, 0, 2)
    assert pos.zyx_scale[0] == pytest.approx(2.0)
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["z_indices"] == [0, 2]
    assert summary["z_scale_um"] == pytest.approx(2.0)


def test_z_step_um_non_integer_stride_rejected(pkg, tmp_path, fov_source):
    with pytest.raises(ValueError, match="integer multiple"):
        pkg.engine(fov_source).acquire(tmp_path / "out", "acq", pkg.plan(z={"step_um": 1.5}))


def test_channel_exposure_scales_brightness(pkg, tmp_path, fov_source):
    plan = pkg.plan(channels=[{"name": "ch0", "exposure_ms": 20.0},
                              {"name": "ch1", "exposure_ms": 10.0}], source_exposure_ms=10.0)
    data = _read(pkg, pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)).position(
    ).read()
    assert data[0, 0, 1, 0, 0] == pytest.approx(2.0 * _value(pkg, 0, 0, 0, 1))
    assert data[0, 1, 1, 0, 0] == pytest.approx(_value(pkg, 0, 0, 1, 1))
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["channel_exposures_ms"] == {"ch0": 20.0, "ch1": 10.0}


GRID = {"plate": {"rows": 2, "columns": 3}, "selected_wells": [[1], [0, 2]],
        "well_points_plan": {"rows": 1, "columns": 2, "overlap": [0.0, 50.0]}}


def test_stage_positions_grid_generates_offset_tiles(pkg, tmp_path, fov_source):
    out = pkg.engine(fov_source).acquire(tmp_path / "out", "acq",
                                         pkg.plan(stage_positions=GRID))
    store = _read(pkg, out)
    assert list(store.positions()) == ["B/1/000000", "B/1/000001", "B/3/000000", "B/3/000001"]
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    grid = {k: tuple(v) for k, v in summary["stage_position_grid"]}
    assert grid["B/1/000000"] == (0, -4)
    assert grid["B/1/000001"] == (0, 4)
    tile = store.positions()["B/1/000001"].volume(0, 0)
    np.testing.assert_array_equal(np.asarray(tile), np.roll(fov_source.volume("0", 0, 0), -4,
                                                            axis=2).astype(np.float32))


def test_stage_positions_exclusive_with_positions(pkg):
    with pytest.raises(ValueError, match="only one of"):
        pkg.plan(positions=["0"], stage_positions={"plate": {"rows": 1, "columns": 1}})


def test_camera_mode_matches_volume_mode(pkg, tmp_path):
    """Frame-sequenced acquisition is voxel-identical to the volume path,
    tracking offsets included."""
    path = tmp_path / "src.zarr"
    pkg("io.synthetic").synthetic_blob_fov(path, shape_zyx=(8, 32, 32), n_timepoints=3,
                                           drift_zyx=(0.0, 1.5, -1.0))
    meta = {"dynatrack": {"input_channel": "BF", "tracking_channel": "BF",
                          "tracking_method": "pcc"}}
    out_v = pkg.engine(pkg.source(path)).acquire(
        tmp_path / "ov", "acq", pkg.plan(time={"n_timepoints": 3}, metadata=meta))
    out_c = pkg.engine(pkg.source(path)).acquire(
        tmp_path / "oc", "acq", pkg.plan(time={"n_timepoints": 3}, mode="camera", metadata=meta))
    np.testing.assert_array_equal(np.asarray(_read(pkg, out_v).position().read()),
                                  np.asarray(_read(pkg, out_c).position().read()))
    assert _summary(tmp_path / "oc" / "acq_summary_metadata.json")["mode"] == "camera"


def test_camera_mode_with_z_stride_and_exposure(pkg, tmp_path, fov_source):
    plan = pkg.plan(mode="camera", z={"step_um": 2.0}, channels=[{"name": "ch1",
                                                                  "exposure_ms": 5.0}])
    data = _read(pkg, pkg.engine(fov_source).acquire(tmp_path / "out", "acq", plan)).position(
    ).read()
    assert data.shape[1:3] == (1, 2)
    assert data[0, 0, 1, 0, 0] == pytest.approx(0.5 * _value(pkg, 0, 0, 1, 2))


def test_refocus_corrects_in_source_slices_under_z_stride(pkg, tmp_path):
    """Under a z stride the refocus correction is applied in source slices."""
    nz, in_focus = 16, 12  # stride 2 puts it on the grid
    source = _defocus_source(pkg, tmp_path / "src.zarr", nz=nz, in_focus=in_focus, n_t=2, seed=2)
    plan = pkg.plan(time={"n_timepoints": 2}, z={"step_um": 0.5},
                    refocus={"enabled": True, "interval_timepoints": 1})
    out = pkg.engine(source).acquire(tmp_path / "out", "rf", plan)
    assert _summary(tmp_path / "out" / "rf_summary_metadata.json")["refocus_events"][0][2] == 4
    data = _read(pkg, out).position().read()
    idx1 = pkg("engine.autofocus").focus_from_transverse_band(data[1, 0], pixel_size_um=0.116,
                                                              **pkg.cpu)
    assert idx1 == 4


def test_autoexposure_model_matches_replay_brightness(pkg, tmp_path, fov_source):
    src_mid = fov_source.volume("0", 0, 0)
    target = 3.0 * float(np.mean(src_mid[src_mid.shape[0] // 2]))
    plan = pkg.plan(source_exposure_ms=20.0, autoexposure={
        "enabled": True, "algorithm": "mean_intensity",
        "settings": {"min_intensity": 0.9 * target, "max_intensity": 1.1 * target,
                     "target_intensity": target, "default_exposure_ms": 10.0,
                     "max_exposure_ms": 500.0}})
    data = _read(pkg, pkg.engine(fov_source).acquire(tmp_path / "out", "ae", plan)).position(
    ).read()
    mid = data[0, 0, data.shape[2] // 2]
    assert 0.9 * target <= float(np.mean(mid)) <= 1.1 * target


def test_plate_row_names_past_z(pkg):
    row = pkg("engine.plan")._plate_row_name
    assert [row(i) for i in (0, 1, 25, 26, 27, 51, 52)] == ["A", "B", "Z", "AA", "AB", "AZ",
                                                            "BA"]
    plan = pkg.plan(stage_positions={"plate": {"rows": 32, "columns": 1},
                                     "selected_wells": [[31], [0]]})
    assert plan.stage_positions.generate((16, 16), (1.0, 1.0))[0].key == "AF/1/000000"


def test_overlap_at_or_above_100_is_rejected(pkg):
    with pytest.raises(ValueError, match="overlap"):
        pkg.plan(stage_positions={"plate": {"rows": 1, "columns": 1},
                                  "well_points_plan": {"rows": 1, "columns": 2,
                                                       "overlap": [0.0, 100.0]}})


# -- test_control.py: the engine under run control --------------------------------

@pytest.fixture()
def long_source(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "long.zarr", shape=(4, 1, 4, 16, 16))
    return pkg.source(tmp_path / "long.zarr")


def test_abort_between_timepoints(pkg, tmp_path, long_source):
    control = pkg("engine.control").RunControl()
    hit = []

    def hook(t):
        hit.append(t)
        if t == 2:
            control.abort()

    engine = pkg.engine(long_source, timepoint_hook=hook)
    out = engine.acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 4}),
                         run_control=control)
    assert engine.aborted_at == [3, None]  # the t=3 checkpoint caught it
    assert hit == [0, 1, 2]
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["aborted_at"] == [3, None]
    assert summary["volumes_acquired"] == 3
    data = _read(pkg, out).position().read()
    assert data[2].max() > 0
    assert data[3].max() == 0


def test_abort_at_position_boundary(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=2,
                                                 shape_tczyx=(2, 1, 3, 12, 12))
    control = pkg("engine.control").RunControl()

    def hook(vol, t, p, channel):
        if t == 1:  # the cut comes at the next position boundary
            control.abort()

    engine = pkg.engine(pkg.source(tmp_path / "plate.zarr"), viewer_hooks=[hook])
    out = engine.acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 2}),
                         run_control=control)
    assert tuple(engine.aborted_at) == (1, "0/1/001")
    store = _read(pkg, out)
    assert store.positions()["0/0/000"].read()[1].max() > 0
    assert store.positions()["0/1/001"].read()[1].max() == 0


def test_pause_excluded_from_pacing(pkg, tmp_path, long_source):
    control = pkg("engine.control").RunControl(poll_s=0.01)
    resumer = []

    def hook(t):
        if t == 0:
            control.pause()
            timer = threading.Timer(0.6, control.resume)
            timer.start()
            resumer.append(timer)

    engine = pkg.engine(long_source, timepoint_hook=hook)
    engine.acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 3, "interval_s": 0.05}),
                   run_control=control)
    resumer[0].join()
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["aborted_at"] is None
    assert summary["paused_s"] >= 0.2
    assert all(s < 0.3 for _, s in summary["interval_overruns"]), summary


def test_abort_via_file_from_another_thread(pkg, tmp_path, long_source):
    path = tmp_path / "run_control.json"
    control = pkg("engine.control").RunControl(path, poll_s=0.01)

    def hook(t):
        if t == 1:
            path.write_text(json.dumps({"command": "abort"}))

    engine = pkg.engine(long_source, timepoint_hook=hook)
    engine.acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 4}),
                   run_control=control)
    assert engine.aborted_at == [2, None]


def _two_arms(pkg, tmp_path):
    for arm in ("a", "b"):
        pkg("io.synthetic").coordinate_encoded_fov(tmp_path / f"{arm}.zarr",
                                                   shape=(4, 1, 3, 12, 12))
    plan = pkg.plan(time={"n_timepoints": 4})
    return {"lf": (pkg.source(tmp_path / "a.zarr"), plan),
            "ls": (pkg.source(tmp_path / "b.zarr"), plan.model_copy(deep=True))}


def test_dual_arm_shared_abort(pkg, tmp_path):
    control = pkg("engine.control").RunControl(poll_s=0.01)

    def lf_hook(vol, t, p, channel):
        if t == 1:  # both arms cut at their next pre-barrier checkpoint
            control.abort()

    session = pkg.dual(_two_arms(pkg, tmp_path), barrier_timeout_s=30.0,
                       viewer_hooks={"lf": [lf_hook]}, run_control=control)
    results = session.run(tmp_path / "out", "dual")
    for r in results.values():
        assert r.aborted or (r.error and "barrier" in r.error), r
    assert any(r.aborted for r in results.values()), results


def test_dual_arm_lockstep_pause(pkg, tmp_path):
    """A pause blocks every arm after the barrier and stays out of pacing."""
    control = pkg("engine.control").RunControl(poll_s=0.01)
    timers = []

    def lf_hook(vol, t, p, channel):
        if t == 1 and not timers:
            control.pause()
            timer = threading.Timer(0.5, control.resume)
            timer.start()
            timers.append(timer)

    session = pkg.dual(_two_arms(pkg, tmp_path), barrier_timeout_s=5.0,
                       viewer_hooks={"lf": [lf_hook]}, run_control=control)
    results = session.run(tmp_path / "out", "dual")
    timers[0].join()
    for r in results.values():
        assert r.error is None and not r.aborted, r
    for arm in ("lf", "ls"):
        summary = _summary(tmp_path / "out" / f"dual_{arm}_summary_metadata.json")
        assert summary["paused_s"] > 0.1, (arm, summary["paused_s"])
        assert summary["aborted_at"] is None


def test_raising_hook_still_writes_summary(pkg, tmp_path, long_source):
    """An exception out of the hook still runs teardown and leaves a summary
    recording the error."""
    def hook(t):
        if t == 2:
            raise threading.BrokenBarrierError()

    engine = pkg.engine(long_source, timepoint_hook=hook)
    with pytest.raises(threading.BrokenBarrierError):
        engine.acquire(tmp_path / "out", "acq", pkg.plan(time={"n_timepoints": 4}))
    summary = _summary(tmp_path / "out" / "acq_summary_metadata.json")
    assert summary["error"] == "BrokenBarrierError()"
    assert summary["volumes_acquired"] == 2
    assert summary["aborted_at"] is None
