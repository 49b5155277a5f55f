"""PyTorch port of the acquisition layer (ROADMAP item 12a) against the JAX
package (CPU).

``io/platemap.py``, ``utils/retry.py``, ``engine/autoexposure.py``,
``engine/control.py``, ``engine/plan.py`` and ``engine/replay.py`` are copies
of the JAX package's, pinned statement for statement in
``tests/test_torch_config.py``. Here the JAX tests of them
(``test_platemap.py``, ``test_retry.py``, ``test_autoexposure.py``,
``test_replay_camera.py`` and the ``RunControl`` tests of
``test_control.py``) run on both packages; the engine tests of
``test_control.py`` run in ``tests/test_torch_acquire.py``. The plan's
pydantic models agree with JAX's field for field and schema for schema,
and ``shrimpy-tpu-torch plan new | validate | show`` writes the same YAML,
prints the same JSON and gives the same messages as ``shrimpy-tpu``.
"""

import importlib
import json
import threading

import numpy as np
import pytest
from click.testing import CliRunner
from pydantic import BaseModel

from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.engine import plan as jplan
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.engine import plan as tplan

PACKAGES = ["shrimpy_tpu", "shrimpy_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    """The module of this name in the package under test."""
    return lambda name: importlib.import_module(f"{request.param}.{name}")


# -- test_platemap.py ---------------------------------------------------------

def test_platemap_round_trip(pkg, tmp_path):
    pm = pkg("io.platemap")
    plist = pm.PositionList([
        pm.PositionEntry("A1-000", 100.0, 200.0, 5.0, "A", "1", "000"),
        pm.PositionEntry("free", 1.5, -2.5, 0.0),
    ])
    plist.write(tmp_path / "positions.csv")
    back = pm.PositionList.read(tmp_path / "positions.csv")
    assert back.names() == ["A1-000", "free"]
    assert back.get("A1-000").hcs_key == "A/1/000"
    assert back.get("free").hcs_key is None
    assert back.get("free").y_um == -2.5


def test_platemap_update_coords(pkg):
    pm = pkg("io.platemap")
    plist = pm.PositionList([pm.PositionEntry("P0", 0.0, 0.0, 0.0)])
    plist.update_coords("P0", 10.0, -5.0, 1.0)
    assert plist.get("P0").x_um == 10.0
    with pytest.raises(KeyError):
        plist.update_coords("missing", 0, 0, 0)


def test_platemap_plate_grid(pkg, tmp_path):
    pm = pkg("io.platemap")
    plist = pm.PositionList.from_plate_grid(["A", "B"], ["1", "2", "3"], fovs_per_well=4)
    assert len(plist) == 2 * 3 * 4
    e = plist.get("B/2-003")
    assert e.row == "B" and e.col == "2" and e.fov == "003"
    assert plist.get("B/1-000").y_um - plist.get("A/1-000").y_um == 9000.0
    # The CSV either package writes is the other's, byte for byte.
    plist.write(tmp_path / "ours.csv")
    other = "shrimpy_tpu" if pm.__name__.startswith("shrimpy_tpu_torch") else "shrimpy_tpu_torch"
    theirs = importlib.import_module(f"{other}.io.platemap")
    theirs.PositionList.from_plate_grid(["A", "B"], ["1", "2", "3"], fovs_per_well=4).write(
        tmp_path / "theirs.csv")
    assert (tmp_path / "ours.csv").read_bytes() == (tmp_path / "theirs.csv").read_bytes()


# -- test_retry.py ------------------------------------------------------------

class Flaky:
    def __init__(self, fail_times: int, exc=RuntimeError):
        self.fail_times = fail_times
        self.calls = 0
        self.exc = exc

    def method(self, value=1):
        self.calls += 1
        if self.calls <= self.fail_times:
            raise self.exc("transient")
        return value * 10

    @property
    def attr(self):
        return 42


def test_robust_call_retries_then_succeeds(pkg):
    flaky = Flaky(fail_times=2)
    assert pkg("utils.retry").robust_call(flaky.method, 3, attempts=3, wait_s=0.0) == 30
    assert flaky.calls == 3


def test_robust_call_exhausts_and_raises(pkg):
    flaky = Flaky(fail_times=10)
    with pytest.raises(RuntimeError, match="transient"):
        pkg("utils.retry").robust_call(flaky.method, attempts=3, wait_s=0.0)
    assert flaky.calls == 3


def test_no_retry_exceptions_propagate_immediately(pkg):
    flaky = Flaky(fail_times=5, exc=KeyboardInterrupt)
    with pytest.raises(KeyboardInterrupt):
        pkg("utils.retry").robust_call(flaky.method, attempts=3, wait_s=0.0,
                                       no_retry=(KeyboardInterrupt,))
    assert flaky.calls == 1


def test_retry_decorator(pkg):
    calls = []

    @pkg("utils.retry").retry(attempts=2, wait_s=0.0)
    def sometimes():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("io")
        return "ok"

    assert sometimes() == "ok"
    assert len(calls) == 2


def test_robust_proxy_wraps_methods(pkg):
    flaky = Flaky(fail_times=2)
    proxy = pkg("utils.retry").RobustProxy(flaky, attempts=3, wait_s=0.0)
    assert proxy.method(2) == 20
    assert flaky.calls == 3
    assert proxy.attr == 42  # non-callable attributes pass through
    proxy.fail_times = 0  # writes reach the target
    assert flaky.fail_times == 0


def test_robust_proxy_no_retry_methods(pkg):
    flaky = Flaky(fail_times=5)
    proxy = pkg("utils.retry").RobustProxy(flaky, attempts=3, wait_s=0.0,
                                           no_retry_methods=frozenset({"method"}))
    with pytest.raises(RuntimeError):
        proxy.method()
    assert flaky.calls == 1


# -- test_autoexposure.py -----------------------------------------------------

def _ae_settings(ae):
    return ae.AutoexposureSettings(min_intensity=100.0, max_intensity=60000.0,
                                   target_intensity=30000.0, min_exposure_ms=1.0,
                                   max_exposure_ms=100.0, default_exposure_ms=10.0)


def test_mean_intensity_well_exposed(pkg):
    ae = pkg("engine.autoexposure")
    flag, exp, power = ae.mean_intensity(np.full((32, 32), 30000.0), 10.0, 50.0,
                                         _ae_settings(ae))
    assert flag == 0 and exp == 10.0 and power == 50.0


def test_mean_intensity_underexposed_scales_up(pkg):
    ae = pkg("engine.autoexposure")
    flag, exp, _ = ae.mean_intensity(np.full((32, 32), 50.0), 10.0, 50.0, _ae_settings(ae))
    assert flag == -1
    assert exp == 100.0  # clipped at max


def test_mean_intensity_overexposed_scales_down(pkg):
    ae = pkg("engine.autoexposure")
    flag, exp, _ = ae.mean_intensity(np.full((32, 32), 65000.0), 10.0, 50.0, _ae_settings(ae))
    assert flag == 1
    assert exp == pytest.approx(10.0 * 30000.0 / 65000.0, rel=1e-6)


def test_masked_mean_ignores_hot_pixels(pkg):
    ae = pkg("engine.autoexposure")
    img = np.full((64, 64), 30000.0)
    img[0, 0] = 1e9  # a hot pixel must not trigger overexposure
    flag, exp, _ = ae.masked_mean_intensity(img, 10.0, 50.0, _ae_settings(ae))
    assert flag == 0 and exp == 10.0


def test_intensity_percentile_overexposed(pkg):
    ae = pkg("engine.autoexposure")
    flag, exp, _ = ae.intensity_percentile(np.full((32, 32), 65000.0), 10.0, 50.0,
                                           _ae_settings(ae))
    assert flag == 1
    assert exp == pytest.approx(8.0)  # relative step 0.8


def test_escalation_raises_laser_power_first(pkg):
    ae = pkg("engine.autoexposure")
    calls = []

    def acquire(exposure, power):
        calls.append((exposure, power))
        return np.full((16, 16), power * 10.0)  # brightens with power only

    exp, power, ok = ae.autoexpose_with_escalation(
        acquire, _ae_settings(ae), algorithm="mean_intensity", laser_power=1.0, max_rounds=10)
    assert ok and power > 1.0 and len(calls) >= 2
    ref = importlib.import_module("shrimpy_tpu.engine.autoexposure")
    again = []
    assert ref.autoexpose_with_escalation(
        lambda e, p: again.append((e, p)) or np.full((16, 16), p * 10.0), _ae_settings(ref),
        algorithm="mean_intensity", laser_power=1.0, max_rounds=10) == (exp, power, ok)
    assert again == calls


def test_manual_csv_loader(pkg, tmp_path):
    ae = pkg("engine.autoexposure")
    csv = tmp_path / "illumination.csv"
    csv.write_text("well,exposure_ms,laser_power\nA1,12.5,30\nB2,8.0,50\n")
    table = ae.load_manual_exposures(csv)
    assert table["A1"] == (12.5, 30.0)
    assert table["B2"] == (8.0, 50.0)


# -- test_control.py: RunControl ----------------------------------------------

def test_checkpoint_passes_through_when_running(pkg):
    assert pkg("engine.control").RunControl().checkpoint() == 0.0


def test_abort_raises_and_wins_over_pause(pkg):
    ctl = pkg("engine.control")
    control = ctl.RunControl(poll_s=0.01)
    control.pause()
    control.abort()
    with pytest.raises(ctl.AbortRun):
        control.checkpoint()


def test_pause_blocks_until_resume_and_reports_duration(pkg):
    control = pkg("engine.control").RunControl(poll_s=0.01)
    control.pause()
    timer = threading.Timer(0.15, control.resume)
    timer.start()
    paused = control.checkpoint()
    timer.join()
    assert paused >= 0.1


def test_file_commands_are_picked_up(pkg, tmp_path):
    ctl = pkg("engine.control")
    path = tmp_path / "run_control.json"
    control = ctl.RunControl(path, poll_s=0.01)
    assert json.loads(path.read_text()) == {"command": "run"}

    def write(cmd):
        path.write_text(json.dumps({"command": cmd}))

    write("pause")
    timer = threading.Timer(0.15, write, args=("run",))
    timer.start()
    assert control.checkpoint() >= 0.1
    timer.join()
    write("abort")
    with pytest.raises(ctl.AbortRun):
        control.checkpoint()


def test_stale_abort_resets_but_pause_is_honored(pkg, tmp_path):
    ctl = pkg("engine.control")
    path = tmp_path / "run_control.json"
    path.write_text(json.dumps({"command": "abort"}))
    control = ctl.RunControl(path)
    # A stale abort from a previous run must not kill a new run on arrival.
    assert control.checkpoint() == 0.0
    assert json.loads(path.read_text()) == {"command": "run"}
    path.write_text(json.dumps({"command": "pause"}))
    assert ctl.RunControl(path, poll_s=0.01).command == "pause"  # start-paused


def test_garbage_file_is_ignored(pkg, tmp_path):
    path = tmp_path / "run_control.json"
    control = pkg("engine.control").RunControl(path, poll_s=0.01)
    path.write_text("not json{{")
    assert control.checkpoint() == 0.0
    path.write_text(json.dumps({"command": "definitely-not-a-command"}))
    assert control.checkpoint() == 0.0


def test_request_validates(pkg):
    with pytest.raises(ValueError):
        pkg("engine.control").RunControl().request("halt")


# -- test_replay_camera.py ----------------------------------------------------

@pytest.fixture()
def camera(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(3, 2, 5, 8, 8))
    replay = pkg("engine.replay")
    return replay.ReplayCamera(replay.ReplaySource(tmp_path / "src.zarr")), replay, pkg


def _value(p, t, c, z):
    from shrimpy_tpu_torch.io.synthetic import coordinate_encoded_value

    return coordinate_encoded_value(p, t, c, z)


def test_free_running_snap_auto_increments_t(camera):
    cam, _, _ = camera
    cam.connect_z_stage(origin_um=0.0)
    f0, f1 = cam.snap(), cam.snap()
    assert f0[0, 0] == _value(0, 0, 0, 2) and f1[0, 0] == _value(0, 1, 0, 2)
    cam.snap()
    assert cam.snap()[0, 0] == _value(0, 0, 0, 2)  # wraps at the dataset depth


def test_z_stage_tracking_maps_um_to_index(camera):
    cam, _, _ = camera
    cam.connect_z_stage(origin_um=100.0)
    z_step = cam._z_step_um
    cam.set_z_um(100.0 + 2 * z_step)
    assert cam.snap()[0, 0] == _value(0, 0, 0, 4)
    cam.set_z_um(100.0 - 1 * z_step)
    assert cam.snap()[0, 0] == _value(0, 1, 0, 1)
    cam.set_z_um(100.0 + 50 * z_step)  # clipped at the stack's bounds
    assert cam.snap()[0, 0] == _value(0, 2, 0, 4)
    cam.set_z_um(100.0 - 50 * z_step)
    assert cam.snap()[0, 0] == _value(0, 0, 0, 0)


def test_sequenced_burst_queues_z_indices(camera):
    cam, replay, _ = camera
    cam.on_event(replay.SequencedBurst(
        [replay.AcqEvent(t=1, channel="ch1", z_index=z) for z in (3, 0, 4)]))
    for expect_z in (3, 0, 4):
        assert cam.snap()[0, 0] == _value(0, 1, 1, expect_z)
    # Drained: back to the stage-tracked z, t stays pinned by the event.
    assert cam.snap()[0, 0] == _value(0, 1, 1, 2)


def test_single_event_pins_state(camera):
    cam, replay, _ = camera
    for _ in range(2):  # event-driven: no auto-increment
        cam.on_event(replay.AcqEvent(t=2, channel="ch0", z_index=1))
        assert cam.snap()[0, 0] == _value(0, 2, 0, 1)


def test_event_switches_position_on_plate(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_plate(tmp_path / "plate.zarr", n_positions=2,
                                                 shape_tczyx=(1, 1, 3, 8, 8))
    replay = pkg("engine.replay")
    cam = replay.ReplayCamera(replay.ReplaySource(tmp_path / "plate.zarr"))
    cam.on_event(replay.AcqEvent(t=0, position="0/1/001", z_index=1))
    assert cam.snap()[0, 0] == _value(1, 0, 0, 1)
    with pytest.raises(KeyError):
        cam.on_event(replay.AcqEvent(t=0, position="9/9/999"))


def test_one_volume_cache_decodes_once(camera):
    cam, replay, _ = camera
    src = cam.source
    src.cache_misses = 0
    cam.on_event(replay.SequencedBurst(
        [replay.AcqEvent(t=0, channel="ch0", z_index=z) for z in range(5)]))
    assert cam.snap_volume().shape == (5, 8, 8)
    assert src.cache_misses == 1
    cam.on_event(replay.AcqEvent(t=0, channel="ch1", z_index=0))
    cam.snap()
    assert src.cache_misses == 2
    cam.on_event(replay.AcqEvent(t=0, channel="ch0", z_index=0))  # depth one: re-decodes
    cam.snap()
    assert src.cache_misses == 3


def test_z_um_event_moves_stage(camera):
    cam, replay, _ = camera
    cam.connect_z_stage(origin_um=0.0)
    cam.on_event(replay.AcqEvent(t=0, channel="ch0", z_um=cam._z_step_um))
    assert cam.snap()[0, 0] == _value(0, 0, 0, 3)


def test_burst_z_um_routes_through_stage_model(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(2, 1, 5, 8, 8))
    replay = pkg("engine.replay")
    cam = replay.ReplayCamera(replay.ReplaySource(tmp_path / "src.zarr"), z_step_um=1.0)
    cam.on_event(replay.SequencedBurst(events=[
        replay.AcqEvent(t=0, channel=None, position="0", z_um=float(u))
        for u in (-2.0, -1.0, 0.0, 1.0, 2.0)]))
    for zi in range(5):
        assert cam.snap()[0, 0] == _value(0, 0, 0, zi), zi


def test_replay_volume_rolls_by_minus_the_stage_offset(pkg, tmp_path):
    """The seam DynaTrack's loop closes through: a volume served at a stage
    offset is the volume rolled by minus it, read-only at zero offset."""
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(2, 1, 5, 8, 8))
    src = pkg("engine.replay").ReplaySource(tmp_path / "src.zarr")
    vol = src.volume("0", 1, 0)
    assert not vol.flags.writeable
    np.testing.assert_array_equal(src.volume("0", 1, 0, offset_px_zyx=(1, -2, 3)),
                                  np.roll(vol, (-1, 2, -3), axis=(0, 1, 2)))
    np.testing.assert_array_equal(src.frame("0", 3, 0, 2, offset_px_zyx=(1, -2, 3)),
                                  np.roll(vol, (-1, 2, -3), axis=(0, 1, 2))[2])


# -- engine/plan.py: the models and the plan verbs ---------------------------

PLAN_MODELS = sorted(n for n, v in vars(jplan).items()
                     if isinstance(v, type) and issubclass(v, BaseModel) and v is not BaseModel
                     and v.__module__ == jplan.__name__)


@pytest.mark.parametrize("name", PLAN_MODELS)
def test_plan_models_agree_field_for_field(name):
    ours, theirs = getattr(tplan, name), getattr(jplan, name)
    assert ours is not theirs and ours.__module__ == "shrimpy_tpu_torch.engine.plan"
    assert list(ours.model_fields) == list(theirs.model_fields)
    assert ours.model_json_schema() == theirs.model_json_schema()
    if not any(f.is_required() for f in theirs.model_fields.values()):
        assert ours().model_dump() == theirs().model_dump()


def test_demo_plan_loads_to_equal_dumps_and_problems():
    ours = tplan.AcquisitionPlan.from_yaml("configs/plan_demo.yml")
    theirs = jplan.AcquisitionPlan.from_yaml("configs/plan_demo.yml")
    assert ours.model_dump() == theirs.model_dump()
    assert tplan.validate_plan(ours) == jplan.validate_plan(theirs) == []
    bad = {"camera": {"model_acquisition": True, "mode": "lightsheet"},
           "autoexposure": {"enabled": True, "settings": {"min_exposure_ms": "x"}},
           "metadata": {"dynatrack": {"tracking_method": "nope"}}}
    got = tplan.validate_plan(tplan.AcquisitionPlan(**bad))
    want = jplan.validate_plan(jplan.AcquisitionPlan(**bad))
    assert got == [w.replace("shrimpy_tpu.", "shrimpy_tpu_torch.") for w in want] and got


def _both(args, tmp_path, **kw):
    """The verb in each CLI: (exit code, output after the log lines) and
    any file ``-o`` wrote, for JAX's and the port's."""
    out = []
    for name, group in (("jax", jax_cli), ("torch", cli)):
        argv = [a.replace("{dir}", str(tmp_path / name)) for a in args]
        (tmp_path / name).mkdir(exist_ok=True)
        result = CliRunner().invoke(group, argv, **kw)
        text = "\n".join(line for line in result.output.splitlines()
                         if " INFO " not in line and " WARNING " not in line)
        written = None
        if "-o" in argv:
            path = tmp_path / name / "plan.yml"
            written = path.read_text() if path.exists() else None
        out.append((result.exit_code, text.replace(str(tmp_path / name), "{dir}"), written))
    return out


@pytest.mark.parametrize("answers", ["3\n1.5\nBF,GFP\ny\n0.9\nn\n",
                                     "1\n0\n\nn\ny\nLS\n",
                                     "2\n0.5\nBF\nn\ny\n"])
def test_plan_new_and_show_as_the_jax_cli(answers, tmp_path):
    (j_code, j_text, j_yaml), (t_code, t_text, t_yaml) = _both(
        ["plan", "new", "-o", "{dir}/plan.yml"], tmp_path, input=answers)
    assert t_code == j_code == 0 and t_yaml == j_yaml and t_text == j_text
    (j_code, j_text, _), (t_code, t_text, _) = _both(["plan", "show", "{dir}/plan.yml"], tmp_path)
    assert t_code == j_code == 0 and json.loads(t_text) == json.loads(j_text)


@pytest.mark.parametrize("plan_text,store,valid", [
    (None, False, True),  # configs/plan_demo.yml
    ("time: {n_timepoints: 0}\n", False, False),
    ("channels: []\n", False, False),
    ("time: {n_timepoints: 2}\nchannels: [{name: BF}]\n", True, True),
    ("time: {n_timepoints: 2}\nchannels: [{name: nope}]\n", True, False),
    ("positions: ['9/9/999']\n", True, False),
    ("metadata: {dynatrack: {tracking_method: nope}}\n", False, False),
])
def test_plan_validate_as_the_jax_cli(plan_text, store, valid, tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    args = ["plan", "validate", "configs/plan_demo.yml" if plan_text is None
            else str(tmp_path / "plan.yml")]
    if plan_text is not None:
        (tmp_path / "plan.yml").write_text(plan_text)
    if store:
        synthetic_blob_fov(tmp_path / "src.zarr", shape_zyx=(4, 16, 16), n_timepoints=2,
                           drift_zyx=(0, 0, 0), zyx_scale=(1, 1, 1))
        args += ["--input", str(tmp_path / "src.zarr")]
    (j_code, j_text, _), (t_code, t_text, _) = _both(args, tmp_path)
    assert (t_code == 0) == (j_code == 0) == valid
    assert t_text == j_text.replace("shrimpy_tpu.", "shrimpy_tpu_torch."), (t_text, j_text)
    if valid:
        assert json.loads(t_text.splitlines()[-1])["valid"] is True
