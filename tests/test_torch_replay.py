"""PyTorch port of the acquisition engine (ROADMAP item 12c): its four
differences from JAX's, the plan namespace, the card's stand-ins and the
``replay`` and ``replay-dual`` verbs, against the JAX package (CPU).

* **Parity.** JAX's engine and the port's acquire one two-position plate
  with DynaTrack ``pcc`` after ``[deskew]``, with -I and with
  ``chip_smoke.loop_matrix`` as the image-to-stage matrix: the output stores
  are bit-equal, the journals equal but for their wall times, the stage
  positions within 1e-6 um, the summary sidecars equal but for
  ``wall_time_s`` and ``environment``. The port runs a pydantic plan and
  the namespace of ``config.acquisition_plan`` alike (its "any plan"
  difference).
* **The plan namespace.** ``config.acquisition_plan(**plan.model_dump())``
  equals the plan field for field and method for method, keeps the
  validators' rules and messages, and raises for the host emulations it
  does not carry.
* **The stand-ins** of ``chip_smoke.py`` phase 4r (``MemorySource``,
  ``MemoryStore``): the engine run through them writes what it writes
  through ``ReplaySource`` and ``io/ngff.py``.
* **The differences** of ``engine/engine.py`` (pinned in
  ``tests/test_torch_config.py``), each on its own: ``_setup_tracking``'s
  namespace config and its injection, ``device``, the deferred imports
  (with ``tests/test_torch_iter.py``'s subprocess gate), any plan object.
* **The verbs.** ``shrimpy-tpu-torch replay`` and ``replay-dual`` write
  the JAX CLI's stores, sidecars and messages; ``replay --viewer`` cites
  ROADMAP item 12d.
"""

import ast
import csv
import functools
import json
import logging
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from pydantic import BaseModel

import chip_smoke
from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.config.schemas import DynaTrackConfig as JaxDynaTrackConfig
from shrimpy_tpu.config.schemas import inject_derived_parameters as jax_inject
from shrimpy_tpu.engine import plan as jplan
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.engine import plan as tplan
from tests.acq_pkgs import PACKAGES, Pkg, package_logging  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
POSITION_ATOL_UM = 1e-6
RAW = (120, 64, 160)  # raw (scan, tilt, x), as tests/test_torch_position.py's loop
DRIFT = (2, 0, 3)  # raw px (scan, tilt, x) a timepoint
N_T = 4
KEYS = ("0/0/000", "0/1/001")
CHANNELS = ("LS", "GFP")
DESKEW = tconfig.deskew_settings(ls_angle_deg=30.0, px_to_scan_ratio=0.386)
RAW_SCALE = chip_smoke.loop_raw_scale(DESKEW)
MATRICES = {"minus_identity": [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
            "loop_matrix": chip_smoke.loop_matrix(DESKEW, RAW_SCALE)}


def _raw0(seed: int) -> np.ndarray:
    """Six seeded blobs rendered at the raw voxels from their deskewed
    coordinates, on a camera offset."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    g = _geometry(RAW, DESKEW)
    ns, nt, nx = RAW
    s = np.arange(ns, dtype=np.float64)[:, None, None]
    t = np.arange(nt, dtype=np.float64)[None, :, None]
    x = np.arange(nx, dtype=np.float64)[None, None, :]
    zd, yd = t * g["sin_t"], s / g["r"] + t * g["cos_t"] - g["y_offset"]
    rng = np.random.default_rng(seed)
    raw = np.full(RAW, 100.0)
    for i in range(6):
        c = [m + rng.random() * (n - 2 * m)
             for n, m in zip((g["nz_full"], g["ny"], nx), (6.0, 30.0, 20.0))]
        amp = 4000.0 if i == 0 else 500.0 + 1000.0 * rng.random()
        arg = ((zd - c[0]) / 2.0) ** 2 + ((yd - c[1]) / 4.0) ** 2 + ((x - c[2]) / 4.0) ** 2
        raw += amp * np.exp(-0.5 * arg)
    return raw.astype(np.float32)


@pytest.fixture(scope="module")
def plate(tmp_path_factory) -> Path:
    """A two-position plate of N_T timepoints and CHANNELS: each position's
    sample (its own blobs) drifts DRIFT a timepoint, the second channel at
    half the brightness, each volume with noise of its own."""
    from shrimpy_tpu_torch.io import ngff

    path = tmp_path_factory.mktemp("plate") / "plate.zarr"
    store = ngff.create_hcs(path, channel_names=list(CHANNELS))
    for i, key in enumerate(KEYS):
        row, col, fov = key.split("/")
        pos = store.create_position(row, col, fov, channel_names=list(CHANNELS),
                                    zyx_scale=RAW_SCALE)
        pos.create_array((N_T, len(CHANNELS), *RAW), dtype="float32")
        raw0 = _raw0(17 + i)
        for t in range(N_T):
            moved = np.roll(raw0, tuple(t * d for d in DRIFT), axis=(0, 1, 2))
            for c in range(len(CHANNELS)):
                noise = np.random.default_rng((i, t, c)).normal(0.0, 10.0, RAW)
                pos.write((t, c), (moved * (0.5 if c else 1.0) + noise).astype(np.float32))
    return path


def _plan_fields(matrix: str) -> dict:
    return {"time": {"n_timepoints": N_T}, "channels": [{"name": c} for c in CHANNELS],
            "metadata": {"dynatrack": {
                "input_channel": "LS", "tracking_channel": "LS", "tracking_method": "pcc",
                "preprocessing": ["deskew"],
                "deskew": {"ls_angle_deg": 30.0, "px_to_scan_ratio": 0.386},
                "image_to_stage_matrix_xyz": MATRICES[matrix]}}}


def _journal(path: Path) -> list:
    """The journal's rows but for their wall times."""
    with open(path) as f:
        rows = list(csv.reader(f))
    return [rows[0]] + [r[1:] for r in rows[1:]]


def _summary(path: Path) -> dict:
    s = json.loads(path.read_text())
    return {k: v for k, v in s.items() if k not in ("wall_time_s", "environment")}


def _outputs(out_path: Path) -> dict:
    from shrimpy_tpu_torch.io import ngff

    return {k: np.asarray(p.read()) for k, p in ngff.open_ngff(out_path).positions().items()}


@functools.lru_cache(maxsize=None)
def _run(package: str, plan_kind: str, matrix: str, plate: Path, out_dir: Path) -> dict:
    """One engine run of ``package`` on the plate: the outputs, the journal,
    the summary and the stage."""
    pkg = Pkg(package)
    fields = _plan_fields(matrix)
    plan = tconfig.acquisition_plan(**fields) if plan_kind == "namespace" else pkg.plan(
        **fields)
    engine = pkg.engine(pkg.source(plate))
    out = engine.acquire(out_dir, "acq", plan)
    return {"outputs": _outputs(out), "journal": _journal(out_dir / "acq_dynatrack_log.csv"),
            "summary": _summary(out_dir / "acq_summary_metadata.json"),
            "stage": {k: engine._tracking.store.get(k).as_array() for k in KEYS}}


@pytest.fixture(scope="module")
def runs(plate, tmp_path_factory):
    def run(package, plan_kind, matrix):
        out = tmp_path_factory.mktemp(f"{package}_{plan_kind}_{matrix}")
        return _run(package, plan_kind, matrix, plate, out)
    return run


# -- parity: JAX's engine and the port's on one plate ------------------------------

@pytest.mark.parametrize("matrix", sorted(MATRICES))
@pytest.mark.parametrize("plan_kind", ["pydantic", "namespace"])
def test_engine_writes_jax_s_store_journal_and_summary(runs, plan_kind, matrix):
    """The port's engine (with either plan object: the "any plan"
    difference) writes JAX's output stores bit for bit, its journal and its
    summary, and leaves the stage where JAX's does."""
    theirs = runs("shrimpy_tpu", "pydantic", matrix)
    ours = runs("shrimpy_tpu_torch", plan_kind, matrix)
    assert sorted(ours["outputs"]) == sorted(theirs["outputs"]) == list(KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(ours["outputs"][key], theirs["outputs"][key])
        np.testing.assert_allclose(ours["stage"][key], theirs["stage"][key], rtol=0,
                                   atol=POSITION_ATOL_UM)
    assert len(ours["journal"]) == 1 + N_T * len(KEYS)
    assert ours["journal"] == theirs["journal"]
    assert ours["summary"] == theirs["summary"]
    assert ours["summary"]["volumes_acquired"] == N_T * len(KEYS) * len(CHANNELS)


def test_loop_matrix_recentres_each_position_and_minus_identity_does_not(runs, plate):
    """From t = 2 the loop matrix leaves each position's sample within 1 raw
    px of where it started once corrected; -I does not (the deskewed y
    drift is a scan drift of the raw)."""
    def residual(run):
        """Each position's sample off where it started, raw px, at the end."""
        out = []
        for key in KEYS:
            offset = [round(v / s) for v, s in zip(run["stage"][key][::-1], RAW_SCALE)]
            out.append(max(abs((N_T - 1) * d - o) for d, o in zip(DRIFT, offset)))
        return out

    assert max(residual(runs("shrimpy_tpu_torch", "namespace", "loop_matrix"))) <= 1
    assert min(residual(runs("shrimpy_tpu_torch", "namespace", "minus_identity"))) > 1


# -- the plan namespace ------------------------------------------------------------

PLANS = {
    "demo": None,  # configs/plan_demo.yml
    "defaults": {},
    "tracked": _plan_fields("loop_matrix"),
    "blocks": {"time": {"n_timepoints": 3, "interval_s": 0.5}, "z": {"n_slices": 2,
                                                                      "step_um": 2.0},
               "positions": ["0/0/000"], "source_exposure_ms": 20.0, "mode": "camera",
               "autofocus": {"enabled": True, "fail_at_indices": [1], "seed": 3},
               "refocus": {"enabled": True, "interval_timepoints": 2, "channel": "LS"},
               "stage": {"slow_speed_mm_s": 1.0}, "watchdog_s": 5.0,
               "camera": {"mode": "lightsheet", "readout_ms": 12.0, "max_sequenced_events": 9},
               "hardware": {"lasers": [{"channel": "LS", "power_mw": 5.0}], "o3_port": "k"},
               "autoexposure": {"algorithm": "manual", "settings": {"target_intensity": 9.0}}},
}


def _jax_plan(name):
    if PLANS[name] is None:
        return jplan.AcquisitionPlan.from_yaml(REPO / "configs/plan_demo.yml")
    return jplan.AcquisitionPlan(**PLANS[name])


def _same(ns, model, where="plan"):
    """The namespace equals the pydantic model field for field, block for
    block."""
    fields = list(type(model).model_fields)
    assert list(vars(ns)) == fields, where
    for name in fields:
        a, b = getattr(ns, name), getattr(model, name)
        if isinstance(b, BaseModel):
            _same(a, b, f"{where}.{name}")
        elif isinstance(b, list) and b and isinstance(b[0], BaseModel):
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                _same(x, y, f"{where}.{name}[{i}]")
        else:
            assert a == b, f"{where}.{name}"


@pytest.mark.parametrize("name", sorted(PLANS))
def test_acquisition_plan_carries_a_jax_plan_across(name):
    """``acquisition_plan(**plan.model_dump())`` equals the plan field for
    field and method for method, for JAX's plan and the port's."""
    for model in (_jax_plan(name), tplan.AcquisitionPlan(**_jax_plan(name).model_dump())):
        ns = tconfig.acquisition_plan(**model.model_dump())
        _same(ns, model)
        assert ns.model_dump() == model.model_dump()
        assert ns.dynatrack_metadata() == model.dynatrack_metadata()
        for available in (["0/0/000", "0/1/001"], ["0"], []):
            for plan in (ns, model):
                try:
                    got = plan.resolve_positions(available)
                except ValueError as e:
                    got = str(e)
                if plan is ns:
                    ours = got
            assert ours == got
        for nz, z_um in ((16, 1.0), (9, 2.0), (16, 0.5), (4, 1.0)):
            out = []
            for z in (ns.z, model.z):
                try:
                    out.append(z.resolve_z_indices(nz, z_um))
                except ValueError as e:
                    out.append(str(e))
            assert out[0] == out[1]
    # The namespace's dump is a copy: mutating it leaves the plan as it was.
    ns = tconfig.acquisition_plan(**_jax_plan("tracked").model_dump())
    ns.model_dump()["metadata"]["dynatrack"]["tracking_method"] = "nope"
    assert ns.dynatrack_metadata()["tracking_method"] == "pcc"


def test_acquisition_plan_methods_are_the_plan_s_statement_for_statement():
    """``resolve_z_indices``, ``resolve_positions`` and
    ``dynatrack_metadata`` are ``engine/plan.py``'s methods."""
    def methods(path, classes):
        tree = ast.parse(path.read_text().replace("shrimpy_tpu_torch", "shrimpy_tpu"))
        out = {}
        for cls in tree.body:
            if isinstance(cls, ast.ClassDef) and cls.name in classes:
                for fn in cls.body:
                    if isinstance(fn, ast.FunctionDef) and not fn.name.startswith("_") \
                            and fn.name not in ("model_dump", "from_yaml"):
                        out[fn.name] = ast.dump(fn)
        return out

    ours = methods(REPO / "shrimpy_tpu_torch/config/__init__.py", ("ZBlock", "PlanNamespace"))
    theirs = methods(REPO / "shrimpy_tpu/engine/plan.py", ("ZPlan", "AcquisitionPlan"))
    assert sorted(ours) == ["dynatrack_metadata", "resolve_positions", "resolve_z_indices"]
    assert ours == {k: theirs[k] for k in ours}


@pytest.mark.parametrize("fields,message", [
    ({"time": {"n_timepoints": 0}}, "n_timepoints must be >= 1"),
    ({"channels": [{"name": "a", "exposure_ms": 0.0}]}, "exposure_ms must be > 0"),
    ({"channels": []}, "channels must be a non-empty list"),
    ({"positions": []}, "positions must be a non-empty list"),
    ({"z": {"step_um": 0.0}}, "step_um must be > 0"),
    ({"z": {"n_slices": 0}}, "n_slices must be >= 1"),
    ({"autofocus": {"success_rate": 90.0, "enabled": True}}, "success_rate must be in [0, 1]"),
    ({"autofocus": {"fail_at_indices": [1]}}, "require enabled: true"),
    ({"refocus": {"interval_timepoints": 0}}, "interval_timepoints must be >= 1"),
    ({"stage": {"fast_speed_mm_s": 0.0}}, "stage speeds must be > 0"),
    ({"stage": {"time_scale": -1.0}}, "time_scale must be >= 0"),
    ({"stage": {"negligible_distance_um": -1.0}}, "negligible_distance_um must be >= 0"),
    ({"camera": {"readout_ms": 0.0}}, "camera.readout_ms must be > 0"),
    ({"camera": {"time_scale": -1.0}}, "camera.time_scale must be >= 0"),
    ({"camera": {"channel_change_ms": -1.0}}, "camera.channel_change_ms must be >= 0"),
    ({"camera": {"max_sequenced_events": 0}}, "camera.max_sequenced_events must be >= 1"),
    ({"hardware": {"o3_steps_per_slice": 0}}, "hardware.o3_steps_per_slice must be >= 1"),
    ({"hardware": {"lasers": [{"channel": "a"}, {"channel": "a"}]}}, "duplicate channel"),
    ({"hardware": {"lasers": [{"channel": "a", "power_mw": 200.0}]}}, "exceeds max_power_mw"),
    ({"hardware": {"lasers": [{"channel": "a", "power_mw": -1.0}]}},
     "laser powers must be positive"),
    ({"axis_order": "tczp"}, "only axis_order='tpcz' is supported"),
    ({"positions": ["a"], "positions_csv": "p.csv"}, "set only one of"),
    ({"source_exposure_ms": 0.0}, "source_exposure_ms must be > 0"),
])
def test_acquisition_plan_keeps_the_validators_rules_and_messages(fields, message):
    with pytest.raises(ValueError, match=None) as theirs:
        jplan.AcquisitionPlan(**fields)
    assert message in str(theirs.value)
    with pytest.raises(ValueError) as ours:
        tconfig.acquisition_plan(**fields)
    assert message in str(ours.value)


@pytest.mark.parametrize("fields,name", [
    ({"camera": {"model_acquisition": True}}, "camera.model_acquisition"),
    ({"stage": {"model_speed": True}}, "stage.model_speed"),
    ({"hardware": {"enabled": True}}, "hardware.enabled"),
    ({"autoexposure": {"enabled": True}}, "autoexposure.enabled"),
    ({"stage_positions": {"plate": {"rows": 1, "columns": 1}}}, "stage_positions"),
    ({"positions_csv": "positions.csv"}, "positions_csv"),
])
def test_acquisition_plan_raises_for_the_host_emulations(fields, name):
    """What the pydantic plan emulates on the host (methods of its
    sub-models) the namespace does not carry: set, it raises naming
    ``engine.plan.AcquisitionPlan``; the pydantic plan takes it."""
    jplan.AcquisitionPlan(**fields)
    with pytest.raises(NotImplementedError, match="engine.plan.AcquisitionPlan") as exc:
        tconfig.acquisition_plan(**fields)
    assert str(exc.value).startswith(name)
    assert name in tconfig.HOST_EMULATIONS


def test_acquisition_plan_rejects_unknown_fields():
    for fields in ({"nope": 1}, {"time": {"nope": 1}}, {"channels": [{"exposure_ms": 1.0}]}):
        with pytest.raises((TypeError, ValueError)):
            tconfig.acquisition_plan(**fields)
        with pytest.raises(ValueError):
            jplan.AcquisitionPlan(**fields)


@pytest.mark.parametrize("meta", [
    {"preprocessing": ["deskew"], "deskew": {"ls_angle_deg": 30.0}},
    {"preprocessing": ["deskew"]},
    {"preprocessing": ["deskew"], "deskew": {"px_to_scan_ratio": 0.386, "pixel_size_um": 0.2}},
    {"preprocessing": ["phase"]},
    {"preprocessing": ["phase"], "phase": {"transfer_function": {"z_padding": 2}}},
    {"preprocessing": ["deskew", "phase"], "deskew": {"ls_angle_deg": 45.0}},
    {},
])
def test_inject_dynatrack_parameters_as_jax_s_injection(meta):
    """The namespace injection gives the blocks JAX's injection gives its
    ``DynaTrackConfig``, and leaves the caller's dicts as pydantic does."""
    base = {"input_channel": "BF", "tracking_channel": "BF", **meta}
    given = json.loads(json.dumps(base))
    theirs = JaxDynaTrackConfig(**base)
    jax_inject(theirs, pixel_size_um=0.116, z_step_um=0.3)
    ours = tconfig.dynatrack_settings(**given)
    tconfig.inject_dynatrack_parameters(ours, pixel_size_um=0.116, z_step_um=0.3)
    assert ours.deskew == theirs.deskew and ours.phase == theirs.phase
    assert given.get("deskew") == base.get("deskew")


@pytest.mark.parametrize("deskew,message", [
    ({"ls_angle_deg": 95.0}, "ls_angle_deg must be in (0, 90)"),
    ({"average_n_slices": 0}, "average_n_slices must be >= 1"),
    ({"px_to_scan_ratio": -1.0}, "px_to_scan_ratio must be > 0"),
    ({"pixel_size_um": -0.1, "scan_step_um": 0.3}, "px_to_scan_ratio must be > 0"),
])
def test_namespace_deskew_checks_are_deskew_settings(deskew, message):
    """The injection checks its deskew dict again, as JAX's
    ``DeskewSettings(**config.deskew)`` does; the same rules hold when the
    namespace is built."""
    with pytest.raises(ValueError, match=None) as theirs:
        JaxDynaTrackConfig(input_channel="BF", tracking_channel="BF", deskew=deskew)
    assert message in str(theirs.value)
    with pytest.raises(ValueError, match=None) as ours:
        tconfig.dynatrack_settings(input_channel="BF", tracking_channel="BF", deskew=deskew)
    assert message in str(ours.value)


# -- the stand-ins of phase 4r ----------------------------------------------------

def _memory_source(plate: Path):
    """``chip_smoke.MemorySource`` rendering the plate's volumes (from the
    port's ``ReplaySource``'s positions) as CPU tensors."""
    from shrimpy_tpu_torch.engine.replay import ReplaySource

    real = ReplaySource(plate)

    def render(p, t, c):
        return torch.from_numpy(np.array(real.positions[p].volume(t, c)))

    return chip_smoke.MemorySource(render, real.shape_tczyx, real.zyx_scale, real.channel_names,
                                   real.position_keys)


def test_stand_ins_write_what_replay_source_and_ngff_write(plate, runs, tmp_path):
    """The engine through phase 4r's in-memory source and store writes the
    volumes (by digest), journal, summary and stage of the run through
    ``ReplaySource`` and ``io/ngff.py``; every update applied, no bad
    record, every written volume the one served at its (t, c, p) and
    offset."""
    real = runs("shrimpy_tpu_torch", "namespace", "loop_matrix")
    source = _memory_source(plate)
    store = chip_smoke.MemoryStore("cpu")
    plan = chip_smoke.engine_plan(DESKEW, MATRICES["loop_matrix"], N_T, CHANNELS)
    out, records, stage, log = chip_smoke.run_engine(source, store, plan, "cpu", tmp_path,
                                                     name="acq")
    assert out == tmp_path / "acq.zarr" and out.is_dir() and not any(out.iterdir())
    assert not log.bad
    assert sorted((t, p) for t, p, _ in records["futures"]) == sorted(
        (t, p) for t in range(N_T) for p in KEYS)
    assert all(f.result(timeout=0) is True for _, _, f in records["futures"])
    assert len(records["drains"]) == N_T and all(ok for _, ok in records["drains"])
    written = {(p, t, c): d for (path, p), pos in store.positions.items()
               for (t, c), d in pos.written.items()}
    want = {(p, t, c): chip_smoke.volume_digest(torch.from_numpy(real["outputs"][p][t, c]))
            for p in KEYS for t in range(N_T) for c in range(len(CHANNELS))}
    assert written == want
    assert {k: v[-1][1] for k, v in source.served.items()} == written
    assert all(len(v) == 1 for v in source.served.values())
    assert _journal(tmp_path / "acq_dynatrack_log.csv") == real["journal"]
    assert _summary(tmp_path / "acq_summary_metadata.json") == real["summary"]
    for key in KEYS:
        np.testing.assert_array_equal(stage.get(key).as_array(), real["stage"][key])
    residuals = chip_smoke.engine_residuals(source, stage, RAW_SCALE, KEYS, N_T, DRIFT)
    assert all(max(abs(v) for v in r) <= 1 for p in KEYS for r in residuals[p][2:]), residuals
    # The package logger is as it was, the run's log file released.
    assert not any(isinstance(h, logging.FileHandler)
                   for h in logging.getLogger("shrimpy_tpu_torch").handlers)


def test_memory_source_is_replay_source_volume(plate):
    """One volume cached, t modulo the depth, the roll by minus the offset,
    read-only at zero offset."""
    from shrimpy_tpu_torch.engine.replay import ReplaySource

    real, mem = ReplaySource(plate), _memory_source(plate)
    for key, t, c, off in ((KEYS[0], 1, 0, (0, 0, 0)), (KEYS[0], 5, 0, (1, -2, 3)),
                           (KEYS[1], 2, 1, (0, 4, 0)), (KEYS[1], 2, 1, (-3, 0, 0))):
        np.testing.assert_array_equal(mem.volume(key, t, c, offset_px_zyx=off),
                                      real.volume(key, t, c, offset_px_zyx=off))
    assert mem.cache_misses == real.cache_misses == 2
    assert not mem.volume(KEYS[0], 0, 0).flags.writeable
    assert mem.volume(KEYS[0], 0, 0, offset_px_zyx=(1, 0, 0)).flags.writeable
    assert (mem.n_timepoints, mem.position_keys, mem.channel_index("GFP"), mem.store.is_plate) \
        == (real.n_timepoints, real.position_keys, real.channel_index("GFP"), True)


def test_volume_digest_tells_volumes_apart():
    vol = torch.from_numpy(np.random.default_rng(0).random((6, 7, 8), dtype=np.float32))
    d = chip_smoke.volume_digest(vol)
    assert d == chip_smoke.volume_digest(vol.clone())
    others = [torch.roll(vol, 1, dims=a) for a in range(3)] + [vol * 0.5, vol.transpose(1, 2)]
    assert all(chip_smoke.volume_digest(o.contiguous()) != d for o in others)
    with pytest.raises(ValueError, match="float32"):
        chip_smoke.volume_digest(vol.double())


# -- the differences of engine/engine.py, each on its own ------------------------

def test_difference_setup_tracking_builds_the_namespace_config(plate, tmp_path):
    """``_setup_tracking`` builds ``config.dynatrack_settings`` with the
    namespace injection, never the pydantic ``DynaTrackConfig``: the
    tracker's settings are JAX's after its injection, the scale the
    preprocessed stack's, and an unset matrix gives JAX's warning."""
    fields = _plan_fields("loop_matrix")
    engines = {}
    for package in PACKAGES:
        pkg = Pkg(package)
        engine = pkg.engine(pkg.source(plate))
        engine._setup_tracking(pkg.plan(**fields), list(CHANNELS), tmp_path / package, "acq")
        engine._tracking.shutdown()
        engines[package] = engine
    ours, theirs = engines["shrimpy_tpu_torch"]._tracker, engines["shrimpy_tpu"]._tracker
    assert isinstance(ours.config, SimpleNamespace)
    dump = theirs.config.model_dump()
    for name, value in dump.items():
        mine = getattr(ours.config, name)
        assert (vars(mine) if isinstance(mine, SimpleNamespace) else mine) == value, name
    np.testing.assert_allclose(ours.scale_zyx_um, theirs.scale_zyx_um, rtol=1e-12)
    assert engines["shrimpy_tpu_torch"]._track_channel_idx == 0
    meta = fields["metadata"]["dynatrack"]
    messages = {}
    for package in PACKAGES:
        pkg = Pkg(package)
        engine = pkg.engine(pkg.source(plate))
        # On the module's logger: an acquisition's configure_logging stops
        # the package's records from reaching the root.
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        engine_logger = logging.getLogger(f"{package}.engine.engine")
        engine_logger.addHandler(handler)
        try:
            engine._setup_tracking(pkg.plan(**{**fields, "metadata": {"dynatrack": {
                k: v for k, v in meta.items() if k != "image_to_stage_matrix_xyz"}}}),
                list(CHANNELS), tmp_path / f"{package}_i", "acq")
        finally:
            engine_logger.removeHandler(handler)
        engine._tracking.shutdown()
        messages[package] = [r.getMessage() for r in records if "identity" in r.getMessage()]
    assert messages["shrimpy_tpu_torch"] == messages["shrimpy_tpu"] and messages["shrimpy_tpu"]
    with pytest.raises(ValueError, match="Unknown tracking_method"):
        tconfig.dynatrack_settings(**{**meta, "tracking_method": "nope"})


def test_difference_device_reaches_the_preprocessor_tracker_and_refocus(plate, tmp_path,
                                                                        monkeypatch):
    """``AcquisitionEngine(device=...)`` hands ``device`` to the
    ``Preprocessor``, the ``Tracker`` and the refocus metric. Left None it
    is the card: on this CPU-only host each tracking update fails with the
    CUDA error (the manager logs it and keeps the position), none runs on
    the CPU in its place."""
    from shrimpy_tpu_torch.engine import autofocus as taf
    from shrimpy_tpu_torch.engine import engine as teng
    from shrimpy_tpu_torch.tracking import preprocess

    seen = []

    class Recording(preprocess.Preprocessor):
        def __init__(self, config, **kw):
            seen.append(("preprocessor", kw.get("device")))
            super().__init__(config, **kw)

    focus = taf.focus_from_transverse_band

    def recording_focus(vol, **kw):
        seen.append(("refocus", kw.get("device")))
        return focus(vol, **kw)

    monkeypatch.setattr(preprocess, "Preprocessor", Recording)
    monkeypatch.setattr(taf, "focus_from_transverse_band", recording_focus)
    fields = {**_plan_fields("loop_matrix"), "time": {"n_timepoints": 1},
              "refocus": {"enabled": True}}
    engine = teng.AcquisitionEngine(Pkg("shrimpy_tpu_torch").source(plate), device="cpu")
    engine.acquire(tmp_path / "cpu", "acq", tconfig.acquisition_plan(**fields))
    assert engine.device == "cpu" and engine._tracker.device == "cpu"
    assert seen == [("preprocessor", "cpu")] + [("refocus", "cpu")] * len(KEYS)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    position_logger = logging.getLogger("shrimpy_tpu_torch.tracking.position")
    position_logger.addHandler(handler)
    try:
        engine = teng.AcquisitionEngine(Pkg("shrimpy_tpu_torch").source(plate))
        engine.acquire(tmp_path / "card", "acq", tconfig.acquisition_plan(**{
            **_plan_fields("loop_matrix"), "time": {"n_timepoints": 1}}))
    finally:
        position_logger.removeHandler(handler)
    assert engine.device is None and engine._tracker.device is None
    failed = [r for r in records if "updater failed" in r.getMessage()]
    assert len(failed) == len(KEYS)
    assert all("torch.cuda.is_available() is False" in str(r.exc_info[1]) for r in failed)
    assert all(engine._tracking.store.get(k).as_array().tolist() == [0.0, 0.0, 0.0]
               for k in KEYS)


def test_difference_deferred_imports_the_store_at_the_run(plate, tmp_path):
    """The engine takes ``shrimpy_tpu_torch.io.ngff`` as ``sys.modules``
    holds it when ``acquire`` runs, not when the module loaded: a stand-in
    put there is what the run writes through, and the plan and replay
    modules are never needed by a namespace plan."""
    from shrimpy_tpu_torch.engine import engine as teng

    assert not {"ngff", "AcquisitionPlan", "ReplaySource", "DynaTrackConfig"} & set(vars(teng))
    store = chip_smoke.MemoryStore("cpu")
    plan = tconfig.acquisition_plan(time={"n_timepoints": 1})
    with chip_smoke.memory_ngff(store):
        out = teng.AcquisitionEngine(_memory_source(plate), device="cpu").acquire(
            tmp_path, "acq", plan)
    assert out.is_dir() and not any(out.iterdir())
    assert sorted(p for _, p in store.positions) == list(KEYS)
    assert all(len(pos.written) == len(CHANNELS) for pos in store.positions.values())


# -- the replay verbs against the JAX CLI -------------------------------------------

def _invoke(group, args, tmp_path, name):
    """The verb's exit code, standard output and error message (the log,
    the rest of standard error, aside), the run's directory written as
    ``{dir}``."""
    argv = [a.replace("{dir}", str(tmp_path / name)) for a in args]
    result = CliRunner().invoke(group, argv)
    errors = [line for line in result.stderr.splitlines() if line.startswith("Error:")]
    text = "\n".join([result.stdout.strip(), *errors])
    return result.exit_code, text.replace(str(tmp_path / name), "{dir}").strip()


def _both(args, tmp_path):
    for name in ("jax", "torch"):
        (tmp_path / name).mkdir(exist_ok=True)
    return (_invoke(jax_cli, args, tmp_path, "jax"),
            _invoke(cli, args + ["--device", "cpu"], tmp_path, "torch"))


def _same_outputs(tmp_path, stores, sidecars):
    for store in stores:
        a, b = _outputs(tmp_path / "jax" / store), _outputs(tmp_path / "torch" / store)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for sidecar in sidecars:
        a, b = (tmp_path / name / sidecar for name in ("jax", "torch"))
        if sidecar.endswith(".csv"):
            assert _journal(a) == _journal(b)
        elif sidecar.endswith("_dualarm_summary.json"):
            ja, jb = json.loads(a.read_text()), json.loads(b.read_text())
            for d in (ja, jb):
                for arm in d["arms"].values():
                    arm["output"] = Path(arm["output"]).name if arm["output"] else None
            assert ja == jb
        else:
            assert _summary(a) == _summary(b)


def test_replay_verb_as_the_jax_cli(tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    synthetic_blob_fov(tmp_path / "src.zarr", shape_zyx=(8, 32, 32), n_timepoints=4,
                       drift_zyx=(0.0, 1.5, -2.0), zyx_scale=(1.0, 1.0, 1.0))
    args = ["replay", str(tmp_path / "src.zarr"), "-o", "{dir}/out", "-n", "demo", "--plan",
            str(REPO / "configs/plan_demo.yml")]
    (j_code, j_text), (t_code, t_text) = _both(args, tmp_path)
    assert t_code == j_code == 0, (t_text, j_text)
    assert t_text == j_text and t_text.endswith("{dir}/out/demo.zarr")
    _same_outputs(tmp_path, ["out/demo.zarr"],
                  ["out/demo_summary_metadata.json", "out/demo_dynatrack_log.csv"])
    # The default plan replays the whole source.
    (j_code, j_text), (t_code, t_text) = _both(args[:4], tmp_path)
    assert t_code == j_code == 0 and t_text == j_text
    _same_outputs(tmp_path, ["out/replay.zarr"], ["out/replay_summary_metadata.json"])


def test_replay_viewer_waits_for_item_12d(tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    synthetic_blob_fov(tmp_path / "src.zarr", shape_zyx=(4, 16, 16), n_timepoints=1)
    result = CliRunner().invoke(cli, ["replay", str(tmp_path / "src.zarr"), "-o",
                                      str(tmp_path / "out"), "--viewer", "--device", "cpu"])
    assert result.exit_code != 0
    assert "ROADMAP queue 1 item 12d" in result.output
    assert not (tmp_path / "out").exists()


def test_replay_dual_verb_as_the_jax_cli(tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    for arm, drift in (("a", (0.0, 0.0, 0.0)), ("b", (0.0, 0.0, -3.0))):
        synthetic_blob_fov(tmp_path / f"{arm}.zarr", shape_zyx=(8, 48, 48), n_timepoints=3,
                           drift_zyx=drift, noise=0.5, zyx_scale=(1.0, 1.0, 1.0))
    config = {"arms": {
        "labelfree": {"input": str(tmp_path / "a.zarr"), "plan": {"time": {"n_timepoints": 3}}},
        "lightsheet": {"input": str(tmp_path / "b.zarr"), "plan": {
            "time": {"n_timepoints": 3},
            "camera": {"model_acquisition": True, "readout_ms": 5.0, "time_scale": 0.0},
            "metadata": {"dynatrack": {"input_channel": "BF", "tracking_channel": "BF",
                                       "tracking_method": "pcc",
                                       "image_to_stage_matrix_xyz": MATRICES["minus_identity"]}}}},
    }, "barrier_timeout_s": 60.0}
    (tmp_path / "dual.yml").write_text(json.dumps(config))
    args = ["replay-dual", str(tmp_path / "dual.yml"), "-o", "{dir}/out", "-n", "dual"]
    (j_code, j_text), (t_code, t_text) = _both(args, tmp_path)
    assert t_code == j_code == 0, (t_text, j_text)
    # The run control line, then the arms' results (in the order the arms
    # finished, in either CLI).
    (j_control, j_json), (t_control, t_json) = (x.splitlines() for x in (j_text, t_text))
    assert t_control == j_control and json.loads(t_json) == json.loads(j_json)
    _same_outputs(tmp_path, ["out/dual_labelfree.zarr", "out/dual_lightsheet.zarr"],
                  ["out/dual_labelfree_summary_metadata.json",
                   "out/dual_lightsheet_summary_metadata.json",
                   "out/dual_lightsheet_dynatrack_log.csv", "out/dual_dualarm_summary.json"])
    summary = json.loads((tmp_path / "torch/out/dual_lightsheet_summary_metadata.json").read_text())
    assert summary["plan"]["camera"]["mode"] == "lightsheet"  # the arm's camera mode
    bad = dict(config, arms={"x": config["arms"]["labelfree"], "y": config["arms"]["labelfree"]})
    (tmp_path / "bad.yml").write_text(json.dumps(bad))
    (j_code, j_text), (t_code, t_text) = _both(["replay-dual", str(tmp_path / "bad.yml"), "-o",
                                                "{dir}/bad"], tmp_path)
    assert t_code == j_code != 0 and t_text == j_text and "do not match microscope" in t_text
