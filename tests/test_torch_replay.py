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
  the JAX CLI's stores, sidecars and messages; ``replay --viewer`` writes the
  JAX CLI's ring descriptor (but the ring's name) and volume index, and
  ``monitor`` (a store, a growing store, a progress journal, ``--live`` on a
  ring) prints its status lines (ROADMAP item 12d). ``monitor`` (but its
  matplotlib guard), ``_start_web`` and ``_monitor_live`` are the JAX CLI's, and ``replay`` is
  too but for ``device``, pinned by AST.
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


# -- the viewer's verbs against the JAX CLI ----------------------------------------------

VIEWER_FUNCTIONS = ("monitor", "_start_web", "_monitor_live")


def _cli_functions(path: Path) -> dict:
    """The CLI module's functions (decorators included, docstrings out), by
    name, the package name normalised."""
    tree = ast.parse(path.read_text().replace("shrimpy_tpu_torch", "shrimpy_tpu"))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return funcs


def _without_device(func: ast.FunctionDef) -> str:
    """A port verb less its ``device``: the ``--device`` option, the
    parameter, ``dev = _device_or_exit(device)`` and the keyword passed on."""
    from tests.test_torch_config import _WithoutDevice

    func.decorator_list = [d for d in func.decorator_list
                           if not (isinstance(d, ast.Call) and d.args
                                   and getattr(d.args[0], "value", None) == "--device")]
    func.body = [n for n in func.body
                 if not (isinstance(n, ast.Assign) and ast.unparse(n) == "dev = _device_or_exit(device)")]
    return ast.dump(_WithoutDevice().visit(func))


def _pyplot_guarded(jax_monitor: ast.FunctionDef) -> str:
    """JAX's ``monitor`` with its one named difference in the port: pyplot
    from ``_pyplot()`` (None where matplotlib is missing) in the place of
    the unconditional import, and no PNG drawn where it is None."""
    src = ast.unparse(jax_monitor)
    guarded = src.replace("import matplotlib\n    matplotlib.use('Agg')\n    import "
                          "matplotlib.pyplot as plt", "plt = _pyplot()").replace(
        "if t_latest is not None:", "if t_latest is not None and plt is not None:")
    assert guarded.count("_pyplot()") == 1 and "plt is not None" in guarded
    return guarded


def test_monitor_helpers_and_replay_are_jax_s_but_for_device():
    """``_start_web`` and ``_monitor_live`` are the JAX CLI's statement for
    statement, and ``monitor`` too but that it draws its PNGs only where
    matplotlib imports (``_pyplot``, the store-mode repair); ``replay`` (its
    viewer block with the feeder stopped in a ``finally``) is too once
    ``device`` is taken out, and ``device`` is its one difference."""
    ours = _cli_functions(REPO / "shrimpy_tpu_torch/cli/main.py")
    theirs = _cli_functions(REPO / "shrimpy_tpu/cli/main.py")
    for name in VIEWER_FUNCTIONS:
        if name == "monitor":
            assert ast.unparse(ours[name]) == _pyplot_guarded(theirs[name])
        else:
            assert ast.dump(ours[name]) == ast.dump(theirs[name]), name
    assert ast.dump(ours["replay"]) != ast.dump(theirs["replay"])
    assert "device=dev, viewer_hooks=hooks" in ast.unparse(ours["replay"])
    assert _without_device(ours["replay"]) == _without_device(theirs["replay"])


def test_cli_has_the_jax_cli_s_verbs():
    jax_verbs = {n: sorted(c.commands) if hasattr(c, "commands") else None
                 for n, c in jax_cli.commands.items()}
    verbs = {n: sorted(c.commands) if hasattr(c, "commands") else None
             for n, c in cli.commands.items()}
    assert verbs == jax_verbs and "monitor" in verbs
    assert sum(len(v or [None]) for v in verbs.values()) == 16
    result = CliRunner().invoke(cli, ["--help"])
    assert result.exit_code == 0
    listed = result.stdout.split("Commands:")[1].split()
    assert set(jax_verbs) <= set(listed)


def _both_status(args, tmp_path):
    """Both CLIs' ``monitor`` on the same input: exit codes and the status
    JSON of each one's last line."""
    out = []
    for group in (jax_cli, cli):
        result = CliRunner().invoke(group, args)
        assert result.exit_code == 0, result.output
        out.append(json.loads(result.stdout.strip().splitlines()[-1]))
    return out


def test_monitor_once_as_the_jax_cli(tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    synthetic_blob_fov(tmp_path / "tl.zarr", n_timepoints=2, shape_zyx=(4, 16, 16))
    png = tmp_path / "tl.zarr" / "_preview" / "0.png"
    jax_status, status = _both_status(["monitor", str(tmp_path / "tl.zarr"), "--once"], tmp_path)
    assert status == jax_status and status["0"]["timepoints_written"] == 2
    assert status["0"]["latest"] == 1 and png.exists()


def test_monitor_partial_store_uses_chunk_metadata_as_the_jax_cli(tmp_path):
    from shrimpy_tpu_torch.io.ngff import create_fov

    pos = create_fov(tmp_path / "grow.zarr", shape=(5, 1, 4, 16, 16), dtype="float32",
                     channel_names=["c"], zyx_scale=(1.0, 1.0, 1.0))
    pos.write((0, 0), np.ones((4, 16, 16), np.float32))
    pos.write((2, 0), np.ones((4, 16, 16), np.float32))
    jax_status, status = _both_status(["monitor", str(tmp_path / "grow.zarr"), "--once"],
                                      tmp_path)
    assert status == jax_status == {"0": {"timepoints_written": 2, "latest": 2, "of": 5}}


def test_progress_journal_reader_is_jax_s(tmp_path):
    """``_Progress.iter_done_keys`` (what ``monitor`` reads) is JAX's method
    statement for statement and yields its keys on a journal with failed,
    torn and foreign lines."""
    from shrimpy_tpu.runtime.stream import _Progress as JaxProgress
    from shrimpy_tpu_torch.runtime.stream import _Progress

    def method(path):
        tree = ast.parse(path.read_text())
        cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "_Progress")
        fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef)
                  and n.name == "iter_done_keys")
        fn.body = fn.body[1:]  # the docstring
        return ast.dump(fn)

    assert method(REPO / "shrimpy_tpu_torch/runtime/stream.py") == method(
        REPO / "shrimpy_tpu/runtime/stream.py")
    journal = tmp_path / "j.jsonl"
    journal.write_text("\n".join([json.dumps({"key": "0/0/000|0|1"}), "[1, 2]", '{"key": "0|1',
                                  json.dumps({"key": "0|2|0", "failed": "write"}),
                                  json.dumps({"key": "a|b|c"}), json.dumps({"k": 1}),
                                  json.dumps({"key": "B/3/7|5|0"})]) + "\n")
    assert list(_Progress.iter_done_keys(journal)) == list(JaxProgress.iter_done_keys(journal)) \
        == [("0/0/000", 0, 1), ("B/3/7", 5, 0)]
    assert list(_Progress.iter_done_keys(tmp_path / "none.jsonl")) == []


def test_monitor_consumes_progress_journal_as_the_jax_cli(tmp_path):
    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    synthetic_blob_fov(tmp_path / "out.zarr", n_timepoints=3, shape_zyx=(4, 16, 16))
    (tmp_path / "out.zarr.progress.jsonl").write_text(
        json.dumps({"key": "0|0|0"}) + "\n" + json.dumps({"key": "0|1|0"}) + "\n")
    jax_status, status = _both_status(["monitor", str(tmp_path / "out.zarr"), "--once"],
                                      tmp_path)
    assert status == jax_status
    assert status["0"]["timepoints_written"] == 2 and status["0"]["latest"] == 1


def test_monitor_live_attach_as_the_jax_cli(tmp_path):
    """``monitor --live`` of each CLI on one ring (the JAX package's): the
    same status line, ``state.json`` and PNG names."""
    from shrimpy_tpu.viewer.ring import FrameRing

    preview = tmp_path / "preview"
    preview.mkdir()
    ring = FrameRing(None, n_slots=8, frame_shape=(8, 16))
    try:
        (preview / "ring.json").write_text(json.dumps({
            "ring": ring.name, "n_slots": 8, "frame_shape": [8, 16], "dtype": "float32"}))
        lines = []
        for t in range(2):
            slots = [ring.write(t * 4 + z, np.full((8, 16), t + z, np.float32)) for z in range(4)]
            lines.append(json.dumps({"type": "volume", "t": t, "p": "0", "channel": "BF",
                                     "slots": slots, "seq0": t * 4, "shape": [4, 8, 16]}))
        (preview / "volumes.jsonl").write_text("\n".join(lines) + "\n")
        states = []
        for name, group in (("jax", jax_cli), ("torch", cli)):
            result = CliRunner().invoke(group, [
                "monitor", str(tmp_path), "--live", "--once", "--preview-dir",
                str(tmp_path / name), "--ls-angle-deg", "30", "--px-to-scan-ratio", "0.5"])
            assert result.exit_code == 0, result.output
            status = json.loads(result.stdout.splitlines()[-1])
            assert status == {"drawn": 1, "displayed": {"0|BF": 1}, "follow": True, "evicted": 0}
            assert (tmp_path / name / "live_p0_BF.png").exists()
            states.append(json.loads((tmp_path / name / "state.json").read_text()))
        assert states[0] == states[1] and states[1]["deskew"]["ls_angle_deg"] == 30.0
        # The port's monitor needs both angle and ratio, as JAX's.
        result = CliRunner().invoke(cli, ["monitor", str(tmp_path), "--live", "--once",
                                          "--ls-angle-deg", "30"])
        assert result.exit_code != 0 and "--px-to-scan-ratio" in result.output
    finally:
        ring.close()


def test_replay_with_viewer_as_the_jax_cli(tmp_path):
    """``replay --viewer`` of each CLI on one store: the same output, the
    same store, a ``ring.json`` equal but for the ring's name (the floor of
    one volume: 4 MB holds 1024 of these frames) and the same
    ``volumes.jsonl`` rows; the feeder's ring is gone after the run."""
    from multiprocessing import shared_memory

    from shrimpy_tpu_torch.io.synthetic import synthetic_blob_fov

    synthetic_blob_fov(tmp_path / "src.zarr", n_timepoints=2, shape_zyx=(4, 32, 32))
    args = ["replay", str(tmp_path / "src.zarr"), "-o", "{dir}/out", "-n", "v", "--viewer",
            "--viewer-cache-mb", "4"]
    (j_code, j_text), (t_code, t_text) = _both(args, tmp_path)
    assert t_code == j_code == 0, (t_text, j_text)
    assert t_text == j_text and t_text.endswith("{dir}/out/v.zarr")
    _same_outputs(tmp_path, ["out/v.zarr"], ["out/v_summary_metadata.json"])
    descs, rows = [], []
    for name in ("jax", "torch"):
        preview = tmp_path / name / "out" / "preview"
        descs.append(json.loads((preview / "ring.json").read_text()))
        rows.append([json.loads(line) for line in
                     (preview / "volumes.jsonl").read_text().splitlines()])
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=descs[-1]["ring"])
    assert descs[0].pop("ring") != descs[1].pop("ring")
    assert descs[0] == descs[1] == {"n_slots": 1024, "frame_shape": [32, 32], "dtype": "float32"}
    assert rows[0] == rows[1] and [(r["t"], r["seq0"]) for r in rows[1]] == [(0, 0), (1, 4)]


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
