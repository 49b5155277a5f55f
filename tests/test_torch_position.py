"""PyTorch port of DynaTrack's position loop against the JAX package (CPU).

``shrimpy_tpu_torch/tracking/position.py`` (a copy, pinned statement for
statement in ``tests/test_torch_config.py``), the demo PFS of
``engine/autofocus.py`` and the tracker's debug artifacts
(``tracking/debug.py``): the JAX tests of these (``test_position_update.py``,
the ``DemoAutofocus`` tests of ``test_autofocus.py``,
``test_tracking.py::test_debug_artifacts``), each run on both packages. Then
the closed loop: each package's ``PositionUpdateManager`` over its own
``Preprocessor([deskew])`` and ``Tracker("pcc")`` on four seeded raws whose
sample drifts, the stage seam of ``chip_smoke.py`` rolling each raw by the
stored offset. The stored positions agree within 1e-6 um (the shifts are
whole pixels, so the sums are the same numbers), and the loop re-centres
the sample; with -I as the image-to-stage matrix it does not, because the
deskewed y drift is a scan drift of the raw.
"""

import ast
import importlib
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from shrimpy_tpu.config.schemas import DynaTrackConfig as JaxDynaTrackConfig
from shrimpy_tpu.engine import autofocus as jaf
from shrimpy_tpu.engine.plan import AutofocusPlan as JaxAutofocusPlan
from shrimpy_tpu.tracking import position as jpos
from shrimpy_tpu.tracking import Tracker as JaxTracker
from shrimpy_tpu.tracking.preprocess import Preprocessor as JaxPreprocessor
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.engine import autofocus as taf
from shrimpy_tpu_torch.engine.plan import AutofocusPlan
from shrimpy_tpu_torch.tracking import Tracker
from shrimpy_tpu_torch.tracking import position as tpos
from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ["shrimpy_tpu", "shrimpy_tpu_torch"]
POSITION = {"shrimpy_tpu": jpos, "shrimpy_tpu_torch": tpos}
POSITION_ATOL_UM = 1e-6
LOOP_RAW = (120, 64, 160)
LOOP_DRIFT = (2, 0, 3)  # raw px (scan, tilt, x) a timepoint
LOOP_TIMEPOINTS = 4


@pytest.fixture(params=PACKAGES)
def pos(request):
    return POSITION[request.param]


# -- test_position_update.py on both packages ---------------------------------

def test_store_set_get_update(pos):
    store = pos.PositionStore()
    store.set("A", 1.0, 2.0, 3.0)
    assert store.get("A").as_array().tolist() == [1.0, 2.0, 3.0]
    store.update("A", 0.5, -1.0, 0.0)
    assert store.get("A").as_array().tolist() == [1.5, 1.0, 3.0]
    assert store.get("missing") is None


def test_store_thread_safety_hammer(pos):
    store = pos.PositionStore()
    store.set("P", 0.0, 0.0, 0.0)
    n, threads = 200, 8

    def worker():
        for _ in range(n):
            store.update("P", 1.0, 1.0, 1.0)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert store.get("P").as_array().tolist() == [n * threads] * 3


def test_baseline_correction_applied(pos):
    store = pos.PositionStore()
    store.set("P", 100.0, 200.0, 50.0)
    mgr = pos.PositionUpdateManager(store, lambda stack, t, p: np.array([1.0, -2.0, 0.5]))
    mgr.record_acquisition(0, "P")
    # The pre-fetch race: the store moves after acquisition.
    store.set("P", 999.0, 999.0, 999.0)
    fut = mgr.on_stack_complete(np.zeros((2, 2, 2)), 0, "P")
    assert fut.result(timeout=10)
    # The correction is relative to the frozen baseline, not the moved store.
    np.testing.assert_allclose(store.get("P").as_array(), [99.0, 202.0, 49.5])
    mgr.shutdown()


def test_no_baseline_skips_correction(pos):
    store = pos.PositionStore()
    store.set("P", 10.0, 10.0, 10.0)
    mgr = pos.PositionUpdateManager(store, lambda s, t, p: np.array([5.0, 5.0, 5.0]))
    fut = mgr.on_stack_complete(np.zeros((2, 2, 2)), 3, "P")  # no baseline
    assert fut.result(timeout=10) is False
    np.testing.assert_allclose(store.get("P").as_array(), [10.0, 10.0, 10.0])
    mgr.shutdown()


def test_updater_failure_keeps_position(pos):
    store = pos.PositionStore()
    store.set("P", 7.0, 7.0, 7.0)

    def bad_updater(stack, t, p):
        raise RuntimeError("compute failed")

    mgr = pos.PositionUpdateManager(store, bad_updater)
    mgr.record_acquisition(0, "P")
    fut = mgr.on_stack_complete(np.zeros((2, 2, 2)), 0, "P")
    assert fut.result(timeout=10) is False
    np.testing.assert_allclose(store.get("P").as_array(), [7.0, 7.0, 7.0])
    mgr.shutdown()


def test_drain_pending_blocks_until_done(pos):
    store = pos.PositionStore()
    store.set("P", 0.0, 0.0, 0.0)
    started = threading.Event()

    def slow_updater(stack, t, p):
        started.set()
        time.sleep(0.3)
        return np.array([1.0, 0.0, 0.0])

    mgr = pos.PositionUpdateManager(store, slow_updater)
    mgr.record_acquisition(0, "P")
    mgr.on_stack_complete(np.zeros((2, 2, 2)), 0, "P")
    started.wait(timeout=5)
    t0 = time.monotonic()
    assert mgr.drain_pending()
    assert time.monotonic() - t0 >= 0.1  # actually waited
    np.testing.assert_allclose(store.get("P").as_array(), [-1.0, 0.0, 0.0])
    mgr.shutdown()


def test_updates_serialized_single_worker(pos):
    """At most one computation in flight (the reference's single worker)."""
    store = pos.PositionStore()
    active, overlap = [], []

    def updater(stack, t, p):
        active.append(1)
        if len(active) > 1:
            overlap.append(True)
        time.sleep(0.05)
        active.pop()
        return np.zeros(3)

    mgr = pos.PositionUpdateManager(store, updater)
    for t in range(4):
        store.set("P", 0, 0, 0)
        mgr.record_acquisition(t, "P")
        mgr.on_stack_complete(np.zeros((2, 2, 2)), t, "P")
    mgr.drain_pending()
    assert not overlap
    mgr.shutdown()


# -- DemoAutofocus (test_autofocus.py) on both packages and the namespace -----

# (DemoAutofocus, plan factory): JAX's class on its model; the port's on its
# own model, on JAX's and on the namespace the card's host builds.
DEMO_AF = {
    "jax": (jaf.DemoAutofocus, JaxAutofocusPlan),
    "port": (taf.DemoAutofocus, AutofocusPlan),
    "port_on_jax_plan": (taf.DemoAutofocus, JaxAutofocusPlan),
    "port_on_namespace": (taf.DemoAutofocus, tconfig.autofocus_plan),
}


@pytest.fixture(params=list(DEMO_AF))
def demo_af(request):
    return DEMO_AF[request.param]


def test_demo_autofocus_deterministic_failures(demo_af):
    cls, plan = demo_af
    af = cls(plan(enabled=True, fail_at_indices=[2, 5], success_rate=1.0), n_positions=3)
    results = [af.engage(t, p) for t in range(2) for p in range(3)]
    # Flat indices 2 and 5 fail: (t=0, p=2) and (t=1, p=2).
    assert results == [True, True, False, True, True, False]


def test_demo_autofocus_disabled_always_locks(demo_af):
    cls, plan = demo_af
    af = cls(plan(enabled=False), 2)
    assert all(af.engage(t, p) for t in range(3) for p in range(2))
    # Failure settings with the feature off would be silently inert: the
    # plan rejects the contradiction.
    with pytest.raises(ValueError, match="enabled"):
        plan(enabled=False, success_rate=0.0)
    with pytest.raises(ValueError, match="enabled"):
        plan(fail_at_indices=[1])


def test_demo_autofocus_seeded_rate(demo_af):
    cls, plan = demo_af
    af_a = cls(plan(enabled=True, success_rate=0.5, seed=123), 1)
    af_b = cls(plan(enabled=True, success_rate=0.5, seed=123), 1)
    a = [af_a.engage(t, 0) for t in range(20)]
    b = [af_b.engage(t, 0) for t in range(20)]
    assert a == b  # seeded -> reproducible
    assert any(a) and not all(a)
    ref = jaf.DemoAutofocus(JaxAutofocusPlan(enabled=True, success_rate=0.5, seed=123), 1)
    assert a == [ref.engage(t, 0) for t in range(20)]


def _class_code(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name]
    return ast.dump(node)


def test_demo_autofocus_is_the_jax_class_statement_for_statement():
    ours = REPO / "shrimpy_tpu_torch/engine/autofocus.py"
    assert _class_code(ours, "DemoAutofocus") == _class_code(
        REPO / "shrimpy_tpu/engine/autofocus.py", "DemoAutofocus")
    # The port's module reads the plan by attribute: no import of plan.py.
    assert "engine.plan import" not in "".join(
        line for line in ours.read_text().splitlines(keepends=True)
        if not line.startswith("    "))


@pytest.mark.parametrize("kw,match", [
    ({"success_rate": 1.5, "enabled": True}, "success_rate must be in"),
    ({"success_rate": -0.1, "enabled": True}, "success_rate must be in"),
    ({"success_rate": 0.5}, "require enabled"),
    ({"fail_at_indices": []}, "require enabled"),
    ({"seed": 3, "enabled": True}, None),
    ({}, None),
])
def test_autofocus_plan_namespace_keeps_the_model_s_defaults_and_rules(kw, match):
    assert tconfig.AUTOFOCUS_DEFAULTS == JaxAutofocusPlan().model_dump()
    if match is None:
        assert vars(tconfig.autofocus_plan(**kw)) == JaxAutofocusPlan(**kw).model_dump()
        return
    with pytest.raises(ValueError, match=match):
        JaxAutofocusPlan(**kw)
    with pytest.raises(ValueError, match=match):
        tconfig.autofocus_plan(**kw)
    with pytest.raises(TypeError, match="unknown"):
        tconfig.autofocus_plan(rate=1.0)


# -- test_tracking.py::test_debug_artifacts on both packages ------------------

def _blob_stack(center, shape=(16, 32, 32), sigma=2.5):
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    r2 = ((zz - center[0]) ** 2 + (yy - center[1]) ** 2 + (xx - center[2]) ** 2) / sigma**2
    return (1000.0 * np.exp(-0.5 * r2)).astype(np.float32)


@pytest.mark.parametrize("package", PACKAGES)
def test_debug_artifacts(package, tmp_path):
    ngff = importlib.import_module(f"{package}.io.ngff")
    debug = importlib.import_module(f"{package}.tracking.debug")
    base = {"input_channel": "BF", "tracking_channel": "BF", "tracking_method": "pcc",
            "debug": True}
    if package == "shrimpy_tpu":
        tracker = JaxTracker(JaxDynaTrackConfig(**base),
                             debug_writer=debug.DebugWriter(tmp_path / "dbg"))
    else:
        tracker = Tracker(tconfig.dynatrack_settings(**base), device="cpu",
                          debug_writer=debug.DebugWriter(tmp_path / "dbg"))
    first, second = _blob_stack((8.0, 16.0, 16.0)), _blob_stack((10.0, 13.0, 20.0))
    tracker.update(first, t=0)
    r = tracker.update(torch.from_numpy(second) if package != "shrimpy_tpu" else second, t=1)
    np.testing.assert_array_equal(r.shift_px_zyx, [2.0, -3.0, 4.0])
    store = ngff.open_ngff(tmp_path / "dbg" / "dynatrack_debug.zarr")
    data = store.position()
    np.testing.assert_array_equal(data.volume(0, 0), first)
    np.testing.assert_array_equal(data.volume(1, 0), second)
    assert data.volume(0, 0).max() > 0
    pngs = sorted((tmp_path / "dbg").glob("debug_t*.png"))
    assert [p.name for p in pngs] == ["debug_t0000_p0.png", "debug_t0001_p0.png"]


def test_debug_writer_off_unless_config_debug(tmp_path):
    calls = []

    class Recorder:
        def record(self, *a, **kw):
            calls.append((a, kw))

    for debug in (False, True):
        tracker = Tracker(tconfig.dynatrack_settings(input_channel="BF", tracking_channel="BF",
                                                     debug=debug),
                          device="cpu", debug_writer=Recorder())
        tracker.update(_blob_stack((8.0, 16.0, 16.0)), t=0)
    ((args, kw),) = calls
    assert isinstance(args[0], np.ndarray) and args[1:] == (0, "0")
    np.testing.assert_array_equal(kw["shift_px_zyx"], np.zeros(3))


# -- the closed loop through the stage seam -----------------------------------

DESKEW = {"ls_angle_deg": 30.0, "px_to_scan_ratio": 0.386}


def _loop_raw0(seed: int = 17) -> np.ndarray:
    """Six seeded blobs on a camera offset, rendered at the raw voxels from
    their deskewed coordinates (``chip_smoke.track_raw``'s geometry)."""
    from shrimpy_tpu_torch.ops.deskew import _geometry

    g = _geometry(LOOP_RAW, tconfig.deskew_settings(**DESKEW))
    ns, nt, nx = LOOP_RAW
    s = np.arange(ns, dtype=np.float64)[:, None, None]
    t = np.arange(nt, dtype=np.float64)[None, :, None]
    x = np.arange(nx, dtype=np.float64)[None, None, :]
    zd, yd = t * g["sin_t"], s / g["r"] + t * g["cos_t"] - g["y_offset"]
    rng = np.random.default_rng(seed)
    raw = np.full(LOOP_RAW, 100.0)
    sigma = (2.0, 4.0, 4.0)
    for i in range(6):
        c = [m + rng.random() * (n - 2 * m)
             for n, m in zip((g["nz_full"], g["ny"], nx), (6.0, 30.0, 20.0))]
        amp = 4000.0 if i == 0 else 500.0 + 1000.0 * rng.random()
        arg = ((zd - c[0]) / sigma[0]) ** 2 + ((yd - c[1]) / sigma[1]) ** 2 + (
            (x - c[2]) / sigma[2]) ** 2
        raw += amp * np.exp(-0.5 * arg)
    return raw.astype(np.float32)


def _sample(raw0):
    def sample(t, offset):
        shift = tuple(t * d - o for d, o in zip(LOOP_DRIFT, offset))
        noise = np.random.default_rng((5, t)).normal(0.0, 10.0, LOOP_RAW).astype(np.float32)
        return np.roll(raw0, shift, axis=(0, 1, 2)) + noise
    return sample


def _loop(package: str, matrix, raw0) -> list:
    """One package's manager, preprocessor and tracker through the seam."""
    deskew = tconfig.deskew_settings(**DESKEW)
    raw_scale = chip_smoke.loop_raw_scale(deskew)
    base = {"input_channel": "LS", "tracking_channel": "LS", "tracking_method": "pcc",
            "preprocessing": ["deskew"], "deskew": DESKEW, "image_to_stage_matrix_xyz": matrix}
    if package == "shrimpy_tpu":
        cfg = JaxDynaTrackConfig(**base)
        pre = JaxPreprocessor(cfg)
        tracker = JaxTracker(cfg, scale_zyx_um=pre.tracking_scale_zyx(LOOP_RAW, raw_scale))
    else:
        cfg = tconfig.dynatrack_settings(**base)
        pre = Preprocessor(cfg, device="cpu")
        tracker = Tracker(cfg, scale_zyx_um=pre.tracking_scale_zyx(LOOP_RAW, raw_scale),
                          device="cpu")

    def updater(stack, t, p):  # the JAX engine's closure (engine.py:202-207)
        return tracker.update(pre.tracking_stack(stack), t, p).stage_shift_xyz

    pos = POSITION[package]
    manager = pos.PositionUpdateManager(pos.PositionStore(), updater)
    try:
        return chip_smoke.closed_loop(manager, _sample(raw0), LOOP_TIMEPOINTS, raw_scale)
    finally:
        manager.shutdown()


@pytest.fixture(scope="module")
def loop_runs():
    raw0 = _loop_raw0()
    matrix = chip_smoke.loop_matrix(tconfig.deskew_settings(**DESKEW),
                                    chip_smoke.loop_raw_scale(tconfig.deskew_settings(**DESKEW)))
    return {package: _loop(package, matrix, raw0) for package in PACKAGES}


def test_loop_positions_match_jax_and_recentre(loop_runs):
    ours, theirs = loop_runs["shrimpy_tpu_torch"], loop_runs["shrimpy_tpu"]
    for a, b in zip(ours, theirs):
        assert a["applied"] is True and b["applied"] is True and a["drained"] and b["drained"]
        np.testing.assert_allclose(a["position_um"], b["position_um"], rtol=0,
                                   atol=POSITION_ATOL_UM)
        assert a["offset_px"] == b["offset_px"] and a["offset_after_px"] == b["offset_after_px"]
    taken, after = chip_smoke.loop_residuals(ours, LOOP_DRIFT)
    # The loop lags one timepoint: each stack shows one timepoint's drift,
    # and the correction of it leaves the sample where it started.
    assert all(max(abs(v) for v in r) <= 1 for r in after[1:]), after
    assert all(max(abs(a - d) for a, d in zip(r, LOOP_DRIFT)) <= 1 for r in taken[1:]), taken
    # The stage moved: t * drift in raw px after each correction.
    assert ours[-1]["offset_after_px"][0] >= (LOOP_TIMEPOINTS - 1) * LOOP_DRIFT[0] - 1


def test_minus_identity_does_not_recentre_a_deskewed_scan_drift():
    """-I sends the deskewed y shift (a scan drift of the raw) to the stage's
    y, which the seam rolls along the raw's tilt axis: the scan drift is not
    undone, the tilt rolls add a drift of their own, and the residual grows
    every timepoint ([[0, 0, 0], [2, -5, 0], [5, -11, 0], [9, -20, 0]] raw px
    here). ``chip_smoke.loop_matrix`` sends it to the scan axis."""
    minus_i = [[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]]
    records = _loop("shrimpy_tpu_torch", minus_i, _loop_raw0())
    _, after = chip_smoke.loop_residuals(records, LOOP_DRIFT)
    sizes = [max(abs(v) for v in r[:2]) for r in after]
    assert sizes[1] > 1 and all(a < b for a, b in zip(sizes[1:], sizes[2:])), after
    assert all(r[2] == 0 for r in after), after  # x has no such mix-up


def test_loop_matrix_inverts_the_deskew_geometry():
    """The matrix maps the deskewed shift of a raw roll (a, b, c) back to
    the stage move that undoes it, for another angle and ratio too."""
    for angle, ratio in ((30.0, 0.386), (45.0, 0.5)):
        d = tconfig.deskew_settings(ls_angle_deg=angle, px_to_scan_ratio=ratio)
        scale = chip_smoke.loop_raw_scale(d)
        m = np.asarray(chip_smoke.loop_matrix(d, scale))
        th = np.radians(angle)
        for a, b, c in ((3, 0, 0), (0, 2, 0), (0, 0, -5), (1, -2, 4)):
            shift_um = scale[1] * np.array([b * np.sin(th), a / ratio + b * np.cos(th), c])
            move_xyz = -m @ shift_um[::-1]
            np.testing.assert_allclose(move_xyz, [c * scale[2], b * scale[1], a * scale[0]],
                                       atol=1e-12)
