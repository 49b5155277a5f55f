"""PyTorch port of DynaTrack tracking against the JAX package (CPU).

``shrimpy_tpu_torch/tracking`` and ``engine/autofocus.py`` against
``shrimpy_tpu/tracking`` and ``shrimpy_tpu/engine/autofocus.py`` on seeded
inputs (``synthetic_blob_fov`` time-lapses). Tolerances: integer shifts
(``pcc``, ``multiotsu_pcc``, ``roi_center_pcc``, ``template_matching``)
equal; centres of mass within 1e-4 px (float32 sums in another order;
``multiotsu_center_of_mass`` weighs a 0/1 mask, whose sums are exact, and is
equal); journal rows equal but for ``wall_time``, the centre-of-mass
method's numbers within 2e-4 (1e-4 px, then rounding to four places); the
preprocessor's products within 1e-5 of the scale; the focus metric's powers
within 1e-5 and its index equal. The host helpers are pinned statement for
statement to the JAX module's.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy import ndimage

from shrimpy_tpu.cli.main import cli as jax_cli
from shrimpy_tpu.config import DynaTrackConfig as JaxDynaTrackConfig
from shrimpy_tpu.engine import autofocus as jaf
from shrimpy_tpu.io.synthetic import gaussian_blob, synthetic_blob_fov
from shrimpy_tpu.tracking import Tracker as JaxTracker
from shrimpy_tpu.tracking import core as jcore
from shrimpy_tpu.tracking.preprocess import Preprocessor as JaxPreprocessor
from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.cli.main import cli
from shrimpy_tpu_torch.config.schemas import DynaTrackConfig
from shrimpy_tpu_torch.engine import autofocus as taf
from shrimpy_tpu_torch.ops import phase as tphase
from shrimpy_tpu_torch.tracking import Tracker, core
from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
COM_ATOL = 1e-4
PRODUCT_RTOL = 1e-5

METHODS = {
    "pcc": {},
    "intensity_center_of_mass": {},
    "roi_center_pcc": {"roi_center": {"blob_sigma": 4.0}},
    "multiotsu_center_of_mass": {},  # otsu_sigma 5: radius 20, past z = 16
    "multiotsu_pcc": {"segmentation": {"otsu_sigma": 1.0, "otsu_component": 1}},
    "template_matching": {"template": {"slice_zyx": ((4, 12), (22, 42), (22, 42))}},
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def blob_fov(tmp_path_factory):
    path = tmp_path_factory.mktemp("fov") / "tl.zarr"
    pos = synthetic_blob_fov(path, n_timepoints=4)
    return path, [np.asarray(pos.volume(t, 0)) for t in range(4)]


def _configs(**kw):
    """The same settings as the JAX package's model, the port's model and
    the port's namespace."""
    base = {"input_channel": "BF", "tracking_channel": "BF", **kw}
    return JaxDynaTrackConfig(**base), DynaTrackConfig(**base), tconfig.dynatrack_settings(**base)


def _rows_match(ours, theirs, atol: float) -> None:
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if k == "wall_time":
                continue
            if atol and k.startswith(("shift_", "stage_")):
                assert abs(float(a[k]) - float(b[k])) <= atol, (k, a[k], b[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("method", list(METHODS))
def test_each_method_matches_jax_tracker(method, blob_fov, tmp_path):
    _, vols = blob_fov
    jcfg, tcfg, ns = _configs(tracking_method=method, **METHODS[method])
    scale = (1.0, 0.5, 0.5)
    jt = JaxTracker(jcfg, scale_zyx_um=scale, journal=jcore.ShiftJournal(tmp_path / "j.csv"))
    ours = [Tracker(cfg, scale_zyx_um=scale, device="cpu",
                    journal=core.ShiftJournal(tmp_path / f"t{i}.csv"))
            for i, cfg in enumerate((tcfg, ns, jcfg))]
    com = method == "intensity_center_of_mass"
    for t, vol in enumerate(vols):
        want = jt.update(vol, t)
        for tracker in ours:
            got = tracker.update(torch.from_numpy(vol) if t % 2 else vol, t)
            assert got.reanchored == want.reanchored and got.skipped == want.skipped
            if com:
                np.testing.assert_allclose(got.shift_px_zyx, want.shift_px_zyx, rtol=0,
                                           atol=COM_ATOL)
            else:
                np.testing.assert_array_equal(got.shift_px_zyx, want.shift_px_zyx)
    for i in range(3):
        _rows_match(core.ShiftJournal(tmp_path / f"t{i}.csv").rows(), jt.journal.rows(),
                    2 * COM_ATOL if com else 0.0)
    if method in ("pcc", "template_matching", "multiotsu_pcc"):
        # The drift (0.5, 2, -3) a timepoint, to the pixel.
        np.testing.assert_allclose(want.shift_px_zyx, [1.5, 6.0, -9.0], atol=0.6)


def test_references_stay_on_the_host_as_copies(blob_fov):
    _, vols = blob_fov
    _, _, ns = _configs(tracking_method="pcc")
    tracker = Tracker(ns, device="cpu")
    first = torch.from_numpy(vols[0].copy())
    tracker.update(first, 0)
    kept = tracker._references[0]
    first.zero_()  # the caller reuses its buffer
    assert kept.device.type == "cpu" and float(kept.abs().max()) > 0
    r = tracker.update(vols[1], 1)
    np.testing.assert_array_equal(r.shift_px_zyx, [0.0, 2.0, -3.0])
    assert tracker._references[0] is kept  # the same host buffer until re-anchored
    assert "reference_to_host" in tracker.timer.as_dict()
    assert "reference_to_device" in tracker.timer.as_dict()


def test_reanchor_interval_and_positions_match_jax(blob_fov):
    _, vols = blob_fov
    for kw in ({"reference_update_interval": 2}, {"tracking_interval": 2},
               {"reference_update_interval": 3, "tracking_interval": 1}):
        jcfg, _, ns = _configs(tracking_method="pcc", **kw)
        jt, tt = JaxTracker(jcfg), Tracker(ns, device="cpu")
        for t in range(6):
            for p, vol in (("A", vols[t % 4]), ("B", vols[(t + 2) % 4])):
                want, got = jt.update(vol, t, p), tt.update(vol, t, p)
                assert (got.reanchored, got.skipped) == (want.reanchored, want.skipped), (kw, t)
                np.testing.assert_array_equal(got.shift_px_zyx, want.shift_px_zyx)
        assert tt.has_reference("A") == jt.has_reference("A")
        tt.reset_reference("A")
        assert not tt.has_reference("A") and tt.has_reference("B")
        tt.reset_reference()
        assert not tt.has_reference("B")
    skipped = Tracker(_configs(tracking_interval=2)[2], device="cpu").update(vols[0], 1)
    assert skipped.skipped and skipped.shift_px_zyx is not skipped.shift_um_zyx


@pytest.mark.parametrize("limits", [None, {"z": (0.3, 1.0), "y": (0.0, 0.6)}])
def test_post_processing_matches_jax(limits, blob_fov):
    _, vols = blob_fov
    kw = {"shift": {"limits": limits, "dampening": (1.0, 0.8, 0.5)},
          "image_to_stage_matrix_xyz": [[-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]}
    jcfg, _, ns = _configs(tracking_method="pcc", **kw)
    jt, tt = JaxTracker(jcfg, scale_zyx_um=(0.4, 0.2, 0.1)), Tracker(
        ns, scale_zyx_um=(0.4, 0.2, 0.1), device="cpu")
    for t, vol in enumerate(vols):
        want, got = jt.update(vol, t), tt.update(vol, t)
        for field in ("shift_px_zyx", "shift_um_zyx", "stage_shift_xyz"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


HOST_COPIES = ("shift_px_to_um", "apply_limits", "apply_dampening", "image_to_stage_shift",
               "corrected_position", "process_shift", "JOURNAL_FIELDS", "ShiftJournal",
               "TrackerResult", "AXES")


def _defs(path: Path) -> dict:
    """Top-level definitions by name, without docstrings."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        for sub in ast.walk(node):
            body = getattr(sub, "body", None)
            if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                sub.body = body[1:] or [ast.Pass()]
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", HOST_COPIES)
def test_host_copies_are_the_originals(name):
    ours = _defs(REPO / "shrimpy_tpu_torch/tracking/core.py")
    theirs = _defs(REPO / "shrimpy_tpu/tracking/core.py")
    assert ours[name] == theirs[name]


def test_host_copies_behave_as_the_originals(tmp_path):
    shift = np.array([0.2, -5.0, 7.0])
    limits = {"z": (0.5, 2.0), "y": (0.0, 1.0)}
    assert np.array_equal(core.apply_limits(shift, limits), jcore.apply_limits(shift, limits))
    assert np.array_equal(core.shift_px_to_um(shift, (0.5, 0.1, 0.1)),
                          jcore.shift_px_to_um(shift, (0.5, 0.1, 0.1)))
    assert np.array_equal(core.corrected_position(shift, shift[::-1]),
                          jcore.corrected_position(shift, shift[::-1]))
    ours, theirs = core.ShiftJournal(tmp_path / "a.csv"), jcore.ShiftJournal(tmp_path / "b.csv")
    for journal in (ours, theirs):
        journal.append(timepoint=3, position="A", method="pcc", shift_px_zyx=shift,
                       shift_um_zyx=shift / 2, stage_shift_xyz=shift[::-1], reanchored=True)
    _rows_match(ours.rows(), theirs.rows(), 0.0)
    assert core.JOURNAL_FIELDS == jcore.JOURNAL_FIELDS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blob_template_is_gaussian_blob(dtype):
    """``roi_center_pcc``'s template builder against
    ``io/synthetic.py::gaussian_blob`` (float32 ``exp`` of two libraries:
    within 1e-6 of the peak; float64 within 1e-6 of the float32 blob)."""
    shape, center, sigma = (9, 20, 31), (4.0, 9.5, 15.0), (10.0, 10.0, 10.0)
    ours = core._gaussian_blob(shape, center, sigma, device="cpu", dtype=dtype)
    assert ours.dtype == dtype
    assert _rel(ours.numpy(), gaussian_blob(shape, center, sigma)) <= 1e-6


def test_dynatrack_defaults_equal_the_schema():
    ns, model = tconfig.dynatrack_settings(), JaxDynaTrackConfig(input_channel="a",
                                                                  tracking_channel="a")
    assert set(tconfig.DYNATRACK_DEFAULTS) == set(type(model).model_fields)
    for field, value in tconfig.DYNATRACK_DEFAULTS.items():
        if field in tconfig.DYNATRACK_PARTS:
            assert vars(getattr(ns, field)) == getattr(model, field).model_dump(), field
        elif field not in ("input_channel", "tracking_channel"):
            assert value == getattr(model, field), field
    from shrimpy_tpu.config.schemas import TRACKING_METHODS
    assert tconfig.TRACKING_METHODS == TRACKING_METHODS
    with pytest.raises(ValueError, match="tracking_method"):
        tconfig.dynatrack_settings(tracking_method="nope")
    with pytest.raises(ValueError, match="slice_zyx"):
        tconfig.dynatrack_settings(tracking_method="template_matching")
    with pytest.raises(TypeError, match="unknown"):
        tconfig.dynatrack_settings(segmentation={"bogus": 1})


def _pre_config(steps, **kw):
    return {"input_channel": "BF", "tracking_channel": "BF", "preprocessing": steps,
            "deskew": {"px_to_scan_ratio": 0.386, "pixel_size_um": 0.116},
            "phase": {"transfer_function": {"yx_pixel_size": 0.116, "z_pixel_size": 0.116}},
            **kw}


@pytest.mark.parametrize("steps", [["deskew"], ["deskew", "phase"], ["phase"]])
def test_preprocessor_matches_jax(steps):
    raw = (np.random.default_rng(20).random((60, 24, 28)) * 100 + 10).astype(np.float32)
    base = _pre_config(steps)
    want = JaxPreprocessor(JaxDynaTrackConfig(**base))(raw)
    for cfg in (DynaTrackConfig(**base), tconfig.dynatrack_settings(**base)):
        got = Preprocessor(cfg, device="cpu")(raw)
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == torch.float32 and tuple(got[key].shape) == value.shape
            assert _rel(got[key].numpy(), value) <= PRODUCT_RTOL, key
    pre = Preprocessor(tconfig.dynatrack_settings(**base), device="cpu")
    np.testing.assert_array_equal(pre.tracking_stack(raw).numpy(),
                                  pre(raw)["phase" if "phase" in steps else "deskewed"].numpy())
    ref64 = Preprocessor(tconfig.dynatrack_settings(**base), device="cpu", dtype=torch.float64)
    got64 = ref64.tracking_stack(raw)
    assert got64.dtype == torch.float64
    assert _rel(pre.tracking_stack(raw).numpy(), got64.numpy()) <= PRODUCT_RTOL


def test_preprocessor_keeps_the_tf_once_per_geometry():
    base = _pre_config(["phase"])
    pre = Preprocessor(tconfig.dynatrack_settings(**base), device="cpu")
    raw = np.random.default_rng(21).random((10, 16, 18)).astype(np.float32)
    before = tphase._compute_tf_cached.cache_info()
    pre(raw)
    tf = pre._tf
    pre(raw)
    assert pre._tf is tf  # no second host TF, no second move
    after = tphase._compute_tf_cached.cache_info()
    assert after.hits + after.misses == before.hits + before.misses + 1
    # The host TF cache is shared: a TF computed beforehand is a hit.
    other = Preprocessor(tconfig.dynatrack_settings(**base), device="cpu")
    other(raw)
    assert tphase._compute_tf_cached.cache_info().hits == after.hits + 1
    pre(raw[:, :, :17])
    assert tuple(pre._tf.shape) == (20, 16, 17)


def test_tracking_scale_matches_jax():
    for steps, deskew in ((["deskew"], {"px_to_scan_ratio": 0.386, "pixel_size_um": 0.116,
                                        "average_n_slices": 3}),
                          (["deskew"], {"px_to_scan_ratio": 0.386}),
                          (["phase"], None), (None, None)):
        base = {"input_channel": "BF", "tracking_channel": "BF", "preprocessing": steps,
                "deskew": deskew}
        want = JaxPreprocessor(JaxDynaTrackConfig(**base)).tracking_scale_zyx(
            (64, 128, 128), (0.3, 0.116, 0.116))
        got = Preprocessor(tconfig.dynatrack_settings(**base)).tracking_scale_zyx(
            (64, 128, 128), (0.3, 0.116, 0.116))
        assert got == want


def test_virtual_staining_names_its_item():
    with pytest.raises(NotImplementedError, match="item 10"):
        Preprocessor(tconfig.dynatrack_settings(input_channel="BF", tracking_channel="BF",
                                                preprocessing=["phase", "vs"]))


def test_preprocessor_then_tracker_matches_jax():
    """deskew -> pcc over a drifting raw stack, the port against JAX."""
    rng = np.random.default_rng(22)
    base = _pre_config(["deskew"], tracking_method="pcc")
    jpre, jt = JaxPreprocessor(JaxDynaTrackConfig(**base)), JaxTracker(JaxDynaTrackConfig(**base))
    ns = tconfig.dynatrack_settings(**base)
    pre, tt = Preprocessor(ns, device="cpu"), Tracker(ns, device="cpu")
    vol = rng.random((70, 24, 32)).astype(np.float32)
    vol[30:34, 10:14, 12:18] += 50.0
    for t in range(3):
        raw = np.roll(vol, (3 * t, 0, 2 * t), axis=(0, 1, 2))
        want = jt.update(jpre.tracking_stack(raw), t)
        got = tt.update(pre.tracking_stack(raw), t)
        np.testing.assert_array_equal(got.shift_px_zyx, want.shift_px_zyx)


def _defocus_stack(in_focus: int, nz: int, size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sharp = rng.random((size, size)).astype(np.float32)
    return np.stack([ndimage.gaussian_filter(sharp, abs(z - in_focus) * 0.8 + 0.01)
                     for z in range(nz)])


@pytest.mark.parametrize("size", [64, 63])
@pytest.mark.parametrize("transform", ["xla", "matmul"])
def test_focus_metric_matches_jax(size, transform):
    stack = _defocus_stack(5, 9, size, seed=size)
    args = (jnp.asarray(stack), jnp.float32(0.116), jnp.float32(0.55), jnp.float32(1.35),
            (0.125, 0.25))
    want = np.asarray(jaf._focus_metric_jit(*args, transform))
    got = taf.focus_power(stack, pixel_size_um=0.116, device="cpu")
    assert _rel(got.numpy(), want) <= PRODUCT_RTOL
    got64 = taf.focus_power(stack, pixel_size_um=0.116, device="cpu", dtype=torch.float64)
    assert _rel(got.numpy(), got64.numpy()) <= PRODUCT_RTOL
    idx = taf.focus_from_transverse_band(stack, pixel_size_um=0.116, transform=transform,
                                         device="cpu")
    assert idx == jaf.focus_from_transverse_band(stack, pixel_size_um=0.116,
                                                 transform=transform) == 5


def test_focus_threshold_matches_jax():
    flat = np.ones((9, 32, 32), np.float32)
    flat += np.random.default_rng(0).normal(0, 1e-6, flat.shape).astype(np.float32)
    assert taf.focus_from_transverse_band(flat, pixel_size_um=0.116, threshold=10.0,
                                          device="cpu") is None
    assert jaf.focus_from_transverse_band(flat, pixel_size_um=0.116, threshold=10.0) is None
    zero = np.zeros((5, 16, 16), np.float32)
    assert taf.focus_from_transverse_band(zero, pixel_size_um=0.116, threshold=2.0,
                                          device="cpu") is None
    with pytest.raises(ValueError, match="transform"):
        taf.focus_from_transverse_band(zero, pixel_size_um=0.116, transform="dft", device="cpu")


@pytest.mark.parametrize("method", ["pcc", "intensity_center_of_mass"])
def test_track_verb_matches_jax(method, blob_fov, tmp_path):
    path, _ = blob_fov
    cfg = tmp_path / "track.yml"
    cfg.write_text(f"input_channel: BF\ntracking_channel: BF\ntracking_method: {method}\n"
                   "shift:\n  limits:\n    y: [0.1, 2.0]\n  dampening: [1.0, 0.8, 0.8]\n")
    runner = CliRunner()
    want = runner.invoke(jax_cli, ["track", str(path), "-c", str(cfg), "-o",
                                   str(tmp_path / "jax.csv")])
    assert want.exit_code == 0, want.output
    got = runner.invoke(cli, ["track", str(path), "-c", str(cfg), "-o",
                              str(tmp_path / "ours.csv"), "--device", "cpu"])
    assert got.exit_code == 0, got.output
    ours = core.ShiftJournal(tmp_path / "ours.csv").rows()
    assert len(ours) == 4
    _rows_match(ours, jcore.ShiftJournal(tmp_path / "jax.csv").rows(),
                2 * COM_ATOL if "mass" in method else 0.0)


def test_track_verb_with_deskew_on_cpu(tmp_path):
    from shrimpy_tpu.io.ngff import create_fov

    rng = np.random.default_rng(23)
    pos = create_fov(tmp_path / "raw.zarr", shape=(2, 1, 60, 24, 28), dtype="float32",
                     zyx_scale=(0.3, 0.116, 0.116), channel_names=["BF"])
    vol = rng.random((60, 24, 28)).astype(np.float32)
    vol[30:34, 10:14, 12:18] += 50.0
    for t in range(2):
        pos.write((t, 0), np.roll(vol, (2 * t, 0, t), axis=(0, 1, 2)))
    cfg = tmp_path / "track.yml"
    cfg.write_text("input_channel: BF\ntracking_channel: BF\npreprocessing: [deskew]\n"
                   "deskew:\n  ls_angle_deg: 30.0\n")
    runner = CliRunner()
    for name, app, extra in (("jax", jax_cli, []), ("ours", cli, ["--device", "cpu"])):
        res = runner.invoke(app, ["track", str(tmp_path / "raw.zarr"), "-c", str(cfg), "-o",
                                  str(tmp_path / f"{name}.csv"), *extra])
        assert res.exit_code == 0, res.output
    _rows_match(core.ShiftJournal(tmp_path / "ours.csv").rows(),
                jcore.ShiftJournal(tmp_path / "jax.csv").rows(), 0.0)


def test_track_verb_without_a_card_asks_for_one(blob_fov, tmp_path, monkeypatch):
    path, _ = blob_fov
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "track.yml"
    cfg.write_text("input_channel: BF\ntracking_channel: BF\n")
    res = CliRunner().invoke(cli, ["track", str(path), "-c", str(cfg), "-o",
                                   str(tmp_path / "x.csv")])
    assert res.exit_code != 0 and "is_available" in res.output


def test_tracking_imports_without_tensorstore_pydantic_click_or_yaml():
    """What a GPU host running only torch may lack, hidden: the tracking
    modules import and run (a deskew + roi_center_pcc update and the focus
    metric on the CPU) with the port's namespace settings, loading no
    ``io`` module."""
    code = textwrap.dedent("""
        import sys
        for name in ("tensorstore", "pydantic", "click", "yaml"):
            sys.modules[name] = None
        import numpy as np
        import torch
        import shrimpy_tpu_torch.tracking
        from shrimpy_tpu_torch.config import dynatrack_settings
        from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band
        from shrimpy_tpu_torch.tracking.core import Tracker
        from shrimpy_tpu_torch.tracking.preprocess import Preprocessor
        cfg = dynatrack_settings(tracking_method="roi_center_pcc", preprocessing=["deskew"],
                                 deskew={"px_to_scan_ratio": 0.386},
                                 roi_center={"blob_sigma": 3.0})
        raw = np.random.default_rng(0).random((40, 24, 20)).astype(np.float32)
        stack = Preprocessor(cfg, device="cpu").tracking_stack(raw)
        r = Tracker(cfg, device="cpu").update(stack, 0)
        assert np.isfinite(r.shift_px_zyx).all()
        assert focus_from_transverse_band(stack, pixel_size_um=0.116, device="cpu") >= 0
        bad = [m for m in sys.modules if m.startswith(("shrimpy_tpu_torch.io", "shrimpy_tpu."))]
        assert not bad, bad
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
