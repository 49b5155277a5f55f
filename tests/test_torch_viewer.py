"""PyTorch port of the live viewer (ROADMAP item 12d) against the JAX package
(CPU).

``viewer/ring.py``, ``viewer/feeder.py`` and ``viewer/web.py`` are copies,
pinned in ``tests/test_torch_config.py`` (``COPIES``). ``deskew_preview.py``
and ``live.py`` are the JAX modules but for the differences their docstrings
name, and the pins here take out exactly those. Then:

* the JAX tests of the viewer (``tests/test_viewer.py``: the ring, the
  feeder's sizing and never-raise contract, the volume index tail, the
  row-gather preview against each package's own volume deskew, the port's
  plain one here, and the headless monitor's behaviours) run on both
  packages;
* ``config.deskew_geometry`` takes and rejects what ``DeskewSettings``
  does, on a list of good and bad ``deskew.json`` geometries;
* a ring written by either package is attached and read by the other's
  ``live.attach``, and the same frames and control files through both
  packages' ``LiveMonitor`` give equal ``state.json`` and bit-equal preview
  planes;
* in a subprocess where pydantic, yaml, matplotlib, click and tensorstore
  cannot be imported (the card's host), the port's viewer imports and its
  monitor writes ``state.json``, logging matplotlib's ``ImportError`` and
  nothing else.
"""

import ast
import json
import math
import os
import queue
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from pydantic import ValidationError

from shrimpy_tpu.config.schemas import DeskewSettings
from shrimpy_tpu_torch import config as tconfig
from tests.acq_pkgs import PACKAGES, Pkg
from tests.test_torch_config import _code

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


def _ring(pkg):
    return pkg("viewer.ring").FrameRing


def _geometry(pkg, **fields):
    """The package's deskew geometry: JAX's pydantic model, the port's
    namespace (what the card's host builds)."""
    if pkg.is_port:
        return pkg("config").deskew_settings(**fields)
    return pkg("config").DeskewSettings(**fields)


@pytest.fixture()
def ring(pkg):
    r = _ring(pkg)(None, n_slots=4, frame_shape=(8, 16))
    yield r
    r.close()


# -- the JAX tests of tests/test_viewer.py, on both packages ---------------------------

def test_ring_write_read_roundtrip(ring):
    frame = np.arange(128, dtype=np.float32).reshape(8, 16)
    slot = ring.write(0, frame)
    seq, out = ring.read(slot)
    assert seq == 0
    np.testing.assert_array_equal(out, frame)


def test_ring_overwrites_oldest(ring):
    for seq in range(6):  # 6 frames into 4 slots
        ring.write(seq, np.full((8, 16), seq, np.float32))
    seq, latest = ring.latest()
    assert seq == 5
    assert latest[0, 0] == 5
    assert ring.read(0)[0] == 4  # slot 0 now holds seq 4


def test_ring_read_rows_gather(ring):
    for seq in range(4):
        ring.write(seq, np.full((8, 16), seq, np.float32))
    rows = ring.read_rows(3, [0, 1, 2, 3])
    assert rows.shape == (4, 16)
    np.testing.assert_array_equal(rows[:, 0], [0, 1, 2, 3])


def test_slots_for_budget(pkg):
    FrameRing = _ring(pkg)
    assert FrameRing.slots_for_budget(1.0, (8, 16)) == 2048
    assert FrameRing.slots_for_budget(0.0001, (2048, 2048)) == 2


def test_cross_handle_visibility(pkg):
    FrameRing = _ring(pkg)
    writer = FrameRing(None, n_slots=2, frame_shape=(4, 4))
    try:
        reader = FrameRing(writer.name, n_slots=2, frame_shape=(4, 4), create=False)
        writer.write(7, np.full((4, 4), 3.5, np.float32))
        seq, frame = reader.latest()
        assert seq == 7
        assert frame[0, 0] == 3.5
        reader.close()
    finally:
        writer.close()


def test_feeder_never_raises_without_start(pkg):
    feeder = pkg("viewer.feeder").ViewerFeeder(frame_shape=(8, 16))
    feeder.on_volume(np.zeros((2, 8, 16), np.float32), 0, "0", "BF")
    assert feeder.dropped == 0


def test_feeder_ring_floor_grows_to_hold_one_volume(pkg):
    ViewerFeeder = pkg("viewer.feeder").ViewerFeeder
    feeder = ViewerFeeder(frame_shape=(8, 16), cache_mb=0.001, n_z=10)
    assert feeder.n_slots == 11
    roomy = ViewerFeeder(frame_shape=(8, 16), cache_mb=1.0, n_z=10)
    assert roomy.n_slots == _ring(pkg).slots_for_budget(1.0, (8, 16))


def test_feeder_skips_oversize_volumes_instead_of_lapping(pkg):
    feeder = pkg("viewer.feeder").ViewerFeeder(frame_shape=(4, 4), cache_mb=0.0001)  # 2 slots
    feeder.ring = _ring(pkg)(None, n_slots=feeder.n_slots, frame_shape=(4, 4))
    ctx_queue = __import__("multiprocessing").get_context("spawn").Queue(4)
    feeder._queue = ctx_queue
    try:
        feeder.on_volume(np.zeros((5, 4, 4), np.float32), 0, "0", "BF")
        assert feeder.dropped == 1
        assert feeder._seq == 0  # nothing written to the ring
        feeder.on_volume(np.zeros((2, 4, 4), np.float32), 0, "0", "BF")
        assert feeder._seq == 2
    finally:
        feeder.ring.close()
        ctx_queue.cancel_join_thread()


def test_volume_index_tail_rereads_torn_line(pkg, tmp_path):
    path = tmp_path / "volumes.jsonl"
    tail = pkg("viewer.live").VolumeIndexTail(path)
    full = json.dumps({"t": 0, "p": "0", "channel": "BF"}) + "\n"
    torn = json.dumps({"t": 1, "p": "0", "channel": "BF"}) + "\n"
    with open(path, "w") as f:
        f.write(full + torn[:10])  # feeder mid-append on line 2
    assert [m["t"] for m in tail.poll()] == [0]
    with open(path, "a") as f:
        f.write(torn[10:])
    assert [m["t"] for m in tail.poll()] == [1]


def _volume_deskew(pkg, raw, settings) -> np.ndarray:
    """The package's own volume deskew: JAX's, or the port's plain one."""
    if pkg.is_port:
        return pkg("ops.deskew").deskew_volume(raw, settings, device="cpu").numpy()
    return np.asarray(pkg("ops.deskew").deskew_volume(raw, settings))


def test_deskew_preview_matches_volume_deskew(pkg):
    """The row-gather preview equals the lab z-plane of the package's own
    volume deskew (up to the interpolation convention)."""
    settings = _geometry(pkg, ls_angle_deg=30.0, px_to_scan_ratio=0.386, keep_overhang=True)
    beads = np.array([[5.0, 40.0, 12.0], [8.0, 70.0, 20.0]])
    raw = pkg("io.synthetic").render_beads_skewed((64, 32, 32), beads)
    t_row = 10  # lab z = 10 * sin(30 deg) = 5.0
    preview = pkg("viewer.deskew_preview").deskew_preview_plane(raw[:, t_row, :], settings)
    full = _volume_deskew(pkg, raw, settings)
    z_lab = int(round(t_row * math.sin(math.radians(30.0))))
    y_off = t_row * math.cos(math.radians(30.0))
    n = min(preview.shape[0], full.shape[1] - int(np.ceil(y_off)) - 1)
    ref_plane = full[z_lab, int(round(y_off)): int(round(y_off)) + n, :]
    corr = np.corrcoef(preview[:n].ravel(), ref_plane.ravel())[0, 1]
    assert corr > 0.95, corr


def test_preview_from_ring(pkg, rng):
    ring = _ring(pkg)(None, n_slots=8, frame_shape=(16, 32))
    try:
        for s in range(8):
            ring.write(s, rng.random((16, 32), dtype=np.float32))
        settings = _geometry(pkg, ls_angle_deg=30.0, px_to_scan_ratio=0.5)
        plane = pkg("viewer.deskew_preview").preview_from_ring(
            ring, list(range(8)), tilt_row=4, settings=settings)
        assert plane.shape == (15, 32)  # floor(7/0.5)+1
        assert np.isfinite(plane).all()
    finally:
        ring.close()


# -- the live monitor (test_viewer.py's headless napari behaviours) ----------------------

def _push_volume(ring, monitor, seq0, t, channel="BF", p="0", value=None, nz=4,
                 shape=(8, 16)):
    """Write one volume into the ring and index it in the monitor."""
    slots = []
    for z in range(nz):
        frame = np.full(shape, value if value is not None else t * 10 + z, np.float32)
        slots.append(ring.write(seq0 + z, frame))
    monitor.on_volume({"type": "volume", "t": t, "p": p, "channel": channel,
                       "slots": slots, "seq0": seq0, "shape": (nz, *shape)})
    return seq0 + nz


@pytest.fixture()
def live(pkg, tmp_path):
    ring = _ring(pkg)(None, n_slots=16, frame_shape=(8, 16))
    monitor = pkg("viewer.live").LiveMonitor(ring, tmp_path / "preview")
    yield ring, monitor, tmp_path / "preview"
    ring.close()


def _state(out):
    return json.loads((out / "state.json").read_text())


def test_live_follow_latest_then_scrub_pause(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0)
    seq = _push_volume(ring, monitor, seq, t=1)
    monitor.render_dirty()
    assert _state(out)["displayed"]["0|BF"] == 1  # follow-latest
    (out / "view.json").write_text('{"follow": false, "t": 0}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert _state(out)["displayed"]["0|BF"] == 0  # scrub-paused at t=0
    seq = _push_volume(ring, monitor, seq, t=2)
    monitor.render_dirty()
    assert _state(out)["displayed"]["0|BF"] == 0
    (out / "view.json").write_text('{"follow": true}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert _state(out)["displayed"]["0|BF"] == 2  # Home-resume


def test_live_z_scrub_renders_requested_plane(live):
    ring, monitor, out = live
    _push_volume(ring, monitor, 0, t=0, nz=4)
    monitor.render_dirty()
    png = next(out.glob("live_*.png"))
    mid_bytes = png.read_bytes()
    assert _state(out)["pinned_z"] is None
    assert monitor._plane_index(4) == 2  # mid-plane default
    (out / "view.json").write_text('{"z": 0}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert _state(out)["pinned_z"] == 0
    assert monitor._plane_index(4) == 0
    assert png.read_bytes() != mid_bytes
    (out / "view.json").write_text('{"z": 99}')
    assert monitor.refresh_controls()
    assert monitor._plane_index(4) == 3
    (out / "view.json").write_text('{"z": null}')
    assert monitor.refresh_controls()
    assert monitor._plane_index(4) == 2


def test_live_editable_deskew_geometry(live):
    ring, monitor, out = live
    _push_volume(ring, monitor, 0, t=0)
    monitor.render_dirty()
    assert (out / "live_p0_BF.png").exists()
    (out / "deskew.json").write_text('{"ls_angle_deg": 30.0, "px_to_scan_ratio": 0.5}')
    assert monitor.refresh_controls()
    assert monitor.render_dirty() == 1  # re-rendered with no new volume
    assert _state(out)["deskew"]["px_to_scan_ratio"] == 0.5
    (out / "deskew.json").write_text('{"ls_angle_deg": 45.0, "px_to_scan_ratio": 0.5}')
    assert monitor.refresh_controls()
    assert monitor.render_dirty() == 1
    assert _state(out)["deskew"]["ls_angle_deg"] == 45.0


def test_live_per_channel_autocontrast_frozen(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0, channel="BF", value=10.0)
    seq = _push_volume(ring, monitor, seq, t=0, channel="GFP", value=1000.0)
    monitor.render_dirty()
    bf0 = monitor.contrast["BF"]
    assert bf0[1] < monitor.contrast["GFP"][1]  # per-channel, not global
    _push_volume(ring, monitor, seq, t=1, channel="BF", value=9000.0)
    monitor.render_dirty()
    assert monitor.contrast["BF"] == bf0  # frozen


def test_live_contrast_refresh_control(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0, channel="BF", value=10.0)
    monitor.render_dirty()
    bf0 = monitor.contrast["BF"]
    _push_volume(ring, monitor, seq, t=1, channel="BF", value=9000.0)
    (out / "view.json").write_text(json.dumps({"contrast": "refresh"}))
    assert monitor.refresh_controls()
    assert "BF" not in monitor.contrast
    monitor.render_dirty()
    assert monitor.contrast["BF"][1] > bf0[1]  # re-stretched to t=1


def test_live_contrast_mode_auto(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0, channel="BF", value=10.0)
    monitor.render_dirty()
    bf0 = monitor.contrast["BF"]
    (out / "view.json").write_text(json.dumps({"contrast_mode": "auto"}))
    assert monitor.refresh_controls()
    seq = _push_volume(ring, monitor, seq, t=1, channel="BF", value=9000.0)
    monitor.render_dirty()
    assert monitor.contrast["BF"][1] > bf0[1]
    bf1 = monitor.contrast["BF"]
    (out / "view.json").write_text(json.dumps({"contrast_mode": "freeze"}))
    assert monitor.refresh_controls()
    seq = _push_volume(ring, monitor, seq, t=2, channel="BF", value=10.0)
    monitor.render_dirty()
    frozen = monitor.contrast["BF"]
    _push_volume(ring, monitor, seq, t=3, channel="BF", value=5000.0)
    monitor.render_dirty()
    assert monitor.contrast["BF"] == frozen  # frozen again
    assert frozen[1] < bf1[1]


def test_live_volume_granularity_eviction(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0)
    seq = _push_volume(ring, monitor, seq, t=1)
    monitor.render_dirty()
    _push_volume(ring, monitor, 16, t=2)  # slots 0..3 overwritten
    _push_volume(ring, monitor, 20, t=3)  # slots 4..7 overwritten
    (out / "view.json").write_text('{"follow": false, "t": 1}')
    monitor.refresh_controls()
    monitor.render_dirty()
    state = _state(out)
    assert state["evicted"] >= 1
    assert state["displayed"]["0|BF"] in (2, 3)


def test_feeder_writes_attach_surface(pkg, tmp_path):
    feeder = pkg("viewer.feeder").ViewerFeeder(frame_shape=(8, 16), cache_mb=0.01,
                                               preview_dir=tmp_path / "preview")
    # The ring and descriptor without the monitor subprocess.
    feeder.preview_dir.mkdir(parents=True, exist_ok=True)
    feeder.ring = _ring(pkg)(None, n_slots=feeder.n_slots, frame_shape=feeder.frame_shape)
    (feeder.preview_dir / "ring.json").write_text(json.dumps({
        "ring": feeder.ring.name, "n_slots": feeder.n_slots,
        "frame_shape": list(feeder.frame_shape), "dtype": "float32"}))
    feeder._queue = queue.Queue(maxsize=4)
    try:
        feeder.on_volume(np.ones((3, 8, 16), np.float32), 0, "0", "BF")
        feeder.on_volume(np.full((3, 8, 16), 2, np.float32), 1, "0", "BF")
        ring, tail = pkg("viewer.live").attach(tmp_path / "preview")
        msgs = tail.poll()
        assert [m["t"] for m in msgs] == [0, 1]
        assert msgs[0]["seq0"] == 0 and msgs[1]["seq0"] == 3
        seq, frame = ring.read(msgs[1]["slots"][0])
        assert seq == 3 and frame[0, 0] == 2
        assert tail.poll() == []  # tail is incremental
        ring.close()
    finally:
        feeder.ring.close()


def test_colormap_for_channel_mapping(pkg):
    colormap_for_channel = pkg("viewer.live").colormap_for_channel
    assert colormap_for_channel("BF") == "gray"
    for name, expect in [("GFP", "shrimpy_green"), ("epi-FITC", "shrimpy_green"),
                         ("mCherry", "shrimpy_magenta"), ("Rhodamine-B", "shrimpy_magenta"),
                         ("DAPI", "shrimpy_blue")]:
        cmap = colormap_for_channel(name)
        assert cmap != "gray" and cmap.name == expect, name
        assert cmap(0.0)[:3] == (0.0, 0.0, 0.0)
        assert max(cmap(1.0)[:3]) == 1.0 or name.startswith("DAPI")


def test_live_axis_scrub_slices_y_and_x(live):
    ring, monitor, out = live
    _push_volume(ring, monitor, 0, t=0, nz=4)
    monitor.render_dirty()
    png = next(out.glob("live_*.png"))
    z_bytes = png.read_bytes()
    (out / "view.json").write_text('{"axis": "y", "z": 3}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert _state(out)["slice_axis"] == "y"
    y_bytes = png.read_bytes()
    assert y_bytes != z_bytes  # a (Z, X) plane, not a (Y, X) plane
    (out / "view.json").write_text('{"axis": "x", "z": 1}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert png.read_bytes() != y_bytes
    (out / "view.json").write_text('{"axis": "diag"}')
    assert not monitor.refresh_controls()  # ignored, state unchanged
    assert monitor.slice_axis == "x"


def test_live_channel_visibility_toggle(live):
    ring, monitor, out = live
    seq = _push_volume(ring, monitor, 0, t=0, channel="BF")
    _push_volume(ring, monitor, seq, t=0, channel="GFP")
    monitor.render_dirty()
    assert len(list(out.glob("live_*.png"))) == 2
    assert _state(out)["channels"] == ["BF", "GFP"]
    (out / "view.json").write_text('{"channels": ["GFP"]}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    pngs = sorted(p.name for p in out.glob("live_*.png"))
    assert len(pngs) == 1 and "GFP" in pngs[0]
    state = _state(out)
    assert state["visible_channels"] == ["GFP"]
    assert "0|BF" not in state["displayed"]
    (out / "view.json").write_text('{"channels": null}')
    assert monitor.refresh_controls()
    monitor.render_dirty()
    assert len(list(out.glob("live_*.png"))) == 2


# -- the differences, pinned --------------------------------------------------------------

PREVIEW_DIFFERENCES = (
    ("settings: DeskewSettings", 'settings: "DeskewSettings"'),
    ("settings.require_ratio()", "require_ratio(settings)"),
)
LIVE_DIFFERENCES = (
    ("deskew: DeskewSettings | None = None", 'deskew: "DeskewSettings | None" = None'),
    ("DeskewSettings(**geo)", "deskew_geometry(**geo)"),
    ("new.require_ratio()", "require_ratio(new)"),
    ("self.deskew.model_dump()", "_dump(self.deskew)"),
)
# The JAX module's import of the schemas, and the port's of its config
# package (normalised to the JAX package's name).
SETTINGS_IMPORTS = ("shrimpy_tpu.config.schemas", "shrimpy_tpu.config")


@pytest.mark.parametrize("rel,differences", [("viewer/deskew_preview.py", PREVIEW_DIFFERENCES),
                                             ("viewer/live.py", LIVE_DIFFERENCES)])
def test_module_is_the_original_but_for_its_named_differences(rel, differences):
    """The JAX module with each named difference made in its text is the
    port's, statement for statement, once each module's settings import is
    left out; each difference is needed, and the docstring names it."""
    ours, theirs = REPO / "shrimpy_tpu_torch" / rel, REPO / "shrimpy_tpu" / rel
    kw = {"drop_imports": SETTINGS_IMPORTS}
    assert _code(theirs, replace=differences, **kw) == _code(ours, **kw)
    for i in range(len(differences)):
        rest = differences[:i] + differences[i + 1:]
        assert _code(theirs, replace=rest, **kw) != _code(ours, **kw), differences[i]
    tree = ast.parse(ours.read_text())
    top = {n.module: sorted(a.name for a in n.names) for n in tree.body
           if isinstance(n, ast.ImportFrom)}
    assert not [m for m in top if "schemas" in m or "pydantic" in m], top
    assert top["shrimpy_tpu_torch.config"] == sorted(
        {new.split("(")[0] for _, new in differences if "(" in new})
    doc = ast.get_docstring(tree)
    assert "config.require_ratio" in doc and "by name only" in doc


GOOD_GEOMETRIES = [
    {}, {"ls_angle_deg": 30}, {"ls_angle_deg": "31.5"}, {"ls_angle_deg": " 30 "},
    {"ls_angle_deg": True}, {"ls_angle_deg": "1e1"}, {"px_to_scan_ratio": 0.5},
    {"px_to_scan_ratio": "0.39"}, {"px_to_scan_ratio": True}, {"px_to_scan_ratio": "inf"},
    {"px_to_scan_ratio": None}, {"average_n_slices": 2.0}, {"average_n_slices": "2"},
    {"average_n_slices": "3.0"}, {"average_n_slices": True}, {"average_n_slices": " 3 "},
    {"keep_overhang": 1}, {"keep_overhang": 0.0}, {"keep_overhang": "yes"},
    {"keep_overhang": "True"}, {"keep_overhang": "off"}, {"keep_overhang": "t"},
    {"keep_overhang": "1"}, {"backend": "xla"}, {"backend": "pallas"},
    {"pixel_size_um": 0.116, "scan_step_um": 0.3},
    {"pixel_size_um": "0.116", "scan_step_um": 0.3, "ls_angle_deg": 45},
    {"pixel_size_um": 0.116, "scan_step_um": 0.3, "px_to_scan_ratio": 2.0},
    {"pixel_size_um": 0.116}, {"scan_step_um": 0}, {"px_to_scan_ratio": 1e-4},
    {"ls_angle_deg": 30.0, "px_to_scan_ratio": 0.386, "keep_overhang": False,
     "average_n_slices": 3, "backend": "auto"},
]
BAD_GEOMETRIES = [
    {"ls_angle_deg": "abc"}, {"ls_angle_deg": None}, {"ls_angle_deg": [30]},
    {"ls_angle_deg": {"v": 30}}, {"ls_angle_deg": "nan"}, {"ls_angle_deg": 90},
    {"ls_angle_deg": 0}, {"ls_angle_deg": -10}, {"ls_angle_deg": 1e400}, {"ls_angle_deg": 10**400},
    {"px_to_scan_ratio": 0}, {"px_to_scan_ratio": -0.5}, {"px_to_scan_ratio": "x"},
    {"px_to_scan_ratio": [0.5]}, {"average_n_slices": 2.5}, {"average_n_slices": None},
    {"average_n_slices": 0}, {"average_n_slices": "2.5"}, {"average_n_slices": "two"},
    {"keep_overhang": 2}, {"keep_overhang": 0.5}, {"keep_overhang": None},
    {"keep_overhang": " true "}, {"keep_overhang": "maybe"}, {"keep_overhang": [True]},
    {"backend": "XLA"}, {"backend": None}, {"backend": 1}, {"backend": "cuda"},
    {"positions": [0]}, {"bogus": 1}, {"pyramid_levels": 1}, {"output_dtype": "float32"},
    {"pixel_size_um": 0.116, "scan_step_um": 0}, {"pixel_size_um": -0.116, "scan_step_um": 0.3},
    {"pixel_size_um": "a", "scan_step_um": 0.3}, {"scan_step_um": [1]},
]


@pytest.mark.parametrize("geo", GOOD_GEOMETRIES, ids=repr)
def test_deskew_geometry_keeps_what_deskew_settings_keeps(geo):
    want = DeskewSettings(**geo).model_dump()
    got = tconfig.deskew_geometry(**geo)
    assert vars(got) == want and tconfig._dump(got) == want
    assert [type(v) for v in vars(got).values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("geo", BAD_GEOMETRIES, ids=repr)
def test_deskew_geometry_rejects_what_deskew_settings_rejects(geo):
    with pytest.raises((ValidationError, ZeroDivisionError)):
        DeskewSettings(**geo)
    with pytest.raises((TypeError, ValueError, OverflowError, ZeroDivisionError)):
        tconfig.deskew_geometry(**geo)


def _deskew_json_cases():
    """``deskew.json`` values and whether the JAX monitor takes them:
    the geometries above, and ratios the preview cannot render."""
    ratios = [(g, DeskewSettings(**g).px_to_scan_ratio) for g in GOOD_GEOMETRIES]
    cases = [(g, r is not None and r >= 1e-3) for g, r in ratios]
    cases += [(g, False) for g in BAD_GEOMETRIES]
    cases += [({"px_to_scan_ratio": 9.99e-4}, False), ({"px_to_scan_ratio": 1e-3}, True)]
    assert {ok for _, ok in cases} == {True, False}
    return cases


def test_refresh_controls_takes_and_refuses_the_geometries_jax_does(tmp_path):
    """Each ``deskew.json`` through both monitors: the same changed flag,
    the same geometry kept, the same ``state.json``."""
    rings = {name: _ring(Pkg(name))(None, n_slots=2, frame_shape=(4, 4)) for name in PACKAGES}
    try:
        monitors = {name: Pkg(name)("viewer.live").LiveMonitor(rings[name], tmp_path / name)
                    for name in PACKAGES}
        kept = None
        for i, (geo, ok) in enumerate(_deskew_json_cases()):
            want_changed = ok and DeskewSettings(**geo).model_dump() != kept
            kept = DeskewSettings(**geo).model_dump() if ok else kept
            for name, mon in monitors.items():
                path = tmp_path / name / "deskew.json"
                path.write_text(json.dumps(geo))
                os.utime(path, ns=(i + 1, i + 1))  # a new mtime for each case
                assert mon.refresh_controls() == want_changed, (name, geo)
                mon._write_state()
            states = [(tmp_path / name / "state.json").read_text() for name in PACKAGES]
            assert states[0] == states[1], geo
            assert json.loads(states[0])["deskew"] == kept, geo
    finally:
        for r in rings.values():
            r.close()


# -- the two packages on one ring -----------------------------------------------------------

def _feed(ring, volumes):
    """Write (p, t, channel, volume) in turn; returns the feeder's messages."""
    msgs, seq = [], 0
    for p, t, channel, vol in volumes:
        slots = []
        for z in range(vol.shape[0]):
            slots.append(ring.write(seq + z, vol[z]))
        msgs.append({"type": "volume", "t": t, "p": p, "channel": channel, "slots": slots,
                     "seq0": seq, "shape": list(vol.shape)})
        seq += vol.shape[0]
    return msgs


def _volumes(rng, nz=6, shape=(12, 20)):
    return [(p, t, c, (rng.random((nz, *shape), dtype=np.float32) * (100 + 50 * t)))
            for t in range(2) for p in ("0", "1") for c in ("BF", "GFP")]


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]])
def test_one_package_attaches_to_the_other_s_ring(writer, reader, tmp_path, rng):
    """A ring and index written by one package's ``FrameRing`` are attached
    with the other's ``live.attach``; every volume gathers bit-equal."""
    preview = tmp_path / "preview"
    preview.mkdir()
    ring = _ring(Pkg(writer))(None, n_slots=64, frame_shape=(12, 20))
    try:
        vols = _volumes(rng)
        msgs = _feed(ring, vols)
        (preview / "ring.json").write_text(json.dumps({
            "ring": ring.name, "n_slots": 64, "frame_shape": [12, 20], "dtype": "float32"}))
        (preview / "volumes.jsonl").write_text("".join(json.dumps(m) + "\n" for m in msgs))
        live = Pkg(reader)("viewer.live")
        attached, tail = live.attach(preview)
        try:
            got = tail.poll()
            assert got == json.loads(json.dumps(msgs))
            monitor = live.LiveMonitor(attached, tmp_path / "out")
            for msg, (_, _, _, vol) in zip(got, vols):
                np.testing.assert_array_equal(monitor._gather(msg), vol)
            assert monitor.evicted == 0
        finally:
            attached.close()
    finally:
        ring.close()


def _through_monitor(name, tmp_path, vols, controls):
    """Both packages' LiveMonitor over their own ring holding ``vols``: the
    state.json after each control step, and preview planes from the ring."""
    pkg = Pkg(name)
    out = tmp_path / name
    ring = _ring(pkg)(None, n_slots=32, frame_shape=(12, 20))
    try:
        live = pkg("viewer.live")
        settings = pkg("config").DeskewSettings(ls_angle_deg=30.0, px_to_scan_ratio=0.45)
        monitor = live.LiveMonitor(ring, out, deskew=settings, tilt_row=5)
        msgs = _feed(ring, vols)
        states = []
        for i, control in enumerate(controls):
            for file, body in control.items():
                (out / file).write_text(json.dumps(body))
                os.utime(out / file, ns=(i + 1, i + 1))
            for msg in msgs[i * 2:(i + 1) * 2]:
                monitor.on_volume(msg)
            monitor.refresh_controls()
            monitor.render_dirty()
            states.append(json.loads((out / "state.json").read_text()))
        preview = pkg("viewer.deskew_preview")
        planes = [preview.preview_from_ring(ring, msg["slots"], row, monitor.deskew)
                  for msg in msgs[-2:] for row in (0, 5, 11)]
        return states, planes, sorted(p.name for p in out.glob("*.png"))
    finally:
        ring.close()


def test_both_monitors_give_equal_state_and_preview_planes(tmp_path, rng):
    """The same frames and control files through both packages' monitors:
    equal ``state.json`` after every step (follow, scrub, contrast, a
    geometry edit, channel visibility, evictions), bit-equal preview planes
    gathered from the ring, the same PNGs written."""
    vols = _volumes(rng) + _volumes(rng)[:4]
    vols = [(p, t + 2 * (i // 8), c, v) for i, (p, t, c, v) in enumerate(vols)]
    controls = [{}, {"view.json": {"follow": False, "t": 0, "z": 2}},
                {"deskew.json": {"ls_angle_deg": 40.0, "pixel_size_um": 0.116,
                                 "scan_step_um": 0.25}, "view.json": {"follow": True}},
                {"view.json": {"channels": ["GFP"], "contrast": "refresh", "axis": "x"}},
                {"view.json": {"contrast_mode": "auto", "channels": None}},
                {"deskew.json": {"px_to_scan_ratio": 0}}]
    jax_run = _through_monitor("shrimpy_tpu", tmp_path, vols, controls)
    port_run = _through_monitor("shrimpy_tpu_torch", tmp_path, vols, controls)
    assert jax_run[0] == port_run[0]
    assert jax_run[0][-1]["evicted"] > 0 and jax_run[0][2]["deskew"]["px_to_scan_ratio"] == 0.464
    for a, b in zip(jax_run[1], port_run[1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert jax_run[2] == port_run[2] and jax_run[2]


def test_namespace_geometry_previews_as_the_model_does(rng):
    """``deskew_preview_plane`` with the port's namespaces gives the bits of
    JAX's with the pydantic model, the ratio derived alike."""
    from shrimpy_tpu.viewer.deskew_preview import deskew_preview_plane as jax_plane
    from shrimpy_tpu_torch.viewer.deskew_preview import deskew_preview_plane

    rows = rng.random((37, 24), dtype=np.float32)
    for fields in ({"px_to_scan_ratio": 0.386}, {"pixel_size_um": 0.116, "scan_step_um": 0.3}):
        want = jax_plane(rows, DeskewSettings(**fields))
        for ns in (tconfig.deskew_settings(**fields), tconfig.deskew_geometry(**fields)):
            np.testing.assert_array_equal(deskew_preview_plane(rows, ns), want)
    with pytest.raises(ValueError, match="px_to_scan_ratio is not set"):
        deskew_preview_plane(rows, tconfig.deskew_settings())


# -- the card's host -------------------------------------------------------------------------

def test_smoke_cuts_the_viewer_raw_to_what_dev_shm_holds():
    """``chip_smoke.viewer_raw``: the production raw where /dev/shm holds its
    ring (the feeder's floor of n_z + 1 frames and their sequence words) in
    nine tenths of its free bytes, else the deepest raw whose ring does."""
    import chip_smoke
    from shrimpy_tpu_torch.viewer.feeder import ViewerFeeder

    frame = chip_smoke.RAW_SHAPE[1] * chip_smoke.RAW_SHAPE[2] * 4
    assert chip_smoke.viewer_raw(10**12) == chip_smoke.RAW_SHAPE
    for free in (64 << 20, 1 << 30, int(1.9e9)):
        n_z = chip_smoke.viewer_raw(free)[0]
        assert chip_smoke.viewer_raw(free)[1:] == chip_smoke.RAW_SHAPE[1:]
        feeder = ViewerFeeder(frame_shape=chip_smoke.RAW_SHAPE[1:], cache_mb=0.0, n_z=n_z)
        assert feeder.n_slots == n_z + 1
        assert feeder.n_slots * (frame + 8) <= 0.9 * free < (n_z + 2) * (frame + 8)
    assert chip_smoke.viewer_raw(64 << 20)[0] == 35


def test_viewer_runs_without_pydantic_yaml_matplotlib_click_tensorstore(tmp_path):
    """With pydantic, yaml, matplotlib, click and tensorstore unimportable, the
    port's viewer imports, its feeder publishes through a ring, and a
    ``LiveMonitor`` with a namespace geometry runs ``refresh_controls`` (a
    ``deskew.json`` edit) and ``render_dirty``: ``state.json`` is written
    with the contrast and geometry, and the only record the monitor logs is
    matplotlib's ``ImportError``."""
    code = textwrap.dedent("""
        import sys
        for name in ("pydantic", "yaml", "matplotlib", "click", "tensorstore"):
            sys.modules[name] = None
        import json, logging, queue
        from pathlib import Path
        import numpy as np
        from shrimpy_tpu_torch import config
        from shrimpy_tpu_torch.viewer import ViewerFeeder
        from shrimpy_tpu_torch.viewer.deskew_preview import preview_from_ring
        from shrimpy_tpu_torch.viewer.live import LiveMonitor, attach
        import shrimpy_tpu_torch.viewer.web

        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record)

        logging.getLogger("shrimpy_tpu_torch.viewer.live").addHandler(Keep())
        out = Path(sys.argv[1])
        feeder = ViewerFeeder(frame_shape=(8, 16), cache_mb=0.001, preview_dir=out, n_z=3)
        feeder.preview_dir.mkdir(parents=True, exist_ok=True)
        from shrimpy_tpu_torch.viewer.ring import FrameRing
        feeder.ring = FrameRing(None, n_slots=feeder.n_slots, frame_shape=(8, 16))
        (out / "ring.json").write_text(json.dumps({"ring": feeder.ring.name,
            "n_slots": feeder.n_slots, "frame_shape": [8, 16], "dtype": "float32"}))
        feeder._queue = queue.Queue(maxsize=4)
        vol = np.arange(3 * 8 * 16, dtype=np.float32).reshape(3, 8, 16)
        feeder.on_volume(vol, 0, "0", "BF")
        assert feeder.ring._lib is not None and feeder.dropped == 0
        ring, tail = attach(out)
        monitor = LiveMonitor(ring, out, deskew=config.deskew_settings(px_to_scan_ratio=0.5))
        for msg in tail.poll():
            monitor.on_volume(msg)
        (out / "deskew.json").write_text('{"ls_angle_deg": 35.0, "px_to_scan_ratio": 0.25}')
        assert monitor.refresh_controls()
        assert monitor.render_dirty() == 0
        state = json.loads((out / "state.json").read_text())
        assert state["deskew"]["ls_angle_deg"] == 35.0, state
        assert state["contrast"]["BF"] == list(np.percentile(vol, [1.0, 99.7])), state
        assert state["displayed"] == {}, state
        plane = preview_from_ring(ring, [0, 1, 2], 4, monitor.deskew)
        assert plane.shape == (9, 16)
        assert [r.levelname for r in records] == ["ERROR"], records
        assert issubclass(records[0].exc_info[0], ImportError), records[0].exc_info
        assert "matplotlib" in str(records[0].exc_info[1])
        for name in ("pydantic", "yaml", "matplotlib", "click", "tensorstore"):
            assert sys.modules[name] is None, name
        ring.close()
        feeder.ring.close()
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "preview")],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
