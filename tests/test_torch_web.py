"""PyTorch port of the browser surface of the live monitor (ROADMAP item 12d)
against the JAX package (CPU).

``shrimpy_tpu_torch/viewer/web.py`` is a copy of ``shrimpy_tpu/viewer/web.py``,
pinned statement for statement in ``tests/test_torch_config.py``
(``COPIES``). Here the JAX tests of it (``tests/test_web.py``: the page, the
state and image endpoints, the control files a POST writes, the run-control
and plan-editor endpoints) run on both packages, each server driven with
urllib; the port's plan editor validates through the port's
``engine.plan`` and ``engine.replay``, its controls reach the port's
``LiveMonitor``, and a page served by each package is the same bytes.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.acq_pkgs import PACKAGES, Pkg

torch.set_num_threads(1)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


def _server(pkg, root, **kw):
    return pkg("viewer.web").MonitorWebServer(root, port=0, **kw).start()


@pytest.fixture()
def server(pkg, tmp_path):
    srv = _server(pkg, tmp_path)
    yield srv, tmp_path
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(srv.url.rstrip("/") + path, timeout=5) as r:
        return r.status, r.read()


def _post(srv, path, body):
    req = urllib.request.Request(srv.url.rstrip("/") + path, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status, json.loads(r.read())


def test_page_and_empty_state(server):
    srv, _ = server
    status, body = _get(srv, "/")
    assert status == 200
    assert b"shrimpy-tpu" in body and b"re-stretch" in body
    status, body = _get(srv, "/state")
    assert status == 200 and json.loads(body) == {}


def test_state_passthrough(server):
    srv, root = server
    (root / "state.json").write_text(json.dumps({"follow": True, "evicted": 2}))
    _, body = _get(srv, "/state")
    assert json.loads(body)["evicted"] == 2


def test_images_listing_and_fetch(server):
    srv, root = server
    png = b"\x89PNG\r\n\x1a\nfakebody"
    (root / "live_p0_GFP.png").write_bytes(png)
    _, body = _get(srv, "/images")
    listing = json.loads(body)
    assert [e["name"] for e in listing] == ["live_p0_GFP.png"]
    assert listing[0]["mtime"] > 0
    _, body = _get(srv, "/img/live_p0_GFP.png")
    assert body == png


def test_img_rejects_traversal_and_non_png(server):
    srv, root = server
    (root / "state.json").write_text("{}")
    for bad in ["/img/../state.json", "/img/state.json", "/img/a%2f..%2fb.png"]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, bad)
        assert e.value.code == 404


def test_post_view_writes_control_file(server):
    srv, root = server
    status, resp = _post(srv, "/view", {"follow": False, "t": 3})
    assert status == 200 and resp == {"ok": True}
    assert json.loads((root / "view.json").read_text()) == {"follow": False, "t": 3}
    _post(srv, "/view", {"follow": True, "contrast": "refresh"})
    assert json.loads((root / "view.json").read_text())["contrast"] == "refresh"


def test_post_deskew_writes_geometry(server):
    srv, root = server
    _post(srv, "/deskew", {"ls_angle_deg": 32.0, "px_to_scan_ratio": 0.4})
    geo = json.loads((root / "deskew.json").read_text())
    assert geo == {"ls_angle_deg": 32.0, "px_to_scan_ratio": 0.4}


def test_post_rejects_bad_bodies(server):
    srv, _ = server
    req = urllib.request.Request(srv.url.rstrip("/") + "/view", data=b"not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/view", ["not", "an", "object"])
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/nope", {})
    assert e.value.code == 404


def test_controls_reach_live_monitor(pkg, server):
    """A browser POST lands where the package's LiveMonitor.refresh_controls
    looks (the port's geometry a namespace)."""
    srv, root = server
    ring = pkg("viewer.ring").FrameRing(None, n_slots=4, frame_shape=(8, 8))
    try:
        mon = pkg("viewer.live").LiveMonitor(ring, root)
        _post(srv, "/view", {"follow": False, "t": 1})
        assert mon.refresh_controls() is True
        assert mon.follow is False and mon.pinned_t == 1
        _post(srv, "/deskew", {"ls_angle_deg": 31.0, "px_to_scan_ratio": 0.39})
        assert mon.refresh_controls() is True
        assert mon.deskew is not None
        assert np.isclose(mon.deskew.ls_angle_deg, 31.0)
    finally:
        ring.close()


def test_meta_reports_live_mode(pkg, tmp_path):
    srv = _server(pkg, tmp_path, live=False)
    try:
        _, body = _get(srv, "/meta")
        assert json.loads(body) == {"live": False, "run_control": False, "plan": False}
    finally:
        srv.stop()
    srv2 = _server(pkg, tmp_path)
    try:
        _, body = _get(srv2, "/meta")
        assert json.loads(body) == {"live": True, "run_control": False, "plan": False}
    finally:
        srv2.stop()


def test_concurrent_posts_never_publish_torn_controls(server):
    srv, root = server
    errors = []

    def hammer(i):
        try:
            for k in range(25):
                _post(srv, "/view", {"follow": bool(k % 2), "t": i * 100 + k})
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    view = json.loads((root / "view.json").read_text())  # must parse
    assert set(view) == {"follow", "t"}
    assert not list(root.glob("view.json.*.tmp"))


def test_run_control_endpoint(pkg, tmp_path):
    target = tmp_path / "out" / "run_control.json"
    target.parent.mkdir()
    srv = _server(pkg, tmp_path, run_control=target)
    try:
        _post(srv, "/view", {})  # warm-up, any POST works
        _, body = _get(srv, "/meta")
        assert json.loads(body)["run_control"] is True
        status, body = _post(srv, "/run", {"command": "pause"})
        assert status == 200 and body == {"ok": True}
        assert json.loads(target.read_text()) == {"command": "pause"}
        _post(srv, "/run", {"command": "abort"})
        assert json.loads(target.read_text()) == {"command": "abort"}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/run", {"command": "explode"})
        assert e.value.code == 400
    finally:
        srv.stop()


def test_run_control_absent_is_409(server):
    srv, _ = server
    _, body = _get(srv, "/meta")
    assert json.loads(body)["run_control"] is False
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/run", {"command": "pause"})
    assert e.value.code == 409


def test_plan_editor_round_trip(pkg, tmp_path):
    plan = tmp_path / "plan.yml"
    plan.write_text("time: {n_timepoints: 2}\n")
    srv = _server(pkg, tmp_path, plan_path=plan)
    try:
        _, body = _get(srv, "/meta")
        assert json.loads(body)["plan"] is True
        _, body = _get(srv, "/plan")
        loaded = json.loads(body)
        assert loaded["path"] == str(plan)
        assert "n_timepoints: 2" in loaded["text"]
        good = "time: {n_timepoints: 5}\n"
        _, v = _post(srv, "/plan/validate", {"text": good})
        assert v == {"valid": True, "problems": []}
        _, s = _post(srv, "/plan/save", {"text": good})
        assert s["saved"] is True
        assert plan.read_text() == good
        bad = "time: {n_timepoints: 5}\nbogus_key: 1\n"
        _, v = _post(srv, "/plan/validate", {"text": bad})
        assert v["valid"] is False and v["problems"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/plan/save", {"text": bad})
        assert e.value.code == 422
        assert plan.read_text() == good
        over = ("channels: [{name: a, exposure_ms: 5}, {name: b, exposure_ms: 5}]\n"
                "z: {n_slices: 601}\n"
                "camera: {model_acquisition: true, mode: labelfree}\n")
        _, v = _post(srv, "/plan/validate", {"text": over})
        assert v["valid"] is False
        assert any("sequenced events" in p for p in v["problems"])
    finally:
        srv.stop()


def test_plan_editor_store_cross_check(pkg, tmp_path):
    pkg("io.synthetic").coordinate_encoded_fov(tmp_path / "src.zarr", shape=(1, 1, 3, 8, 8))
    plan = tmp_path / "plan.yml"
    plan.write_text("{}\n")
    srv = _server(pkg, tmp_path, plan_path=plan, plan_store=tmp_path / "src.zarr")
    try:
        _, v = _post(srv, "/plan/validate", {"text": "channels: [{name: nope, exposure_ms: 5}]\n"})
        assert v["valid"] is False
        assert any("'nope' not in store" in p for p in v["problems"])
        _, v = _post(srv, "/plan/validate", {"text": "{}\n"})
        assert v["valid"] is True
    finally:
        srv.stop()


def test_plan_endpoints_absent_without_plan(server):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/plan")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, "/plan/save", {"text": "{}"})
    assert e.value.code == 409


def test_both_servers_answer_alike(tmp_path):
    """One directory served by each package: the page, the metadata, the
    state, the image listing and a plan's validation are the same bytes."""
    (tmp_path / "state.json").write_text(json.dumps({"follow": True}))
    (tmp_path / "live_p0_BF.png").write_bytes(b"\x89PNG\r\n\x1a\nx")
    plan = tmp_path / "plan.yml"
    plan.write_text("time: {n_timepoints: 2}\n")
    answers = []
    for name in PACKAGES:
        srv = _server(Pkg(name), tmp_path, plan_path=plan)
        try:
            got = [_get(srv, path)[1] for path in ("/", "/meta", "/state", "/images", "/plan")]
            for text in ("time: {n_timepoints: 3}\n", "bogus: 1\n", "z: {n_slices: -1}\n"):
                got.append(_post(srv, "/plan/validate", {"text": text})[1])
            answers.append(got)
        finally:
            srv.stop()
    assert answers[0] == answers[1]
