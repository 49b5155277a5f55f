"""Browser surface for the live monitor — the graphical viewer.

The reference ships an interactive napari GUI (reference
``shrimpy/viewer/_napari_process.py:53-515`` and
``shrimpy/widgets/mantis_acquisition_widget.py``): follow-latest with a
scrubbable time slider, a Home button to resume following, per-channel
contrast, and an editable deskew-geometry panel that re-renders the
side view live. A headless GPU host has no Qt, so this module serves the
same controls to any browser over HTTP instead — a thin graphical skin
over the monitor's file protocol:

* the page polls ``/state`` (``state.json``) and ``/images`` and shows
  the monitor's rendered PNGs, refreshing only when a file's mtime
  moves;
* the Follow checkbox / timepoint slider POST ``/view`` which writes
  ``view.json`` — exactly what a user could do by hand, so scripts and
  the browser never fight over a private channel;
* the deskew panel POSTs ``/deskew`` → ``deskew.json``;
* "re-stretch contrast" POSTs ``{"contrast": "refresh"}``.

The server binds localhost by default and is stdlib-only
(``http.server``): nothing to install on a pod, works through an SSH
port-forward, and the files remain the source of truth — killing the
server loses nothing.

A copy of the JAX package's server; its plan editor (yaml, pydantic) and
run-control buttons reach the port's ``engine.plan``, ``engine.control``
and ``engine.replay``, imported where they are used.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import unquote

from shrimpy_tpu_torch.utils.fileio import atomic_write_text

logger = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>shrimpy-tpu monitor</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1rem; background: #111;
         color: #ddd; }
  h1 { font-size: 1.1rem; font-weight: 600; }
  .controls { display: flex; gap: 1.5rem; align-items: center;
              flex-wrap: wrap; padding: .6rem .8rem; background: #1c1c1c;
              border-radius: 8px; margin-bottom: 1rem; }
  .controls label { display: flex; gap: .4rem; align-items: center; }
  input[type=number] { width: 5.5rem; background: #111; color: #ddd;
                       border: 1px solid #444; border-radius: 4px;
                       padding: .15rem .3rem; }
  button { background: #2a4d69; color: #eee; border: 0; border-radius: 4px;
           padding: .3rem .7rem; cursor: pointer; }
  button:hover { background: #36618a; }
  .imgs { display: flex; flex-wrap: wrap; gap: 1rem; }
  .imgs figure { margin: 0; }
  .imgs img { max-width: 640px; border-radius: 6px; background: #000; }
  figcaption { font-size: .8rem; color: #999; padding-top: .2rem; }
  #state { font-family: monospace; font-size: .75rem; color: #8a8;
           white-space: pre-wrap; }
</style>
</head>
<body>
<h1>shrimpy-tpu live monitor</h1>
<div class="controls">
  <label><input type="checkbox" id="follow" checked> follow latest</label>
  <label>t <input type="number" id="t" min="0" value="0"></label>
  <label>axis <select id="axis">
    <option value="z" selected>z</option>
    <option value="y">y</option>
    <option value="x">x</option>
  </select></label>
  <label>slice <input type="number" id="z" min="0" placeholder="mid"></label>
  <button id="apply">apply</button>
  <button id="home">home (follow)</button>
  <button id="restretch">re-stretch contrast</button>
  <label><input type="checkbox" id="autoc"> auto-contrast</label>
  <label>angle <input type="number" id="angle" step="0.5"></label>
  <label>px/scan <input type="number" id="ratio" step="0.001"></label>
  <button id="geom">set geometry</button>
  <span id="chanbox" style="display:flex; gap:.6rem;"></span>
  <span id="mode-note" style="color:#c96"></span>
</div>
<div class="controls" id="runbox">
  <span>acquisition:</span>
  <button id="pause">pause</button>
  <button id="resume">resume</button>
  <button id="abort" style="background:#6b2a2a">abort</button>
  <span id="run-note" style="color:#c96"></span>
</div>
<div class="controls" id="planbox" style="display:none; flex-direction:column;
     align-items:stretch;">
  <div style="display:flex; gap:.8rem; align-items:center;">
    <span>plan: <code id="plan-path"></code></span>
    <button id="plan-validate">validate</button>
    <button id="plan-save">validate &amp; save</button>
    <button id="plan-reload">reload</button>
    <span id="plan-note" style="color:#c96"></span>
  </div>
  <textarea id="plan-text" rows="14" spellcheck="false"
    style="width:100%; background:#0d0d0d; color:#cdc; border:1px solid #444;
           border-radius:4px; font-family:monospace; font-size:.8rem;
           margin-top:.4rem;"></textarea>
  <pre id="plan-problems" style="color:#d77; font-size:.75rem;
       white-space:pre-wrap; margin:.3rem 0 0;"></pre>
</div>
<div class="imgs" id="imgs"></div>
<div id="state"></div>
<script>
const mtimes = {};
let liveMode = false;
// Store-mode monitor renders progress previews only; the scrub/
// contrast/geometry control files are read by `monitor --live` alone,
// so a non-live server greys the controls out instead of accepting
// clicks that change nothing.
fetch("/meta").then(r => r.json()).then(meta => {
  liveMode = !!meta.live;
  if (!meta.live) {
    for (const id of ["follow", "t", "axis", "z", "apply", "home",
                      "restretch", "autoc", "angle", "ratio", "geom"])
      document.getElementById(id).disabled = true;
    document.getElementById("mode-note").textContent =
      "store mode: interactive controls need `monitor --live`";
  }
  if (!meta.run_control) {
    for (const id of ["pause", "resume", "abort"])
      document.getElementById(id).disabled = true;
    document.getElementById("run-note").textContent =
      "no running acquisition attached (run_control.json not found)";
  }
  if (meta.plan) {
    document.getElementById("planbox").style.display = "flex";
    loadPlan();
  }
});
async function loadPlan() {
  const p = await (await fetch("/plan")).json();
  document.getElementById("plan-path").textContent = p.path;
  document.getElementById("plan-text").value = p.text;
  document.getElementById("plan-problems").textContent = "";
  document.getElementById("plan-note").textContent = "";
}
async function planPost(url) {
  const r = await fetch(url, {method: "POST", body: JSON.stringify(
    {text: document.getElementById("plan-text").value})});
  const body = await r.json();
  document.getElementById("plan-problems").textContent =
    (body.problems || []).join("\\n");
  document.getElementById("plan-note").textContent =
    body.saved ? "saved" : (body.valid ? "valid" : "invalid");
}
document.getElementById("plan-validate").onclick = () =>
  planPost("/plan/validate");
document.getElementById("plan-save").onclick = () => planPost("/plan/save");
document.getElementById("plan-reload").onclick = loadPlan;
document.getElementById("pause").onclick = () =>
  post("/run", {command: "pause"});
document.getElementById("resume").onclick = () =>
  post("/run", {command: "run"});
document.getElementById("abort").onclick = () => {
  if (confirm("Abort the running acquisition? Volumes written so far " +
              "are kept; the run cannot be resumed."))
    post("/run", {command: "abort"});
};
async function post(url, body) {
  await fetch(url, {method: "POST", body: JSON.stringify(body)});
}
function viewBody() {
  const zRaw = document.getElementById("z").value;
  const boxes = document.querySelectorAll("#chanbox input");
  // channels omitted (null) until at least one box is UNchecked —
  // "all visible" must keep working before channels are known.
  let channels = null;
  if (boxes.length && [...boxes].some(b => !b.checked))
    channels = [...boxes].filter(b => b.checked).map(b => b.value);
  return {follow: document.getElementById("follow").checked,
          t: parseInt(document.getElementById("t").value || "0"),
          axis: document.getElementById("axis").value,
          z: zRaw === "" ? null : parseInt(zRaw),
          channels: channels,
          contrast_mode: document.getElementById("autoc").checked
            ? "auto" : "freeze"};
}
function syncChannels(state) {
  const box = document.getElementById("chanbox");
  const visible = state.visible_channels;  // null = all visible
  for (const c of state.channels || []) {
    let cb = document.getElementById("chan-" + c);
    if (!cb) {
      const lab = document.createElement("label");
      cb = document.createElement("input");
      cb.type = "checkbox"; cb.value = c;
      cb.id = "chan-" + c;
      // Store mode greys these like every other view control: the
      // control files they write are only read by `monitor --live`.
      cb.disabled = !liveMode;
      cb.onchange = () => { cb.dataset.touched = "1";
                            post("/view", viewBody()); };
      lab.appendChild(cb);
      lab.appendChild(document.createTextNode(c));
      box.appendChild(lab);
      // Seed from the monitor's CURRENT visibility so a page (re)load
      // while channels are hidden doesn't silently unhide them on the
      // next apply.
      cb.checked = visible === null || visible === undefined
        || visible.includes(c);
    } else if (!cb.dataset.touched) {
      // Keep following external view.json edits until the user
      // touches this box in THIS page.
      cb.checked = visible === null || visible === undefined
        || visible.includes(c);
    }
  }
}
document.getElementById("apply").onclick = () => post("/view", viewBody());
document.getElementById("home").onclick = () => {
  document.getElementById("follow").checked = true;
  post("/view", {follow: true});
};
document.getElementById("restretch").onclick = () =>
  post("/view", Object.assign(viewBody(), {contrast: "refresh"}));
document.getElementById("autoc").onchange = () =>
  post("/view", viewBody());
document.getElementById("geom").onclick = () => {
  const a = parseFloat(document.getElementById("angle").value);
  const r = parseFloat(document.getElementById("ratio").value);
  if (!isNaN(a) && !isNaN(r))
    post("/deskew", {ls_angle_deg: a, px_to_scan_ratio: r});
};
async function tick() {
  try {
    const imgs = await (await fetch("/images")).json();
    const box = document.getElementById("imgs");
    // Drop figures whose PNG disappeared (hidden channel layers).
    const names = new Set(imgs.map(i => i.name));
    for (const fig of [...box.children])
      if (!names.has(fig.id.slice(4))) { fig.remove();
        delete mtimes[fig.id.slice(4)]; }
    for (const {name, mtime} of imgs) {
      let fig = document.getElementById("fig-" + name);
      if (!fig) {
        fig = document.createElement("figure");
        fig.id = "fig-" + name;
        const im = document.createElement("img");
        const cap = document.createElement("figcaption");
        cap.textContent = name;
        fig.appendChild(im); fig.appendChild(cap);
        box.appendChild(fig);
      }
      if (mtimes[name] !== mtime) {
        mtimes[name] = mtime;
        fig.querySelector("img").src = "/img/" + name + "?v=" + mtime;
      }
    }
    const state = await (await fetch("/state")).json();
    syncChannels(state);
    document.getElementById("state").textContent =
      JSON.stringify(state, null, 1);
  } catch (e) { /* server gone or not ready; keep polling */ }
  setTimeout(tick, 1000);
}
tick();
</script>
</body>
</html>
"""


# Shared atomic-publication helper (utils/fileio.py): handler threads
# run concurrently (ThreadingHTTPServer), and readers poll these files.
_atomic_write = atomic_write_text


class _Handler(BaseHTTPRequestHandler):
    # The serving directory rides on the server object (one handler
    # class per server instance would leak; an attribute does not).
    server: "MonitorWebServer"

    def log_message(self, fmt, *args):  # route http.server chatter to logging
        logger.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        root = self.server.out_dir
        if path == "/":
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif path == "/meta":
            self._send_json({
                "live": self.server.live,
                "run_control": self.server.run_control is not None,
                "plan": self.server.plan_path is not None,
            })
        elif path == "/plan":
            # The attached plan YAML for the browser editor (reference
            # widget round-trips its UI state to YAML,
            # mantis_acquisition_widget.py:685-788).
            if self.server.plan_path is None:
                self._send_json({"error": "no plan attached"}, 404)
                return
            try:
                text = self.server.plan_path.read_text()
            except OSError as e:
                self._send_json({"error": str(e)}, 404)
                return
            self._send_json(
                {"path": str(self.server.plan_path), "text": text}
            )
        elif path == "/state":
            try:
                self._send(
                    200,
                    (root / "state.json").read_bytes(),
                    "application/json",
                )
            except OSError:
                self._send_json({})
        elif path == "/images":
            imgs = []
            for p in sorted(root.glob("*.png")):
                try:
                    imgs.append({"name": p.name, "mtime": p.stat().st_mtime})
                except OSError:
                    continue  # unlinked between glob and stat (eviction)
            self._send_json(imgs)
        elif path.startswith("/img/"):
            # Browsers percent-encode names (the listing is used
            # verbatim in the <img> URL), so decode before the checks.
            name = unquote(path[len("/img/"):])
            # Serve only flat PNG names out of out_dir — no traversal.
            if "/" in name or name != Path(name).name or not name.endswith(".png"):
                self._send_json({"error": "bad name"}, 404)
                return
            try:
                self._send(200, (root / name).read_bytes(), "image/png")
            except OSError:
                self._send_json({"error": "not found"}, 404)
        else:
            self._send_json({"error": "not found"}, 404)

    def _validate_plan_text(self, text: str) -> list[str]:
        """Problems for a candidate plan YAML — the same checks as
        ``plan validate`` (engine.plan.validate_plan), against the
        attached store when the server has one."""
        import yaml as _yaml

        from shrimpy_tpu_torch.engine.plan import AcquisitionPlan, validate_plan

        try:
            plan = AcquisitionPlan(**(_yaml.safe_load(text) or {}))
        except Exception as e:
            return [f"invalid plan: {e}"]
        try:
            source = self.server.plan_source()
        except Exception as e:
            return [f"store {self.server.plan_store}: {e}"]
        return validate_plan(plan, source)

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        targets = {"/view": "view.json", "/deskew": "deskew.json"}
        if path not in targets and path not in (
            "/run", "/plan/validate", "/plan/save"
        ):
            self._send_json({"error": "not found"}, 404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            # Control bodies are tiny JSON objects; a huge (or negative)
            # Content-Length would buffer arbitrary bytes into memory /
            # block the handler thread.
            if not 0 <= n <= 65536:
                raise ValueError("control body too large")
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("control body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._send_json({"error": str(e)}, 400)
            return
        if path in ("/plan/validate", "/plan/save"):
            # Browser plan editor: validate a candidate YAML with the
            # `plan validate` checks; save only validates clean (the
            # reference widget refuses to start on invalid settings).
            if self.server.plan_path is None:
                self._send_json({"error": "no plan attached"}, 409)
                return
            text = body.get("text")
            if not isinstance(text, str):
                self._send_json({"error": "body needs a 'text' string"}, 400)
                return
            problems = self._validate_plan_text(text)
            if path == "/plan/validate":
                self._send_json(
                    {"valid": not problems, "problems": problems}
                )
                return
            if problems:
                self._send_json(
                    {"valid": False, "saved": False, "problems": problems},
                    422,
                )
                return
            _atomic_write(self.server.plan_path, text)
            self._send_json({"valid": True, "saved": True, "problems": []})
            return
        if path == "/run":
            # Pause/resume/abort the attached acquisition by writing
            # its run_control.json (engine/control.py protocol).
            if self.server.run_control is None:
                self._send_json({"error": "no acquisition attached"}, 409)
                return
            from shrimpy_tpu_torch.engine.control import COMMANDS

            if body.get("command") not in COMMANDS:
                self._send_json(
                    {"error": f"command must be one of {list(COMMANDS)}"}, 400
                )
                return
            _atomic_write(
                self.server.run_control,
                json.dumps({"command": body["command"]}),
            )
            self._send_json({"ok": True})
            return
        _atomic_write(self.server.out_dir / targets[path], json.dumps(body))
        self._send_json({"ok": True})


class MonitorWebServer(ThreadingHTTPServer):
    """Serve a monitor preview directory to browsers.

    ``port=0`` picks an ephemeral port; read it back from ``.port``
    after construction. ``start()`` serves on a daemon thread.
    """

    daemon_threads = True

    def __init__(self, out_dir: str | Path, host: str = "127.0.0.1",
                 port: int = 0, *, live: bool = True,
                 run_control: str | Path | None = None,
                 plan_path: str | Path | None = None,
                 plan_store: str | Path | None = None):
        self.out_dir = Path(out_dir)
        # Store-mode monitors never read the control files; the page
        # greys its controls out when this is False.
        self.live = live
        # Target of the pause/resume/abort buttons: a running
        # acquisition's run_control.json (engine/control.py). None
        # greys those buttons out (nothing to control).
        self.run_control = Path(run_control) if run_control else None
        # Plan the browser editor round-trips (edit -> validate ->
        # save); validation cross-checks against plan_store when given
        # (the `plan validate --input` tier). None hides the editor.
        self.plan_path = Path(plan_path) if plan_path else None
        self.plan_store = Path(plan_store) if plan_store else None
        self._plan_source = None
        super().__init__((host, port), _Handler)
        self._thread: threading.Thread | None = None

    def plan_source(self):
        """Lazily-opened (and cached) ReplaySource for plan validation:
        re-opening the store (full metadata scan) on every validate/
        save click would pay seconds of redundant IO on large plates.
        None when no store is attached."""
        if self.plan_store is not None and self._plan_source is None:
            from shrimpy_tpu_torch.engine.replay import ReplaySource

            self._plan_source = ReplaySource(self.plan_store)
        return self._plan_source

    @property
    def port(self) -> int:
        return self.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.server_address[0]}:{self.port}/"

    def start(self) -> "MonitorWebServer":
        self._thread = threading.Thread(
            target=self.serve_forever, name="monitor-web", daemon=True
        )
        self._thread.start()
        logger.info("monitor web UI at %s", self.url)
        return self

    def stop(self) -> None:
        self.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.server_close()
