"""Headless live monitor with the reference napari viewer's behaviors.

The reference runs an interactive napari process with follow-latest
auto-advance + user-scrub pause (reference
``shrimpy/viewer/_napari_process.py:293-329``), per-channel
auto-contrast (``:416-433``), volume-granularity eviction so a
half-overwritten stack is never rendered (``:358-385``), and a live
deskew preview with editable geometry (``:202-291``). On a headless GPU
host there is no Qt event loop, so those behaviors are re-created over
files:

* the feeder writes a ring descriptor (``ring.json``) and an
  append-only volume index (``volumes.jsonl``) next to the previews, so
  ANY process can attach to a running acquisition — the file-based
  equivalent of the reference's queue + shared-memory pair;
* ``view.json`` is the scrub control: ``{"follow": false, "t": 2}``
  pins the displayed timepoint (the user grabbing the time slider);
  ``{"follow": true}`` resumes auto-advance (the Home key, ``:293-329``);
  ``{"z": 40}`` scrubs the rendered z plane (napari's z slider over the
  lazy (p,t,z,y,x) array, ``:293-329``) — omit/null restores the
  mid-plane default;
* ``deskew.json`` is the editable-geometry control: changing
  ``ls_angle_deg`` / ``px_to_scan_ratio`` re-renders the deskewed side
  view from ring row-gathers without waiting for new frames
  (``DeskewControls``, ``:236-242``).

Rendered state also lands in ``state.json`` (selected timepoints,
contrast limits, evictions) so the behaviors are scriptable/testable
without parsing PNGs.

The JAX package's monitor, statement for statement, but for three named
differences that let it run where pydantic is not installed (the card's
host), each pinned by ``tests/test_torch_viewer.py``:

* no module-level import of ``config.schemas``: ``deskew`` is annotated
  by name only, and takes a pydantic ``DeskewSettings`` or a namespace
  (``config.deskew_settings``, ``config.deskew_geometry``) alike;
* ``refresh_controls`` builds ``deskew.json``'s geometry with
  ``config.deskew_geometry(**geo)``, which rejects what
  ``DeskewSettings(**geo)`` rejects and keeps what it keeps, and reads
  the ratio with ``config.require_ratio(new)``;
* ``_write_state`` dumps the geometry with ``config._dump``, pydantic's
  ``model_dump`` for a model and a namespace alike, so ``state.json`` is
  the JAX monitor's.

matplotlib is imported where a PNG is drawn, as in the JAX package: where
it is missing, a render logs its ``ImportError`` and ``state.json`` is
still written.
"""

from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.config import _dump, deskew_geometry, require_ratio
from shrimpy_tpu_torch.utils.fileio import atomic_write_text
from shrimpy_tpu_torch.viewer.deskew_preview import deskew_preview_plane
from shrimpy_tpu_torch.viewer.ring import FrameRing

logger = logging.getLogger(__name__)


def _slug(s: str) -> str:
    """Filesystem/URL-safe name fragment for preview filenames."""
    return re.sub(r"[^A-Za-z0-9._-]", "_", s)


# Channel-name substring -> display colormap; first match wins, default
# gray (reference ``_napari_process.py:447-460`` maps gfp/fitc ->
# green, mcherry/rhodamine -> magenta, dapi -> blue). matplotlib has no
# black-to-single-color maps built in, so they are constructed once.
_CHANNEL_COLORMAPS: tuple[tuple[tuple[str, ...], str, tuple], ...] = (
    (("gfp", "fitc"), "shrimpy_green", (0.0, 1.0, 0.0)),
    (("mcherry", "rhodamine"), "shrimpy_magenta", (1.0, 0.0, 1.0)),
    (("dapi",), "shrimpy_blue", (0.2, 0.4, 1.0)),
)


def colormap_for_channel(name: str):
    """matplotlib colormap for a channel name (case-insensitive
    substring match, reference ``_napari_process.py:454-460``)."""
    from matplotlib.colors import LinearSegmentedColormap

    lowered = name.lower()
    for keys, cmap_name, rgb in _CHANNEL_COLORMAPS:
        if any(k in lowered for k in keys):
            return LinearSegmentedColormap.from_list(
                cmap_name, [(0.0, 0.0, 0.0), rgb]
            )
    return "gray"


class LiveMonitor:
    """Render live previews from a frame ring + volume messages."""

    def __init__(
        self,
        ring: FrameRing,
        out_dir: str | Path,
        *,
        deskew: "DeskewSettings | None" = None,
        tilt_row: int | None = None,
    ):
        self.ring = ring
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.deskew = deskew
        self.tilt_row = tilt_row
        # Volume index: (p, channel) -> {t -> msg}.
        self._volumes: dict[tuple[str, str], dict[int, dict]] = {}
        self.follow = True
        self.pinned_t: int | None = None
        # Slice scrub: None renders the mid-plane; an int pins that
        # plane (clamped per volume) — napari's slider equivalent.
        # ``slice_axis`` picks WHICH axis is sliced (napari scrubs any
        # axis of the (p, t, z, y, x) array,
        # reference _napari_process.py:293-329).
        self.pinned_z: int | None = None
        self.slice_axis: str = "z"
        # Per-channel layer visibility (napari's layer toggles): None =
        # all channels; hidden layers' PNGs are removed so the browser
        # listing drops them.
        self.visible_channels: list[str] | None = None
        # Per-channel contrast limits, frozen at first render so
        # brightness stays comparable across timepoints (reference
        # auto-contrasts per channel, _napari_process.py:416-433).
        # contrast_mode "auto" opts back into the reference's
        # per-update re-stretch (view.json {"contrast_mode": "auto"}).
        self.contrast: dict[str, tuple[float, float]] = {}
        self.contrast_mode = "freeze"
        self._dirty: set[tuple[str, str]] = set()
        self._controls_mtime: dict[str, float] = {}
        self._last_drawn: dict[str, int] = {}
        self.evicted = 0

    # -- intake ----------------------------------------------------------------
    def on_volume(self, msg: dict) -> None:
        """Index a feeder volume message and mark its layer dirty."""
        key = (str(msg["p"]), str(msg["channel"]))
        self._volumes.setdefault(key, {})[int(msg["t"])] = msg
        self._dirty.add(key)

    # -- controls ----------------------------------------------------------------
    def refresh_controls(self) -> bool:
        """Re-read view.json / deskew.json; True if anything changed."""
        changed = False
        view = self._read_control("view.json")
        if view is not None:
            try:
                # view.json is hand-editable: a malformed-but-valid-JSON
                # value ({"t": "2 "} / {"t": [2]}) must not kill the
                # monitor loop.
                follow = bool(view.get("follow", True))
                pinned = view.get("t")
                pinned = int(pinned) if pinned is not None else None
                pinned_z = view.get("z")
                pinned_z = int(pinned_z) if pinned_z is not None else None
                axis = view.get("axis", "z")
                if axis not in ("z", "y", "x"):
                    raise ValueError(f"axis must be z/y/x, got {axis!r}")
                chans = view.get("channels")
                if chans is not None:
                    chans = [str(c) for c in chans]
            except (TypeError, ValueError):
                logger.warning("invalid view.json values (ignored): %r", view)
            else:
                if (follow, pinned, pinned_z, axis, chans) != (
                    self.follow, self.pinned_t, self.pinned_z,
                    self.slice_axis, self.visible_channels,
                ):
                    self.follow = follow
                    self.pinned_t = pinned
                    self.pinned_z = pinned_z
                    self.slice_axis = axis
                    self.visible_channels = chans
                    changed = True
            # ``{"contrast": "refresh"}`` drops the frozen limits so the
            # next render re-stretches per channel — the knob for the
            # deliberate divergence from the reference's per-update
            # auto-contrast (``_napari_process.py:416-433``, PARITY.md).
            if view.get("contrast") == "refresh" and self.contrast:
                self.contrast.clear()
                changed = True
            # ``{"contrast_mode": "auto"}`` re-stretches EVERY render —
            # the reference's default behavior; "freeze" (our default)
            # restores comparable-across-t limits.
            mode = view.get("contrast_mode")
            if mode in ("auto", "freeze") and mode != self.contrast_mode:
                self.contrast_mode = mode
                self.contrast.clear()
                changed = True
        geo = self._read_control("deskew.json")
        if geo is not None:
            try:
                new = deskew_geometry(**geo)
                ratio = require_ratio(new)  # must be renderable
                if not ratio >= 1e-3:
                    # (ns-1)/ratio sizes the preview grid: a near-zero
                    # ratio means an OverflowError or a multi-GB alloc
                    # on every render.
                    raise ValueError(
                        f"px_to_scan_ratio {ratio} too small to preview"
                    )
            except Exception:
                logger.exception("invalid deskew.json (ignored)")
            else:
                if self.deskew is None or new != self.deskew:
                    self.deskew = new
                    changed = True
        if changed:
            self._dirty.update(self._volumes)
        return changed

    def _read_control(self, name: str) -> dict | None:
        path = self.out_dir / name
        try:
            mtime = path.stat().st_mtime
        except FileNotFoundError:
            return None
        if self._controls_mtime.get(name) == mtime:
            return None
        self._controls_mtime[name] = mtime
        try:
            return json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            logger.warning("unreadable control file %s (ignored)", path)
            return None

    # -- selection ----------------------------------------------------------------
    def _select_t(self, key: tuple[str, str]) -> int | None:
        """Displayed timepoint for a layer: pinned scrub or latest."""
        ts = self._volumes.get(key)
        if not ts:
            return None
        if not self.follow and self.pinned_t is not None:
            # Scrub-pause: show the pinned timepoint if that volume is
            # known; a t the layer never had falls back to its nearest
            # earlier one (napari clamps the slider the same way).
            candidates = [t for t in ts if t <= self.pinned_t]
            return max(candidates) if candidates else min(ts)
        return max(ts)

    def _gather(self, msg: dict) -> np.ndarray | None:
        """Volume planes from the ring; None if any slot was evicted.

        Volume-granularity eviction (reference ``:358-385``): each slot
        carries the global sequence it was written with; a mismatch
        means the ring lapped this volume and it must not be rendered.
        """
        slots = msg["slots"]
        seq0 = msg.get("seq0")
        planes = []
        for i, slot in enumerate(slots):
            seq, frame = self.ring.read(slot)
            if seq0 is not None and seq != seq0 + i:
                self.evicted += 1
                return None
            planes.append(frame)
        return np.stack(planes)

    # -- render ----------------------------------------------------------------
    def render_dirty(self) -> int:
        """Render all dirty layers; returns how many were drawn.

        Per-layer isolation: one bad render (bad geometry, filesystem
        error) must not starve the other layers or leave ``state.json``
        stale; the failing layer is logged and retried next time it
        dirties. ``state.json`` is rewritten only when there was work —
        an idle monitor must not churn the disk every poll tick.
        """
        if not self._dirty:
            return 0
        n = 0
        for key in sorted(self._dirty):
            try:
                if self._render_layer(key):
                    n += 1
            except Exception:
                logger.exception("render failed for layer %s (skipped)", key)
        self._dirty.clear()
        self._write_state()
        return n

    def _render_layer(self, key: tuple[str, str]) -> bool:
        p, channel = key
        if (
            self.visible_channels is not None
            and channel not in self.visible_channels
        ):
            # Hidden layer (napari layer-visibility toggle): remove its
            # published PNG so the browser listing drops the figure.
            png = self.out_dir / (
                f"live_p{_slug(str(p))}_{_slug(channel)}.png"
            )
            png.unlink(missing_ok=True)
            self._last_drawn.pop(f"{p}|{channel}", None)
            return False
        t = self._select_t(key)
        if t is None:
            return False
        msg = self._volumes[key].get(t)
        vol = self._gather(msg) if msg else None
        if vol is None:
            # Evicted: fall back to the newest still-resident volume
            # (skipping the timepoint that just failed).
            t_failed = t
            for t_alt in sorted(self._volumes[key], reverse=True):
                if t_alt == t_failed:
                    continue
                vol = self._gather(self._volumes[key][t_alt])
                if vol is not None:
                    t = t_alt
                    break
            if vol is None:
                return False
        lo, hi = self._contrast_limits(channel, vol)
        self._draw(p, channel, t, vol, lo, hi)
        self._last_drawn[f"{p}|{channel}"] = t
        return True

    def _plane_index(self, n: int) -> int:
        """Rendered plane along the sliced axis: the scrubbed index
        (clamped to the volume's extent, like napari's slider) or the
        mid-plane."""
        if self.pinned_z is None:
            return n // 2
        return max(0, min(self.pinned_z, n - 1))

    def _contrast_limits(self, channel: str, vol: np.ndarray) -> tuple[float, float]:
        if self.contrast_mode == "auto" or channel not in self.contrast:
            lo, hi = np.percentile(vol, [1.0, 99.7])
            if hi <= lo:
                hi = lo + 1.0
            self.contrast[channel] = (float(lo), float(hi))
        return self.contrast[channel]

    def _draw(self, p, channel, t, vol, lo, hi) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        panels = 2 + (self.deskew is not None)
        fig, axes = plt.subplots(1, panels, figsize=(4 * panels, 4))
        cmap = colormap_for_channel(channel)
        # Arbitrary-plane inspection (napari scrubs every axis of the
        # lazy array, reference _napari_process.py:293-329): slice the
        # selected axis at the scrubbed (or mid) index.
        ax_i = "zyx".index(self.slice_axis)
        zi = self._plane_index(vol.shape[ax_i])
        plane = np.take(vol, zi, axis=ax_i)
        axes[0].imshow(
            plane, cmap=cmap, vmin=lo, vmax=hi,
            aspect="auto" if ax_i else None,
        )
        label = "mid" if self.pinned_z is None else "scrub"
        axes[0].set_title(
            f"p={p} {channel} t={t} {self.slice_axis}={zi} ({label})"
        )
        axes[1].imshow(
            vol.max(axis=ax_i), cmap="magma", vmin=lo, vmax=hi,
            aspect="auto" if ax_i else None,
        )
        axes[1].set_title(f"max projection over {self.slice_axis}")
        if self.deskew is not None:
            row = self.tilt_row if self.tilt_row is not None else vol.shape[1] // 2
            side = deskew_preview_plane(vol[:, row, :], self.deskew)
            axes[2].imshow(side, cmap=cmap, vmin=lo, vmax=hi, aspect="auto")
            axes[2].set_title(
                f"deskew side  angle={self.deskew.ls_angle_deg:.1f}"
            )
        for ax in axes:
            ax.axis("off")
        fig.tight_layout()
        # Channel names routinely carry '/'+spaces (filter specs like
        # 'GFP EX488 EM525/50'): slug BOTH name parts, and publish
        # atomically — the web server read_bytes() the same file while
        # the browser polls, and a mid-savefig read returns a torn PNG.
        final = self.out_dir / f"live_p{_slug(str(p))}_{_slug(channel)}.png"
        tmp = final.with_suffix(".png.tmp")
        fig.savefig(tmp, format="png", dpi=72)
        os.replace(tmp, final)
        plt.close(fig)

    def _write_state(self) -> None:
        state = {
            "follow": self.follow,
            "pinned_t": self.pinned_t,
            "pinned_z": self.pinned_z,
            "slice_axis": self.slice_axis,
            "visible_channels": self.visible_channels,
            "channels": sorted({c for _, c in self._volumes}),
            "contrast": {c: list(v) for c, v in self.contrast.items()},
            "displayed": self._last_drawn,
            "evicted": self.evicted,
            "deskew": _dump(self.deskew) if self.deskew else None,
        }
        # Atomic publish: the web server's GET /state reads this file
        # concurrently (utils/fileio.py).
        atomic_write_text(
            self.out_dir / "state.json", json.dumps(state, indent=2)
        )


class VolumeIndexTail:
    """Incrementally read a feeder's ``volumes.jsonl`` (attach mode)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._offset = 0

    def poll(self) -> list[dict]:
        try:
            with open(self.path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                if size < self._offset:
                    # Truncated/recreated (a new acquisition reused the
                    # directory): restart from the top instead of going
                    # silently blind behind a stale offset.
                    self._offset = 0
                f.seek(self._offset)
                chunk = f.read()
        except FileNotFoundError:
            return []
        # Hold back a torn tail (a line the feeder is mid-append on):
        # the offset advances only past complete lines, so the partial
        # line is re-read WHOLE next poll. Advancing past it would split
        # the line across two polls — each fragment unparseable — and
        # silently lose that volume message.
        nl = chunk.rfind(b"\n")
        if nl < 0:
            return []
        self._offset += nl + 1
        msgs = []
        for line in chunk[: nl + 1].splitlines():
            try:
                msgs.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # genuinely corrupt line (crash mid-write)
        return msgs


def attach(preview_dir: str | Path) -> tuple[FrameRing, VolumeIndexTail]:
    """Attach to a running feeder's ring via its descriptor file."""
    preview_dir = Path(preview_dir)
    desc = json.loads((preview_dir / "ring.json").read_text())
    ring = FrameRing(
        desc["ring"],
        n_slots=desc["n_slots"],
        frame_shape=tuple(desc["frame_shape"]),
        dtype=desc.get("dtype", "float32"),
        create=False,
    )
    return ring, VolumeIndexTail(preview_dir / "volumes.jsonl")
