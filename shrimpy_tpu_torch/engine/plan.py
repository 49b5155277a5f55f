"""Declarative acquisition plans (the useq-schema MDASequence role).

The reference drives acquisitions from YAML ``MDASequence`` plans with
microscope-specific settings under ``metadata.mantis`` (reference
``mantis_engine.py:470``, ``config/mda/mantis/demo.yaml``, SURVEY.md
§5.6). This is the first-party equivalent: a strict pydantic plan with
time/channel/z axes, an autofocus block, and a free-form ``metadata``
dict carrying the ``dynatrack`` config.

The port's own copy of ``shrimpy_tpu/engine/plan.py``, pinned statement for
statement by ``tests/test_torch_config.py`` (``COPIES``); its lazy imports
point into the port's ``io/platemap``, ``engine/autoexposure`` and
``config/schemas``. It needs pydantic and yaml, so nothing the card's compute
path imports loads it: ``engine/__init__.py`` serves its names lazily and
``engine/autofocus.py::DemoAutofocus`` reads an ``AutofocusPlan`` by
attribute.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Literal

import yaml
from pydantic import BaseModel, ConfigDict, Field, model_validator


class TimePlan(BaseModel):
    model_config = ConfigDict(extra="forbid")

    n_timepoints: int = 1
    interval_s: float = 0.0

    @model_validator(mode="after")
    def _check(self):
        if self.n_timepoints < 1:
            raise ValueError("n_timepoints must be >= 1")
        return self


class ChannelPlan(BaseModel):
    """One acquired channel (reference ``mantis.yaml`` ``channels:``).

    ``exposure_ms`` is honored in replay by brightness emulation: the
    served volume is scaled by ``exposure_ms / source_exposure_ms``
    (the source store is defined as recorded at the plan's
    ``source_exposure_ms``), mirroring how a longer exposure collects
    proportionally more photons. Autoexposure results override this
    per position on the autoexposure channel.
    """

    model_config = ConfigDict(extra="forbid")

    name: str
    exposure_ms: float = 10.0

    @model_validator(mode="after")
    def _check(self):
        if not self.exposure_ms > 0:
            raise ValueError("exposure_ms must be > 0")
        return self


class ZPlan(BaseModel):
    """Z-range selection (reference ``mantis.yaml`` ``z_plan:``).

    ``step_um`` selects a strided z subset of the source stack: the
    stride is ``step_um / source_z_scale`` and must be a near-integer
    multiple (replay serves recorded slices; a non-integer stride
    would require resampling data that was never acquired — it errors
    loudly instead). The output store's z scale records ``step_um``.
    ``n_slices`` caps the slice count after striding.
    """

    model_config = ConfigDict(extra="forbid")

    n_slices: int | None = None  # None = full source depth
    step_um: float | None = None  # None = source scale

    @model_validator(mode="after")
    def _check(self):
        if self.step_um is not None and not self.step_um > 0:
            raise ValueError("step_um must be > 0")
        if self.n_slices is not None and self.n_slices < 1:
            raise ValueError("n_slices must be >= 1")
        return self

    def resolve_z_indices(self, src_nz: int, src_z_um: float) -> list[int]:
        """Source z indices to acquire, honoring step + count."""
        if self.step_um is None:
            stride = 1
        else:
            ratio = self.step_um / src_z_um
            stride = int(round(ratio))
            if stride < 1 or abs(ratio - stride) > 1e-3 * max(ratio, 1.0):
                raise ValueError(
                    f"z.step_um={self.step_um} is not an integer multiple "
                    f"of the source z step {src_z_um} (ratio {ratio:.4f}); "
                    "replay serves recorded slices only"
                )
        idx = list(range(0, src_nz, stride))
        if self.n_slices is not None:
            if self.n_slices > len(idx):
                raise ValueError(
                    f"plan z.n_slices={self.n_slices} exceeds the source "
                    f"depth ({len(idx)} slices at step_um={self.step_um})"
                )
            idx = idx[: self.n_slices]
        return idx


class AutofocusPlan(BaseModel):
    """Demo-PFS simulation: configurable success rate and deterministic
    failures (reference ``mantis_engine.py:348-386``)."""

    model_config = ConfigDict(extra="forbid")

    enabled: bool = False
    success_rate: float = 1.0
    fail_at_indices: list[int] | None = None  # flat (t * n_pos + p) indices
    seed: int = 0

    @model_validator(mode="after")
    def _check(self):
        if not 0.0 <= self.success_rate <= 1.0:
            # success_rate: 90 (meaning 90%) would silently disable the
            # demo-failure feature (rng.random() < 90 is always true).
            raise ValueError(
                f"success_rate must be in [0, 1], got {self.success_rate}"
            )
        if not self.enabled and (
            self.fail_at_indices is not None or self.success_rate != 1.0
        ):
            # Declared failure behavior with the feature off would be
            # silently inert (engage() returns True unconditionally).
            raise ValueError(
                "autofocus failure settings (fail_at_indices / "
                "success_rate) require enabled: true"
            )
        return self


class RefocusPlan(BaseModel):
    """Periodic remote-refocus (the archived O3 routine, reference
    archive ``acq_engine.py:892-1151``): every ``interval_timepoints``,
    find the in-focus slice of the acquired stack by the midband
    spectral metric and re-center the z offset on it."""

    model_config = ConfigDict(extra="forbid")

    enabled: bool = False
    interval_timepoints: int = 1
    channel: str | None = None  # None = the first acquired channel

    @model_validator(mode="after")
    def _check(self):
        if self.interval_timepoints < 1:
            raise ValueError("interval_timepoints must be >= 1")
        return self

    wavelength_um: float = 0.55
    na_det: float = 1.35
    threshold: float = 0.0  # metric prominence gate (0 = always accept)


class AutoexposurePlan(BaseModel):
    """Per-well autoexposure (archived production parity, reference
    archive ``autoexposure.py:22-285`` + per-well bookkeeping
    ``acq_engine.py:713-720``)."""

    model_config = ConfigDict(extra="forbid")

    enabled: bool = False
    algorithm: str = "intensity_percentile"  # or mean_intensity /
    # masked_mean_intensity / manual
    channel: str | None = None  # None = first acquired channel
    manual_csv: str | None = None  # well -> (exposure, power) table
    settings: dict = Field(default_factory=dict)  # AutoexposureSettings kw


def _plate_row_name(idx: int) -> str:
    """Plate row letters: A..Z then AA, AB, ... (1536-well plates have
    32 rows; bare ``chr(ord('A')+idx)`` yields '[' at row 26)."""
    name = ""
    idx += 1  # bijective base-26 ('A' = 1)
    while idx > 0:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


class PlateSpec(BaseModel):
    """Well-plate geometry (reference ``mantis.yaml`` ``stage_positions.
    plate``). Spacing/size are recorded for provenance; replay content
    is independent of absolute stage coordinates."""

    model_config = ConfigDict(extra="forbid")

    rows: int
    columns: int
    name: str = ""
    well_spacing: tuple[float, float] | None = None
    well_size: tuple[float, float] | None = None

    @model_validator(mode="after")
    def _check(self):
        if self.rows < 1 or self.columns < 1:
            raise ValueError("plate rows/columns must be >= 1")
        return self


class WellPointsPlan(BaseModel):
    """Per-well FOV grid (reference ``well_points_plan``: rows x columns
    of FOVs with ``fov_width``/``fov_height`` um and fractional
    ``overlap`` percent — negative overlap = gap between tiles)."""

    model_config = ConfigDict(extra="forbid")

    rows: int = 1
    columns: int = 1
    fov_height: float | None = None  # um; None = source FOV height
    fov_width: float | None = None
    overlap: tuple[float, float] = (0.0, 0.0)  # percent (y, x)

    @model_validator(mode="after")
    def _check(self):
        if self.rows < 1 or self.columns < 1:
            raise ValueError("well_points_plan rows/columns must be >= 1")
        for name in ("fov_height", "fov_width"):
            v = getattr(self, name)
            # 0 would silently fall back to the source FOV (falsy `or`
            # in generate()); a negative value would mirror the grid.
            if v is not None and not v > 0:
                raise ValueError(f"well_points_plan {name} must be > 0")
        for ov in self.overlap:
            # >= 100% collapses the tile pitch to zero (every FOV an
            # identical unshifted replay) or reverses the grid — a
            # typo like 110 for 11.0 must error, not run to completion.
            if ov >= 100.0:
                raise ValueError(
                    f"well_points_plan overlap must be < 100%; got {ov}"
                )
        return self


class StagePositionsPlan(BaseModel):
    """WellPlatePlan-style generated stage positions (reference
    ``mantis.yaml:16-35``): a plate, the selected wells, and an FOV
    grid per well. Each generated FOV replays the source volume at a
    (y, x) stage offset derived from the grid pitch, so neighboring
    tiles show shifted (overlapping) views of the same sample — the
    replay analogue of moving the xy stage between grid points.
    """

    model_config = ConfigDict(extra="forbid")

    plate: PlateSpec
    # Two index lists: selected row indices and column indices (the
    # cross product is acquired), as in the reference YAML.
    selected_wells: tuple[list[int], list[int]] | None = None
    well_points_plan: WellPointsPlan = Field(default_factory=WellPointsPlan)
    # The source-store position every generated tile replays (the grid
    # is a simulated stage sweep over one recorded sample); None = the
    # source's first position.
    source_position: str | None = None

    @model_validator(mode="after")
    def _check(self):
        if self.selected_wells is not None:
            rows, cols = self.selected_wells
            if not rows or not cols:
                # Empty index lists would generate a zero-position grid
                # and the run would be a silent no-op (same trap as
                # channels/positions: []).
                raise ValueError(
                    "selected_wells lists must be non-empty (omit "
                    "selected_wells for all wells)"
                )
            for r in rows:
                if not 0 <= r < self.plate.rows:
                    raise ValueError(f"selected well row {r} outside plate")
            for c in cols:
                if not 0 <= c < self.plate.columns:
                    raise ValueError(f"selected well column {c} outside plate")
        return self

    def wells(self) -> list[tuple[int, int]]:
        rows, cols = self.selected_wells or (
            list(range(self.plate.rows)),
            list(range(self.plate.columns)),
        )
        return [(r, c) for r in rows for c in cols]

    def generate(
        self, fov_shape_yx: tuple[int, int], scale_yx_um: tuple[float, float]
    ) -> list["GeneratedPosition"]:
        """All (well x grid) positions with per-tile pixel offsets.

        Tile pitch is ``fov_size * (1 - overlap/100)`` per axis
        (negative overlap = gap), converted to pixels via the source
        scale; the grid is centered so the middle tile sees the
        unshifted source.
        """
        wpp = self.well_points_plan
        fh = wpp.fov_height or fov_shape_yx[0] * scale_yx_um[0]
        fw = wpp.fov_width or fov_shape_yx[1] * scale_yx_um[1]
        pitch_y = fh * (1.0 - wpp.overlap[0] / 100.0) / scale_yx_um[0]
        pitch_x = fw * (1.0 - wpp.overlap[1] / 100.0) / scale_yx_um[1]
        out = []
        for wr, wc in self.wells():
            row_name = _plate_row_name(wr)
            col_name = str(wc + 1)
            fov = 0
            for gr in range(wpp.rows):
                for gc in range(wpp.columns):
                    oy = int(round((gr - (wpp.rows - 1) / 2.0) * pitch_y))
                    ox = int(round((gc - (wpp.columns - 1) / 2.0) * pitch_x))
                    out.append(
                        GeneratedPosition(
                            key=f"{row_name}/{col_name}/{fov:06d}",
                            well_row=wr,
                            well_col=wc,
                            offset_px_yx=(oy, ox),
                        )
                    )
                    fov += 1
        return out


class StagePlan(BaseModel):
    """XY stage-speed model for timing-faithful replay pacing.

    The reference live engine modulates XY stage speed per move to hold
    autofocus lock (reference ``mantis_engine.py:285-324``; constants
    ``:30-35``): moves shorter than ``short_distance_um`` run at
    ``slow_speed_mm_s``, longer moves at ``fast_speed_mm_s``, and moves
    under ``negligible_distance_um`` are ignored. With ``model_speed``
    on, the replay engine charges each position move its travel time
    (``distance / speed``, scaled by ``time_scale``) before the visit
    and records every move in the summary sidecar, so session replay
    feeds stage motion into the per-timepoint latency budget exactly
    like the live engine does.
    """

    model_config = ConfigDict(extra="forbid")

    model_speed: bool = False
    slow_speed_mm_s: float = 2.0
    fast_speed_mm_s: float = 5.75
    short_distance_um: float = 2000.0
    negligible_distance_um: float = 1.0
    # 1.0 = sleep the full travel time (real-time replay); 0.0 = record
    # move times in the summary without sleeping (fast replay).
    time_scale: float = 1.0

    @model_validator(mode="after")
    def _check(self):
        if self.slow_speed_mm_s <= 0 or self.fast_speed_mm_s <= 0:
            raise ValueError("stage speeds must be > 0")
        if self.time_scale < 0:
            raise ValueError("time_scale must be >= 0")
        if self.negligible_distance_um < 0:
            raise ValueError("negligible_distance_um must be >= 0")
        return self

    def move_time_s(
        self, distance_um: float
    ) -> tuple[float, float] | None:
        """(speed_mm_s, travel seconds) for one XY move, or None for a
        negligible move (reference ``mantis_engine.py:305-318``)."""
        if distance_um < self.negligible_distance_um:
            return None
        speed = (
            self.slow_speed_mm_s
            if distance_um < self.short_distance_um
            else self.fast_speed_mm_s
        )
        return speed, distance_um / 1000.0 / speed


class CameraPlan(BaseModel):
    """Camera slice-acquisition rate model for timing-faithful replay.

    The reference live engine derives a per-channel z-slice rate from
    camera physics and paces hardware-sequenced bursts with it
    (reference archive ``acq_engine.py:540-598``; constants ``:75-93``):

    - ``labelfree`` (Oryx + MCL piezo): ``min(1000 / (exposure_ms +
      piezo_step_ms), floor(max_fps))`` (``:546-552``), plus an LC
      polarization-switch ``channel_change_ms`` of 20 between channels
      (``:553-556``);
    - ``lightsheet`` (Prime BSI Express, rolling shutter as simulated
      global shutter): ``1000 / (exposure_ms + readout_ms +
      post_readout_delay_ms)`` with the hard constraint exposure >
      sensor readout (``:574-591``), plus a 200 ms filter-wheel change
      (``:81``, channel rate commented out in the reference);
    - ``demo``: ``min(max_fps, 1000 / exposure_ms)`` (the demo-run
      branches, ``:541-543`` flat 30 fps LF and ``:566-570`` LS).

    With ``model_acquisition`` on, the replay engine charges each
    (t, p, channel) volume ``n_slices / slice_rate`` seconds plus one
    ``channel_change`` per channel TRANSITION — ``(n_channels - 1)``
    changes per (t, p) burst, matching the reference accounting
    (archive ``acq_engine.py:1553-1562``) — scaled by ``time_scale``
    and totaled in the summary sidecar, so session replay feeds camera
    pacing into the per-timepoint latency budget exactly like the live
    engine.
    """

    model_config = ConfigDict(extra="forbid")

    model_acquisition: bool = False
    mode: Literal["demo", "labelfree", "lightsheet"] = "demo"
    # labelfree: the Oryx "Frame Rate" property (floor()ed per the
    # reference); demo: the ~30 fps demo-camera assumption.
    max_fps: float = 30.0
    # lightsheet sensor readout (Timing-ReadoutTimeNs, ms); the Prime
    # BSI Express reads ~10 ms at full frame.
    readout_ms: float = 10.0
    piezo_step_ms: float = 1.5  # MCL_STEP_TIME (:80)
    post_readout_delay_ms: float = 0.05  # LS_POST_READOUT_DELAY (:78)
    # None = the mode's default (labelfree 20 ms LC switch, lightsheet
    # 200 ms filter wheel, demo 0).
    channel_change_ms: float | None = None
    # 1.0 = sleep the full modeled time (real-time replay); 0.0 =
    # record modeled times in the summary without sleeping.
    time_scale: float = 1.0
    # Hardware-sequencing event cap: the TriggerScope firmware holds at
    # most this many DAC/DO states per sequence, so a z x channels
    # burst beyond it is unprogrammable on the real instrument
    # (reference archive acq_engine.py:171-183, NR_DAC_STATES /
    # NR_DO_STATES). Unset = mode-dependent: 1200 for the real-
    # instrument modes (labelfree/lightsheet), unlimited for the demo
    # camera (no TriggerScope in the loop). Microscope profiles may
    # seed this (replay-dual arm inheritance).
    max_sequenced_events: int | None = None

    @model_validator(mode="after")
    def _check(self):
        for f in ("max_fps", "readout_ms", "piezo_step_ms"):
            if getattr(self, f) <= 0:
                raise ValueError(f"camera.{f} must be > 0")
        if self.post_readout_delay_ms < 0 or self.time_scale < 0:
            raise ValueError(
                "camera.post_readout_delay_ms and camera.time_scale "
                "must be >= 0"
            )
        if self.channel_change_ms is not None and self.channel_change_ms < 0:
            raise ValueError("camera.channel_change_ms must be >= 0")
        if (
            self.max_sequenced_events is not None
            and self.max_sequenced_events < 1
        ):
            raise ValueError("camera.max_sequenced_events must be >= 1")
        return self

    def effective_max_sequenced_events(self) -> int | None:
        """The enforced cap: an explicit value (including an explicit
        ``null`` = unlimited) wins; unset defaults to 1200 for the
        real-instrument modes and unlimited for the demo camera (no
        TriggerScope in a simulation loop)."""
        if "max_sequenced_events" in self.model_fields_set:
            return self.max_sequenced_events
        return 1200 if self.mode in ("labelfree", "lightsheet") else None

    def check_sequenced_events(
        self, n_slices: int, n_channels: int
    ) -> None:
        """Fail fast when a z x channels burst exceeds the firmware's
        hardware-sequence length (reference archive
        ``acq_engine.py:171-183``): the real instrument's TriggerScope
        cannot program it, so a plan that validates here but not there
        would be a lie."""
        cap = self.effective_max_sequenced_events()
        if not self.model_acquisition or cap is None:
            return
        n = n_slices * n_channels
        if n > cap:
            raise ValueError(
                f"the number of sequenced events ({n_slices} slices x "
                f"{n_channels} channels = {n}) exceeds the "
                f"{cap}-event hardware-sequence "
                "limit (TriggerScope NR_DAC_STATES/NR_DO_STATES); reduce "
                "slices/channels or raise camera.max_sequenced_events "
                "if the firmware was rebuilt with longer sequences"
            )

    def effective_channel_change_ms(self) -> float:
        if self.channel_change_ms is not None:
            return self.channel_change_ms
        return {"labelfree": 20.0, "lightsheet": 200.0, "demo": 0.0}[
            self.mode
        ]

    def slice_rate_hz(self, exposure_ms: float) -> float:
        """Z-slice rate for one channel at ``exposure_ms``."""
        if exposure_ms <= 0:
            raise ValueError(f"exposure_ms must be > 0 (got {exposure_ms})")
        if self.mode == "labelfree":
            return min(
                1000.0 / (exposure_ms + self.piezo_step_ms),
                float(math.floor(self.max_fps)),
            )
        if self.mode == "lightsheet":
            if exposure_ms <= self.readout_ms:
                # The reference asserts this before every LS burst
                # (acq_engine.py:585-588): simulated global shutter
                # needs the laser on strictly longer than the rolling
                # readout.
                raise ValueError(
                    f"lightsheet exposure ({exposure_ms} ms) must exceed "
                    f"the {self.readout_ms} ms sensor readout time"
                )
            return 1000.0 / (
                exposure_ms + self.readout_ms + self.post_readout_delay_ms
            )
        return min(float(self.max_fps), 1000.0 / exposure_ms)

    def volume_time_s(
        self, n_slices: int, exposure_ms: float,
        *, channel_change: bool = True,
    ) -> float:
        """Modeled seconds to acquire one n_slices-deep channel volume.

        ``channel_change`` adds one channel-switch (LC / filter wheel)
        to the burst; the engine sets it only on channel *transitions*,
        matching the reference's (num_channels - 1) changes per (t, p)
        burst (archive ``acq_engine.py:1553-1562``) — a single-channel
        run pays no switch time.
        """
        t = n_slices / self.slice_rate_hz(exposure_ms)
        if channel_change:
            t += self.effective_channel_change_ms() / 1000.0
        return t


class HardwareLaserPlan(BaseModel):
    """One excitation laser bound to a channel (reference archive
    ``acq_engine.py:766-787`` maps TriggerScope illumination states to
    Vortran COM ports)."""

    model_config = ConfigDict(extra="forbid")

    channel: str
    wavelength_nm: int = 488
    max_power_mw: float = 100.0
    power_mw: float = 10.0
    # Serial port name; unset = a per-channel emulator (the only
    # transport on a headless accelerator host). A name pre-bound on devices.bus is
    # opened as-is, so tests/operators can supply their own device.
    port: str | None = None

    @model_validator(mode="after")
    def _check(self):
        if self.max_power_mw <= 0 or self.power_mw < 0:
            raise ValueError("laser powers must be positive")
        if self.power_mw > self.max_power_mw:
            raise ValueError(
                f"laser {self.channel}: power_mw ({self.power_mw}) exceeds "
                f"max_power_mw ({self.max_power_mw})"
            )
        return self


class HardwarePlan(BaseModel):
    """Instrument-control surface (``shrimpy_tpu.devices``): lasers,
    shutter bracket, O3 remote-refocus piezo, and DAQ counter
    triggering — the reference's archived microscope-operations roles
    (``microscope_operations.py:184-232,296-358,536-635``) over
    virtualized transports."""

    model_config = ConfigDict(extra="forbid")

    enabled: bool = False
    lasers: list[HardwareLaserPlan] = Field(default_factory=list)
    # Save/open the mechanical shutter for the run, restore after
    # (reference acq_engine.py:932-934, 1023-1024).
    shutter: bool = True
    # KIM101 port for the O3 remote-refocus stage; refocus corrections
    # become compensated relative moves (microscope_operations.py:334-358).
    o3_port: str | None = None
    # Calibration: piezo steps per source z slice of refocus correction.
    o3_steps_per_slice: int = 10
    # Arm channel/z counter tasks from the camera model and start them
    # per (t, p) burst (reference acq_engine.py:600-688). Requires
    # camera.model_acquisition (the rates come from that model).
    daq: bool = True

    @model_validator(mode="after")
    def _check(self):
        if self.o3_steps_per_slice < 1:
            raise ValueError("hardware.o3_steps_per_slice must be >= 1")
        seen: set[str] = set()
        for laser in self.lasers:
            if laser.channel in seen:
                raise ValueError(
                    f"hardware.lasers: duplicate channel {laser.channel!r}"
                )
            seen.add(laser.channel)
        return self


class GeneratedPosition(BaseModel):
    """One stage-position grid point: output HCS key + replay offset."""

    model_config = ConfigDict(extra="forbid")

    key: str  # output "row/col/fov"
    well_row: int
    well_col: int
    offset_px_yx: tuple[int, int]


class AcquisitionPlan(BaseModel):
    model_config = ConfigDict(extra="forbid")

    time: TimePlan = Field(default_factory=TimePlan)
    channels: list[ChannelPlan] | None = None  # None = all source channels
    z: ZPlan = Field(default_factory=ZPlan)
    positions: list[str] | None = None  # None = all source positions
    # Alternatively, a position-list CSV (io/platemap schema): HCS rows
    # select positions by their "row/col/fov" key.
    positions_csv: str | None = None
    # Or a generated well-plate grid (reference WellPlatePlan).
    stage_positions: StagePositionsPlan | None = None
    # Brightness emulation baseline: the source recording's exposure.
    source_exposure_ms: float = 10.0
    # "volume" reads whole stacks from the replay source; "camera"
    # drives frame-by-frame ReplayCamera.snap with SequencedBurst
    # z-queues per (t, p, c) — the reference's actual event loop
    # (reference replay_camera.py:470-521). Outputs are identical.
    mode: Literal["volume", "camera"] = "volume"
    axis_order: str = "tpcz"
    autofocus: AutofocusPlan = Field(default_factory=AutofocusPlan)
    refocus: RefocusPlan = Field(default_factory=RefocusPlan)
    autoexposure: AutoexposurePlan = Field(default_factory=AutoexposurePlan)
    stage: StagePlan = Field(default_factory=StagePlan)
    camera: CameraPlan = Field(default_factory=CameraPlan)
    hardware: HardwarePlan = Field(default_factory=HardwarePlan)
    metadata: dict = Field(default_factory=dict)
    # Stall watchdog: a (t, p) visit exceeding this wall time is logged
    # as an error (the reference's 100 s sequence-stall watchdog,
    # archive acq_engine.py:1567-1616).
    watchdog_s: float = 100.0

    @model_validator(mode="after")
    def _check(self):
        if self.channels is not None and not self.channels:
            # channels: [] would fall through the engine's falsy check
            # and acquire EVERY source channel — the opposite of what
            # an explicit empty list expresses. Use None (or omit) for
            # "all channels".
            raise ValueError(
                "channels must be a non-empty list (omit it or use null "
                "for all source channels)"
            )
        if self.positions is not None and not self.positions:
            # Same trap as channels: [] — an explicit empty selection
            # would create the output store then crash mid-run.
            raise ValueError(
                "positions must be a non-empty list (omit it or use "
                "null for all source positions)"
            )
        if self.axis_order != "tpcz":
            # Declared-and-rejected rather than silently ignored: the
            # replay engine's loop nesting is t -> p -> c -> z only.
            raise ValueError("only axis_order='tpcz' is supported")
        n_sources = sum(
            x is not None
            for x in (self.positions, self.positions_csv, self.stage_positions)
        )
        if n_sources > 1:
            raise ValueError(
                "set only one of positions / positions_csv / stage_positions"
            )
        if not self.source_exposure_ms > 0:
            raise ValueError("source_exposure_ms must be > 0")
        return self

    def resolve_positions(self, available: list[str]) -> list[str]:
        """Position keys to acquire: explicit list, CSV, or all.

        Every explicit key is validated against ``available`` so
        ``plan validate --input`` fails BEFORE the run, not at the
        engine's own re-check."""
        if self.positions is not None:
            unknown = [p for p in self.positions if p not in available]
            if unknown:
                raise ValueError(
                    f"plan positions {unknown} not in the source store "
                    f"(has {available})"
                )
            return self.positions
        if self.positions_csv is not None:
            from shrimpy_tpu_torch.io.platemap import PositionList

            keys = []
            for entry in PositionList.read(self.positions_csv):
                key = entry.hcs_key or entry.name
                if key not in available:
                    raise ValueError(
                        f"position {key!r} from {self.positions_csv} not in "
                        f"the source store (has {available})"
                    )
                keys.append(key)
            return keys
        return available

    @classmethod
    def from_yaml(cls, path: str | Path) -> "AcquisitionPlan":
        with open(path) as f:
            return cls(**(yaml.safe_load(f) or {}))

    def dynatrack_metadata(self) -> dict | None:
        """The ``metadata.dynatrack`` block (reference
        ``metadata.mantis.dynatrack``, ``manager.py:170-240``)."""
        return self.metadata.get("dynatrack")


def camera_autoexposure_problems(plan: "AcquisitionPlan") -> list[str]:
    """Exposures autoexposure may SELECT must be modelable.

    Lightsheet's simulated global shutter needs exposure > readout for
    every burst (reference archive ``acq_engine.py:585-588``), and
    autoexposure can move the exposure below the configured values —
    the escalation floor ``min_exposure_ms`` on the algorithmic paths,
    arbitrary per-well entries on the manual-CSV path. Both are
    checkable BEFORE the run; shared by ``validate_plan`` and the
    engine's run-start fail-fast so a bright scene cannot abort a run
    mid-acquisition with partial output."""
    cam = plan.camera
    ae = plan.autoexposure
    if not (
        cam.model_acquisition and cam.mode == "lightsheet" and ae.enabled
    ):
        return []
    problems: list[str] = []
    if ae.algorithm == "manual":
        if not ae.manual_csv:
            problems.append(
                "autoexposure algorithm 'manual' needs manual_csv"
            )
            return problems
        from shrimpy_tpu_torch.engine.autoexposure import load_manual_exposures

        try:
            table = load_manual_exposures(ae.manual_csv)
        except Exception as e:
            problems.append(f"autoexposure manual_csv: {e}")
            return problems
        for well, (exp, _pw) in sorted(table.items()):
            try:
                cam.slice_rate_hz(exp)
            except ValueError as e:
                problems.append(
                    f"autoexposure manual exposure for well {well!r}: {e}"
                )
        return problems
    from shrimpy_tpu_torch.engine.autoexposure import AutoexposureSettings

    try:
        s = AutoexposureSettings(**ae.settings)
    except TypeError as e:
        problems.append(f"autoexposure settings: {e}")
        return problems
    # AutoexposureSettings is a plain dataclass (no coercion): a YAML
    # string value survives construction and would blow up the
    # comparison below — or the escalation math mid-run — with a
    # TypeError. Report it as a problem instead of crashing
    # `plan validate` / the browser editor's validate handler.
    import dataclasses

    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            problems.append(
                f"autoexposure settings: {f.name} must be a number "
                f"(got {v!r})"
            )
    if any(p.startswith("autoexposure settings:") for p in problems):
        return problems
    if s.min_exposure_ms <= cam.readout_ms:
        problems.append(
            f"autoexposure min_exposure_ms ({s.min_exposure_ms} ms) must "
            f"exceed the lightsheet sensor readout ({cam.readout_ms} ms): "
            "escalation on a bright scene could select an exposure the "
            "camera timing model must reject mid-run"
        )
    return problems


def validate_plan(plan: AcquisitionPlan, source=None) -> list[str]:
    """Every pre-run check the engine would fail on, as problem strings.

    The one source of truth behind ``plan validate`` (CLI) and the
    browser plan editor (``viewer/web.py``) — mirroring the reference
    widget's pre-run validation (reference
    ``mantis_acquisition_widget.py:604-657``). ``source`` is an opened
    :class:`~shrimpy_tpu_torch.engine.replay.ReplaySource` for the
    store cross-checks; ``None`` runs the schema-only tier.

    Returns ``[]`` when the plan is valid.
    """
    problems: list[str] = []
    dyn = plan.dynatrack_metadata()
    cfg = None
    if dyn:
        from shrimpy_tpu_torch.config.schemas import DynaTrackConfig

        try:
            cfg = DynaTrackConfig(**dyn)
        except Exception as e:
            problems.append(f"dynatrack config: {e}")
    if plan.camera.model_acquisition:
        # The engine fails fast on these at run start (the reference
        # asserts exposure > readout before every lightsheet burst,
        # archive acq_engine.py:585-588) — surface them pre-run.
        exposures = (
            [(c.name, c.exposure_ms) for c in plan.channels]
            if plan.channels
            else [("<default>", plan.source_exposure_ms)]
        )
        for cname, exp in exposures:
            try:
                plan.camera.slice_rate_hz(exp)
            except ValueError as e:
                problems.append(f"camera model, channel {cname!r}: {e}")
        # Hardware-sequence length (reference archive
        # acq_engine.py:171-183): checkable without a store whenever
        # the plan pins its own slice count — at least 1 channel always
        # acquires, so n_slices alone can already breach the cap; the
        # store branch below re-checks with the resolved counts.
        if plan.z.n_slices is not None:
            try:
                plan.camera.check_sequenced_events(
                    plan.z.n_slices,
                    len(plan.channels) if plan.channels else 1,
                )
            except ValueError as e:
                problems.append(f"camera model: {e}")
        problems.extend(camera_autoexposure_problems(plan))
    if plan.hardware.enabled and plan.channels:
        names = [c.name for c in plan.channels]
        for laser in plan.hardware.lasers:
            if laser.channel not in names:
                problems.append(
                    f"hardware laser channel {laser.channel!r} not among "
                    f"the plan channels {names}"
                )
    if source is not None:
        names = source.channel_names
        if plan.channels:
            for c in plan.channels:
                if c.name not in names:
                    problems.append(
                        f"channel {c.name!r} not in store (has {names})"
                    )
        if plan.hardware.enabled and not plan.channels:
            for laser in plan.hardware.lasers:
                if laser.channel not in names:
                    problems.append(
                        f"hardware laser channel {laser.channel!r} not in "
                        f"store (has {names})"
                    )
        try:
            plan.resolve_positions(source.position_keys)
        except ValueError as e:
            problems.append(str(e))
        # Checks the ENGINE enforces at run start (after the output
        # dir and log already exist) — surfaced here instead:
        if plan.stage_positions is not None:
            src = plan.stage_positions.source_position
            if src is not None and src not in source.position_keys:
                problems.append(
                    f"stage_positions.source_position={src!r} not in "
                    f"the source store (has {source.position_keys})"
                )
        try:
            z_idx = plan.z.resolve_z_indices(
                source.shape_tczyx[2], float(source.zyx_scale[0])
            )
        except ValueError as e:
            problems.append(f"z plan: {e}")
        else:
            if plan.camera.model_acquisition:
                n_ch = (
                    len(plan.channels)
                    if plan.channels
                    else source.shape_tczyx[1]
                )
                try:
                    plan.camera.check_sequenced_events(len(z_idx), n_ch)
                except ValueError as e:
                    problems.append(f"camera model: {e}")
        if plan.refocus.enabled and plan.refocus.channel is not None:
            if plan.refocus.channel not in names:
                problems.append(
                    f"refocus channel {plan.refocus.channel!r} not in store"
                )
        if plan.autoexposure.enabled and plan.autoexposure.channel is not None:
            if plan.autoexposure.channel not in names:
                problems.append(
                    f"autoexposure channel "
                    f"{plan.autoexposure.channel!r} not in store"
                )
        if cfg is not None:
            track_src = (
                cfg.input_channel if cfg.preprocessing
                else cfg.tracking_channel
            )
            if track_src not in names:
                problems.append(
                    f"dynatrack channel {track_src!r} not in store"
                )
    return problems
