"""Acquisition engine: the MDA run loop in demo/replay mode.

Re-creates the reference's ``MantisEngine`` lifecycle (reference
``shrimpy/mantis/mantis_engine.py:114-494``) over our replay source and
OME-Zarr writer:

* ``setup_sequence`` equivalent: resolve the output store (name
  auto-increment so re-runs never overwrite, ``:497-518``), wire
  DynaTrack from the plan metadata (``:146-183``), configure per-
  acquisition logging;
* event loop (t -> p -> c): autofocus engagement per (t, p) with
  :class:`SkipEvent` semantics — a failed autofocus writes zero-padded
  volumes and the acquisition continues (``:228-230``, verified
  on-disk by the reference's integration tests);
* ``frameReady`` fan-out: every completed volume goes to the writer,
  the tracking manager (baseline capture + async shift update,
  backpressure drain at timepoint boundaries ``:194-209``), and any
  registered viewer hooks;
* ``teardown_sequence`` equivalent: drain + shutdown tracking, write
  the ``summary_metadata.json`` sidecar (``:477-483``).

The port's own copy of ``shrimpy_tpu/engine/engine.py``, pinned statement
for statement by ``tests/test_torch_config.py`` but for four differences,
each tested on its own:

* **Deferred imports.** The plan (``engine/plan.py``: pydantic, yaml), the
  replay source (``engine/replay.py``) and the store (``io/ngff.py`` on the
  chunk engine) are imported where they are used, never when this module
  loads: it loads, and runs a plan, on a host with torch, numpy and scipy
  alone. ``AcquisitionPlan`` and ``ReplaySource`` name the interfaces in
  annotations only. The output store is ``shrimpy_tpu_torch.io.ngff`` as
  ``sys.modules`` holds it when :meth:`AcquisitionEngine.acquire` starts
  (a stand-in there is used in its place): where it cannot be imported,
  the run raises an ``ImportError`` that names it before it creates
  anything.
* **DynaTrack's config** is :func:`shrimpy_tpu_torch.config.dynatrack_settings`
  with :func:`~shrimpy_tpu_torch.config.inject_dynatrack_parameters`, which
  keep ``DynaTrackConfig``'s rules and messages, never the pydantic model.
* **``device``.** ``AcquisitionEngine(..., device=None)`` hands ``device`` to
  the tracking's ``Preprocessor`` and ``Tracker`` and to the refocus metric:
  the card when None, as every entry point of the port.
* **Any plan object.** ``plan`` is an ``engine.plan.AcquisitionPlan`` or the
  namespace of :func:`shrimpy_tpu_torch.config.acquisition_plan`; both are
  read by attribute.

The replay seam (:meth:`AcquisitionEngine._stage_offset_px`) sends stage z,
y and x to the raw's z, y and x, and rolls the raw by minus them. Tracking on
the unprocessed stack then needs -I as ``image_to_stage_matrix_xyz``
(``configs/plan_demo.yml``). After ``preprocessing: [deskew]`` the tracker
measures in the deskewed frame, where a scan drift of the raw is a y shift,
so -I does not re-centre it: such tracking needs the matrix that inverts the
deskew's geometry (``chip_smoke.py::loop_matrix``).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np

from shrimpy_tpu_torch.engine.autofocus import DemoAutofocus
from shrimpy_tpu_torch.engine.control import AbortRun, RunControl
from shrimpy_tpu_torch.tracking.core import ShiftJournal, Tracker
from shrimpy_tpu_torch.tracking.position import PositionStore, PositionUpdateManager
from shrimpy_tpu_torch.utils.logging import (
    environment_provenance as _environment_provenance,
)

logger = logging.getLogger(__name__)

# Nominal laser power of the replay brightness model: the recording's
# brightness corresponds to source_exposure_ms at THIS power. Both
# halves of the model (_run_autoexposure's acquire callback and
# _effective_exposure_ms's render scaling) must use the same value or
# autoexposure would pick an operating point the replay then renders at
# a different brightness. Defined next to the autoexposure algorithms
# (manual-CSV default power shares it); re-exported here for the engine.
from shrimpy_tpu_torch.engine.autoexposure import (  # noqa: E402
    NOMINAL_LASER_POWER,
)


class SkipEvent(Exception):
    """Skip the remaining frames of a position; the writer zero-pads.

    Same contract as the reference's SkipEvent on autofocus failure
    (``mantis_engine.py:228-230``).
    """

    def __init__(self, num_frames: int):
        super().__init__(f"skip {num_frames} frames")
        self.num_frames = num_frames


def resolve_acquisition_name(output_dir: Path, name: str) -> str:
    """Auto-increment the acquisition name so re-runs never overwrite
    (reference ``mantis_engine.py:497-518``)."""
    candidate = name
    i = 1
    while (output_dir / f"{candidate}.zarr").exists():
        candidate = f"{name}_{i}"
        i += 1
    return candidate


class AcquisitionEngine:
    """Demo/replay acquisition: plan + replay source -> OME-Zarr output."""

    def __init__(
        self,
        source: ReplaySource,
        *,
        viewer_hooks: list | None = None,
        position_store: PositionStore | None = None,
        timepoint_hook=None,
        hook_handles_run_control: bool = False,
        device=None,
    ):
        self.source = source
        # Where the tracking and the refocus metric run: the card when
        # None, "cpu" when the caller asks for it.
        self.device = device
        self.viewer_hooks = viewer_hooks or []
        # Dual-arm seams (engine/dual.py): a SHARED stage store so one
        # arm's tracking corrections move every arm (the reference's two
        # MM instances drive one physical stage, archive
        # acq_engine.py:98-183), and a per-timepoint hook where the
        # coordinator places its start-of-timepoint barrier (the DAQ
        # trigger that starts both cameras together, :601-687).
        self._position_store = position_store
        self.timepoint_hook = timepoint_hook
        # True when the hook is a lockstep barrier that owns the PAUSE
        # point (engine/dual.py): the engine then checks abort-only
        # before the hook (blocking there would burn a partner's
        # barrier stall timeout) and skips position-level checkpoints;
        # the hook blocks post-barrier and returns the paused seconds.
        self.hook_handles_run_control = hook_handles_run_control
        self._tracking: PositionUpdateManager | None = None
        self._tracker: Tracker | None = None
        self._track_channel_idx: int | None = None
        # Per-position accumulated remote-refocus z offset (slices).
        self._refocus_z: dict[str, int] = {}
        self._refocus_events: list[tuple[int, str, int]] = []
        # Per-position (exposure_ms, laser_power) from autoexposure.
        self._exposures: dict[str, tuple[float, float]] = {}
        # [t, position | None] where run control aborted the last run.
        self.aborted_at: list | None = None

    # -- setup ---------------------------------------------------------------
    def _setup_tracking(
        self,
        plan: AcquisitionPlan,
        channels: list[str],
        out_dir: Path,
        acq_name: str | None = None,
    ) -> None:
        meta = plan.dynatrack_metadata()
        if not meta:
            return
        # DynaTrackConfig's namespace: its rules and messages, no pydantic.
        from shrimpy_tpu_torch.config import (
            dynatrack_settings,
            inject_dynatrack_parameters,
        )

        cfg = dynatrack_settings(**meta)
        if not cfg.enabled:
            return
        # Derived-parameter injection (single source of truth,
        # reference manager.py:242-262): the source store's scale
        # supplies pixel size / scan step to the deskew/phase blocks.
        src_sz, src_sy, _ = self.source.zyx_scale
        inject_dynatrack_parameters(
            cfg, pixel_size_um=float(src_sy), z_step_um=float(src_sz)
        )
        track_scale = tuple(float(v) for v in self.source.zyx_scale)
        preprocessor = None
        if cfg.preprocessing:
            from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

            preprocessor = Preprocessor(cfg, device=self.device)
            track_source_channel = cfg.input_channel
            # The tracker consumes the PROCESSED stack: deskew changes
            # the voxel grid, so px->um conversion and the um limits
            # must use the processed scale, not the raw one.
            track_scale = preprocessor.tracking_scale_zyx(
                tuple(self.source.shape_tczyx[2:]), track_scale
            )
        else:
            track_source_channel = cfg.tracking_channel
        if track_source_channel not in channels:
            raise ValueError(
                f"dynatrack channel {track_source_channel!r} not in "
                f"acquired channels {channels}"
            )
        # Per-acquisition sidecars: keyed on the auto-incremented name
        # so re-runs never interleave journals or collide on the debug
        # store (the bare names remain for direct/legacy callers).
        prefix = f"{acq_name}_" if acq_name else ""
        journal = ShiftJournal(out_dir / f"{prefix}dynatrack_log.csv")
        debug_writer = None
        if cfg.debug:
            from shrimpy_tpu_torch.tracking.debug import DebugWriter

            debug_writer = DebugWriter(out_dir / f"{prefix}dynatrack_debug")
        if cfg.image_to_stage_matrix_xyz is None:
            # The replay stage seam rolls the volume by MINUS the stage
            # position (the FOV follows the stage, replay.py:63-75), so
            # an identity image->stage matrix is a POSITIVE feedback
            # loop here: each correction amplifies the measured drift
            # (~2x per timepoint until PCC wraps). Real instruments
            # calibrate this matrix (reference dynatrack_demo.yaml
            # ships an explicit one); the demo/replay convention needs
            # the sign flip (-I), and after [deskew] the matrix that
            # inverts the deskew's geometry (module docstring).
            logger.warning(
                "dynatrack: image_to_stage_matrix_xyz not set (identity). "
                "In replay mode the stage seam's sign convention makes "
                "identity a positive-feedback loop — corrections will "
                "AMPLIFY drift; set the matrix (e.g. -I, see "
                "configs/plan_demo.yml) unless you know the identity "
                "orientation matches your stage."
            )
        self._tracker = Tracker(
            cfg,
            scale_zyx_um=track_scale,
            journal=journal,
            debug_writer=debug_writer,
            device=self.device,
        )
        self._track_channel_idx = channels.index(track_source_channel)
        store = (
            self._position_store
            if self._position_store is not None
            else PositionStore()
        )

        def updater(stack: np.ndarray, t: int, p: str) -> np.ndarray:
            if preprocessor is not None:
                stack = preprocessor.tracking_stack(stack)
            result = self._tracker.update(stack, t, p)
            return result.stage_shift_xyz

        self._tracking = PositionUpdateManager(store, updater)
        logger.info("dynatrack enabled: method=%s", cfg.tracking_method)

    # -- acquisition ---------------------------------------------------------
    def acquire(
        self,
        output_dir: str | Path,
        name: str,
        plan: AcquisitionPlan,
        *,
        run_control: RunControl | None = None,
    ) -> Path:
        t_start = time.monotonic()
        # The output store, as sys.modules holds it now:
        # without it the run raises here, before it creates anything.
        from shrimpy_tpu_torch.io import ngff

        # Per-run state: one engine instance may run several
        # acquisitions; leftovers from the previous run (a shut-down
        # tracking manager, accumulated refocus offsets/exposures)
        # must not leak into this one.
        self._tracking = None
        self._tracker = None
        self._track_channel_idx = None
        self._refocus_z = {}
        self._refocus_events = []
        self._exposures = {}
        self._manual_ae_cache = None
        self.aborted_at = None
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        final_name = resolve_acquisition_name(output_dir, name)
        out_path = output_dir / f"{final_name}.zarr"

        # Per-acquisition timestamped log file (reference _logging.py:44-59).
        from shrimpy_tpu_torch.utils.logging import configure_logging

        log_file = configure_logging(
            log_dir=output_dir, acquisition_name=final_name
        )
        if log_file:
            logger.info("acquisition log: %s", log_file)

        ny, nx = self.source.shape_tczyx[3:]
        # Positions: explicit list / CSV / generated well-plate grid
        # (reference WellPlatePlan, mantis.yaml:16-35). Grid tiles all
        # replay one source position at per-tile stage offsets.
        grid: dict[str, object] | None = None
        if plan.stage_positions is not None:
            src_key = (
                plan.stage_positions.source_position
                or self.source.position_keys[0]
            )
            if src_key not in self.source.position_keys:
                raise ValueError(
                    f"stage_positions.source_position={src_key!r} not in "
                    f"the source store (has {self.source.position_keys})"
                )
            generated = plan.stage_positions.generate(
                (ny, nx), tuple(self.source.zyx_scale[1:])
            )
            positions = [g.key for g in generated]
            if not positions:
                raise ValueError(
                    "stage_positions generated zero positions (empty "
                    "well/grid selection)"
                )
            grid = {g.key: g for g in generated}
            source_of = {g.key: src_key for g in generated}
        else:
            positions = plan.resolve_positions(self.source.position_keys)
            unknown = [
                p for p in positions if p not in self.source.position_keys
            ]
            if unknown:
                raise ValueError(
                    f"plan positions {unknown} not in the source store "
                    f"(has {self.source.position_keys})"
                )
            if not self.source.store.is_plate and len(positions) > 1:
                raise ValueError(
                    "a single-FOV source has exactly one position; got "
                    f"{positions}"
                )
            if not positions:
                # positions: [] (or a CSV matching zero rows) would
                # otherwise create the output store and crash mid-run.
                raise ValueError(
                    "the plan selects zero positions (empty positions "
                    "list / CSV); select at least one"
                )
            source_of = {p: p for p in positions}
        channels = (
            [c.name for c in plan.channels]
            if plan.channels
            else self.source.channel_names
        )
        chan_idx = [self.source.channel_index(c) for c in channels]
        # Per-channel exposure emulation (ChannelPlan.exposure_ms):
        # brightness scales with exposure relative to the recording's.
        ch_exposure = (
            [c.exposure_ms for c in plan.channels]
            if plan.channels
            else [plan.source_exposure_ms] * len(channels)
        )
        src_z = self.source.shape_tczyx[2]
        src_z_um = float(self.source.zyx_scale[0])
        z_idx = np.asarray(
            plan.z.resolve_z_indices(src_z, src_z_um), dtype=np.int64
        )
        nz = len(z_idx)
        out_z_um = plan.z.step_um if plan.z.step_um is not None else src_z_um
        out_scale = (out_z_um, *self.source.zyx_scale[1:])
        n_t = plan.time.n_timepoints
        shape = (n_t, len(channels), nz, ny, nx)
        camera = None
        if plan.mode == "camera":
            from shrimpy_tpu_torch.engine.replay import ReplayCamera

            camera = ReplayCamera(self.source, z_step_um=src_z_um)
        # Camera acquisition-rate model (CameraPlan): charge each
        # (t, p, channel) volume its modeled z-burst time, like the
        # reference's hardware-sequenced slice rate (archive
        # acq_engine.py:540-598). Fail fast on the configured
        # exposures — the reference asserts exposure > readout before
        # every lightsheet burst (acq_engine.py:585-588); autoexposure
        # can still re-trip the check mid-run with a new exposure.
        camera_acq_total_s = 0.0
        camera_rate_hz: dict[str, float] = {}
        # Rates actually charged when autoexposure moved a position's
        # exposure off the configured one, keyed "position|channel"
        # (the per-channel dict above cannot represent per-position
        # autoexposure results).
        camera_effective_rate_hz: dict[str, float] = {}
        if plan.camera.model_acquisition:
            # z x channels must fit the firmware's hardware-sequence
            # length (reference archive acq_engine.py:171-183).
            plan.camera.check_sequenced_events(nz, len(channels))
            # Exposures autoexposure may select must be modelable too
            # (lightsheet exposure > readout) — fail BEFORE any output
            # exists, not when a bright well trips the model mid-run.
            from shrimpy_tpu_torch.engine.plan import camera_autoexposure_problems

            ae_problems = camera_autoexposure_problems(plan)
            if ae_problems:
                raise ValueError("; ".join(ae_problems))
            for c, e in zip(channels, ch_exposure):
                camera_rate_hz[c] = plan.camera.slice_rate_hz(e)

        self._setup_tracking(plan, channels, output_dir, acq_name=final_name)
        if plan.refocus.enabled:
            # Chunk resume: carry the accumulated remote-refocus offsets
            # over from the previous acquisition chunk of the same name
            # (the reference regex-recovers the O3 position from the
            # previous chunk's log, archive acq_engine.py:802-838).
            self._restore_refocus_from_previous(output_dir, name, final_name)
        autofocus = DemoAutofocus(plan.autofocus, len(positions))

        # Instrument rig (shrimpy_tpu_torch.devices): lasers / shutter / O3
        # piezo / DAQ counters behind first-party drivers over
        # virtualized transports — the reference's archived hardware
        # roles (microscope_operations.py:184-232,296-358,536-635).
        rig = None
        if plan.hardware.enabled:
            from shrimpy_tpu_torch.devices.rig import LaserSpec, build_rig

            rig = build_rig(
                [
                    LaserSpec(
                        channel=l.channel,
                        wavelength_nm=l.wavelength_nm,
                        max_power_mw=l.max_power_mw,
                        power_mw=l.power_mw,
                        port=l.port,
                    )
                    for l in plan.hardware.lasers
                ],
                o3_port=plan.hardware.o3_port,
                o3_steps_per_slice=plan.hardware.o3_steps_per_slice,
                with_shutter=plan.hardware.shutter,
            )
            rig.run_start()
            if plan.hardware.daq and plan.camera.model_acquisition:
                # Counter rates come from the camera model (the
                # reference's update_*_acquisition_rates feed its DAQ
                # setup, archive acq_engine.py:600-612); without the
                # model there is nothing honest to arm — the reference
                # likewise skips DAQ setup in demo mode (:613-615).
                exp0 = ch_exposure[0]
                rig.arm_counters(
                    nz,
                    len(channels),
                    plan.camera.slice_rate_hz(exp0),
                    plan.camera.volume_time_s(
                        nz, exp0, channel_change=True
                    ),
                )

        # Output store mirrors the source layout; a generated grid is
        # always an HCS plate (its keys are row/col/fov).
        out_positions: dict[str, ngff.NgffPosition] = {}
        if grid is not None or (
            self.source.store.is_plate and len(positions) > 0
        ):
            out_store = ngff.create_hcs(out_path, channel_names=channels)
            for key in positions:
                row, col, fov = key.split("/")
                pos = out_store.create_position(
                    row, col, fov, channel_names=channels,
                    zyx_scale=out_scale,
                )
                pos.create_array(shape, dtype="float32")
                out_positions[key] = pos
        else:
            pos = ngff.create_fov(
                out_path,
                shape=shape,
                dtype="float32",
                channel_names=channels,
                zyx_scale=out_scale,
            )
            out_positions[positions[0]] = pos

        skipped: list[tuple[int, str]] = []
        overruns: list[tuple[int, float]] = []
        n_volumes = 0
        # XY stage-speed model (reference mantis_engine.py:285-324):
        # per-position home coordinates in stage microns. Platemap CSV
        # rows carry real stage coords; generated grid tiles and
        # tracking corrections already live in the per-visit pixel
        # offset, which converts to microns via the lateral scale.
        home_xy_um: dict[str, tuple[float, float]] = {
            p: (0.0, 0.0) for p in positions
        }
        if plan.positions_csv is not None:
            from shrimpy_tpu_torch.io.platemap import PositionList

            for entry in PositionList.read(plan.positions_csv):
                key = entry.hcs_key or entry.name
                if key in home_xy_um:
                    home_xy_um[key] = (float(entry.x_um), float(entry.y_um))
        last_xy_um: tuple[float, float] | None = None
        stage_moves: list[list] = []
        stage_move_total_s = 0.0
        # Run control (pause/resume/abort, engine/control.py): honored
        # at safe boundaries only — before a timepoint (always, and
        # BEFORE the dual-arm barrier hook so paused arms never burn the
        # barrier's stall timeout) and before each position visit
        # (single-arm only: mid-timepoint pauses would desynchronize
        # barrier-coupled arms). Paused time is excluded from the
        # timepoint pacing clock. Reference: run/pause through the Qt
        # widget (mantis_acquisition_widget.py:604-657), sequence abort
        # (archive acq_engine.py:1547-1616).
        aborted_at: list | None = None
        paused_s = 0.0
        t_loop_start = time.monotonic()
        run_error: str | None = None
        # Teardown runs on ANY exit (reference teardown_sequence):
        # a raising hook (e.g. BrokenBarrierError from a dual-arm
        # stall) must still drain/shut down tracking — its worker
        # would otherwise keep mutating the SHARED stage store —
        # and the partial store still gets its summary sidecar,
        # with the error recorded.
        try:
            for t in range(n_t):
                if run_control is not None:
                    try:
                        if self.hook_handles_run_control:
                            # Barrier-coupled run: blocking here would let a
                            # partner already inside the barrier burn its
                            # stall timeout, so the pre-barrier check is
                            # ABORT-ONLY; the hook pauses post-barrier in
                            # lockstep (engine/dual.py) and returns the
                            # paused seconds.
                            if run_control.command == "abort":
                                raise AbortRun()
                            dt = 0.0
                        else:
                            dt = run_control.checkpoint()
                    except AbortRun:
                        aborted_at = [t, None]
                        break
                    # Paused time must not count against the timepoint
                    # cadence (or the first post-pause timepoint records a
                    # giant overrun and every later one is "due" already).
                    paused_s += dt
                    t_loop_start += dt
                # Backpressure: timepoint-t tracking completes before t+1
                # events execute (reference mantis_engine.py:194-209).
                if self._tracking is not None and t > 0:
                    self._tracking.drain_pending()
                if t > 0 and plan.time.interval_s > 0:
                    # Honor the timepoint cadence: timepoint t is due at
                    # start + t * interval. The DynaTrack latency budget
                    # (reference position_update.py:275-287) is that the
                    # drain above completes before the next timepoint is
                    # due; an overrun means tracking (or acquisition) blew
                    # the interval and is recorded in the summary.
                    due = t_loop_start + t * plan.time.interval_s
                    now = time.monotonic()
                    if now < due:
                        time.sleep(due - now)
                    elif now - due > 1e-3:
                        overruns.append((t, now - due))
                        logger.warning(
                            "timepoint %d started %.3fs past its %.1fs "
                            "interval (latency budget exceeded)",
                            t, now - due, plan.time.interval_s,
                        )
                if self.timepoint_hook is not None:
                    # Dual-arm barrier point: tracking for t-1 has drained
                    # (the shared stage is settled) and pacing is honored;
                    # every arm enters timepoint t together. A hook may
                    # block for run control AFTER its barrier and return
                    # the paused seconds (excluded from pacing), or raise
                    # AbortRun for a lockstep abort.
                    try:
                        dt = self.timepoint_hook(t)
                    except AbortRun:
                        aborted_at = [t, None]
                        break
                    if dt:
                        paused_s += float(dt)
                        t_loop_start += float(dt)
                for p_idx, p_key in enumerate(positions):
                    if (
                        run_control is not None
                        and not self.hook_handles_run_control
                        and p_idx > 0
                    ):
                        # Position-boundary control point (single-arm only:
                        # a mid-timepoint pause on one barrier-coupled arm
                        # would burn the partner's barrier stall timeout).
                        try:
                            dt = run_control.checkpoint()
                        except AbortRun:
                            aborted_at = [t, p_key]
                            break
                        paused_s += dt
                        t_loop_start += dt
                    t_pos_start = time.monotonic()
                    out_pos = out_positions[p_key]
                    offset = self._stage_offset_px(p_key)
                    if grid is not None:
                        g = grid[p_key]
                        offset = (
                            offset[0],
                            offset[1] + g.offset_px_yx[0],
                            offset[2] + g.offset_px_yx[1],
                        )
                    src_key = source_of[p_key]
                    if plan.stage.model_speed:
                        # Charge the XY move its travel time BEFORE
                        # autofocus, like the live engine's speed-
                        # modulated go_to_position (reference
                        # mantis_engine.py:285-324; archive
                        # acq_engine.py:840-890 moves then focuses).
                        sy, sx = (
                            float(v) for v in self.source.zyx_scale[1:]
                        )
                        hx, hy = home_xy_um[p_key]
                        target_xy = (
                            hx + offset[2] * sx, hy + offset[1] * sy
                        )
                        if last_xy_um is not None:
                            dist = float(
                                np.hypot(
                                    target_xy[0] - last_xy_um[0],
                                    target_xy[1] - last_xy_um[1],
                                )
                            )
                            move = plan.stage.move_time_s(dist)
                            if move is not None:
                                speed, move_s = move
                                stage_moves.append(
                                    [t, p_key, round(dist, 3),
                                     speed, round(move_s, 4)]
                                )
                                stage_move_total_s += move_s
                                if plan.stage.time_scale > 0:
                                    time.sleep(
                                        move_s * plan.stage.time_scale
                                    )
                        last_xy_um = target_xy
                    if not autofocus.engage(t, p_idx):
                        # SkipEvent contract (reference mantis_engine.py
                        # autofocus failure path): zero-padded volumes
                        # stay on disk and the visit is recorded skipped.
                        zeros = np.zeros((nz, ny, nx), np.float32)
                        for ci in range(len(channels)):
                            out_pos.write((t, ci), zeros)
                        skipped.append((t, p_key))
                        continue
                    if t == 0 and plan.autoexposure.enabled:
                        # Per-well exposure selection on the first visit
                        # (archive acq_engine.py:1414-1441).
                        self._run_autoexposure(
                            plan, p_key, chan_idx, channels, src_key=src_key
                        )
                        if rig is not None and p_key in self._exposures:
                            # Apply the selected laser power to the AE
                            # channel's excitation line (the reference
                            # writes laser_powers_per_well before each
                            # well, archive acq_engine.py:1188-1197).
                            ae_channel = (
                                plan.autoexposure.channel or channels[0]
                            )
                            rig.set_laser_power(
                                ae_channel, self._exposures[p_key][1]
                            )
                    if self._tracking is not None:
                        self._tracking.record_acquisition(t, p_key)
                    if rig is not None:
                        # One hardware-sequenced burst per (t, p): start
                        # the chained channel/z counters (the reference's
                        # post-camera hook, archive acq_engine.py:1274).
                        rig.on_burst_start()
                    for ci, c_src in enumerate(chan_idx):
                        if camera is not None:
                            # Frame-level event loop: one SequencedBurst per
                            # (t, p, c) queues the z sweep; each snap pops
                            # one slice exactly as a hardware-triggered
                            # burst (reference replay_camera.py:470-521).
                            from shrimpy_tpu_torch.engine.replay import (
                                AcqEvent,
                                SequencedBurst,
                            )

                            camera.set_stage_offset_px(offset)
                            camera.on_event(
                                SequencedBurst(
                                    events=[
                                        AcqEvent(
                                            t=t,
                                            channel=channels[ci],
                                            position=src_key,
                                            z_index=int(z),
                                        )
                                        for z in z_idx
                                    ]
                                )
                            )
                            vol = np.stack(
                                [camera.snap() for _ in range(nz)]
                            ).astype(np.float32)
                        else:
                            vol = self.source.volume(
                                src_key, t, c_src, offset_px_zyx=offset
                            )[z_idx].astype(np.float32)
                        exp_ms = self._effective_exposure_ms(
                            plan, p_key, ci, channels, ch_exposure
                        )
                        exp_scale = exp_ms / plan.source_exposure_ms
                        if exp_scale != 1.0:
                            vol = vol * np.float32(exp_scale)
                        if plan.camera.model_acquisition:
                            # Charge the z burst its modeled camera time
                            # (n_slices / slice_rate, plus one channel
                            # change per TRANSITION — (n_channels - 1)
                            # per burst, reference acq_engine.py:540-598,
                            # 1553-1562) so replay pacing feeds the same
                            # per-timepoint latency budget as the live
                            # engine. Timing uses the PHYSICAL exposure:
                            # laser power scales brightness, not burst
                            # time (and a below-nominal power must not
                            # trip the lightsheet readout assert).
                            phys_ms = self._physical_exposure_ms(
                                plan, p_key, ci, channels, ch_exposure
                            )
                            acq_s = plan.camera.volume_time_s(
                                nz, phys_ms, channel_change=(ci > 0)
                            )
                            # Journal the rate actually charged when
                            # autoexposure moved it off the configured
                            # rate — per (position, channel): rates can
                            # differ per well.
                            rate = plan.camera.slice_rate_hz(phys_ms)
                            if rig is not None:
                                # Per-channel z-counter rate update (the
                                # reference updates the LS Z counter per
                                # channel, archive acq_engine.py:565-598).
                                rig.on_channel(channels[ci], rate)
                            if rate != camera_rate_hz.get(channels[ci]):
                                camera_effective_rate_hz[
                                    f"{p_key}|{channels[ci]}"
                                ] = rate
                            camera_acq_total_s += acq_s
                            if plan.camera.time_scale > 0:
                                time.sleep(acq_s * plan.camera.time_scale)
                        out_pos.write((t, ci), vol)
                        n_volumes += 1
                        for hook in self.viewer_hooks:
                            self._safe_hook(hook, vol, t, p_key, channels[ci])
                        if (
                            self._tracking is not None
                            and ci == self._track_channel_idx
                        ):
                            self._tracking.on_stack_complete(vol, t, p_key)
                    # Periodic remote-refocus (archive acq_engine.py:892-1151):
                    # re-center z on the in-focus slice of the acquired stack.
                    if (
                        plan.refocus.enabled
                        and t % plan.refocus.interval_timepoints == 0
                    ):
                        n_ev = len(self._refocus_events)
                        self._run_refocus(
                            plan, vol, t, p_key, channels, z_idx,
                            src_key=src_key, offset=offset,
                        )
                        if rig is not None and len(self._refocus_events) > n_ev:
                            # Drive the O3 piezo by the correction the
                            # refocus just journaled (compensated KIM101
                            # move, microscope_operations.py:334-358).
                            rig.refocus_move(self._refocus_events[-1][2])
                    visit_s = time.monotonic() - t_pos_start
                    if visit_s > plan.watchdog_s:
                        # Stall watchdog (archive acq_engine.py:1567-1616):
                        # flag visits that blow the budget so the operator
                        # can abort/retune instead of silently falling behind.
                        logger.error(
                            "watchdog: position %s at t=%d took %.1fs (> %.0fs)",
                            p_key, t, visit_s, plan.watchdog_s,
                        )
                if aborted_at is not None:
                    break

        except BaseException as e:  # noqa: BLE001 — re-raised after teardown
            run_error = repr(e)
            raise
        finally:
            self.aborted_at = aborted_at
            if aborted_at is not None:
                logger.warning(
                    "acquisition %s aborted by run control at t=%d%s "
                    "(volumes so far remain on disk; summary records the cut)",
                    final_name, aborted_at[0],
                    f" position={aborted_at[1]}" if aborted_at[1] else "",
                )
            if self._tracking is not None:
                try:
                    self._tracking.drain_pending()
                    self._tracking.shutdown()
                except Exception:
                    logger.exception("tracking teardown failed")

            hardware_summary = None
            if rig is not None:
                try:
                    if aborted_at is not None:
                        # Stop sequences + counters like the reference's
                        # abort_acquisition_sequence
                        # (microscope_operations.py:594-616).
                        rig.on_abort()
                    rig.run_end()
                    hardware_summary = rig.summary()
                except Exception:
                    logger.exception("hardware rig teardown failed")
            summary = {
                "name": final_name,
                "plan": plan.model_dump(),
                "positions": positions,
                "channels": channels,
                "shape_tczyx": list(shape),
                "mode": plan.mode,
                "z_indices": [int(z) for z in z_idx],
                "z_scale_um": float(out_z_um),
                "channel_exposures_ms": {
                    c: e for c, e in zip(channels, ch_exposure)
                },
                "stage_position_grid": (
                    [
                        [g.key, list(g.offset_px_yx)]
                        for g in grid.values()
                    ]
                    if grid is not None
                    else None
                ),
                "skipped_autofocus": [[t, p] for t, p in skipped],
                "interval_overruns": [[t, round(s, 3)] for t, s in overruns],
                "refocus_events": [[t, p, d] for t, p, d in self._refocus_events],
                # TOTAL accumulated offsets (restored + this chunk's):
                # chunk restore reads this, so offsets survive 3+ chunks
                # (summing only the latest chunk's events would drop
                # whatever IT had restored).
                "refocus_total_z": {
                    p: int(v) for p, v in self._refocus_z.items()
                },
                "exposures": {
                    p: [e, pw] for p, (e, pw) in self._exposures.items()
                },
                # Per-move stage timing (reference speed rule,
                # mantis_engine.py:285-324): rows of
                # [t, position, distance_um, speed_mm_s, move_s].
                "stage_moves": stage_moves,
                "stage_move_s": round(stage_move_total_s, 3),
                # Camera acquisition model (reference slice-rate rule,
                # archive acq_engine.py:540-598): per-channel z-slice
                # rates at the configured exposures, and the total
                # modeled acquisition seconds charged this run.
                "camera_slice_rate_hz": {
                    c: round(r, 3) for c, r in camera_rate_hz.items()
                },
                # "position|channel" -> the rate actually charged where
                # autoexposure moved it off the configured rate above.
                "camera_effective_rate_hz": {
                    k: round(r, 3)
                    for k, r in camera_effective_rate_hz.items()
                },
                "camera_acq_s": round(camera_acq_total_s, 3),
                # Instrument-rig device journal (lasers / shutter / O3
                # piezo / DAQ bursts; the reference logs the final O3
                # position for chunk restore, archive
                # acq_engine.py:478-481). None when hardware is off.
                "hardware": hardware_summary,
                "volumes_acquired": n_volumes,
                "aborted_at": aborted_at,
                "error": run_error,
                "paused_s": round(paused_s, 3),
                "wall_time_s": round(time.monotonic() - t_start, 3),
                # Software provenance (reference _logging.py:92-136
                # logs the conda env for reproducibility).
                "environment": _environment_provenance(),
            }
            try:
                with open(
                    output_dir / f"{final_name}_summary_metadata.json", "w"
                ) as f:
                    json.dump(summary, f, indent=2)
            except Exception:
                logger.exception("summary sidecar write failed")
            if run_error is None:
                logger.info(
                    "acquisition %s complete: %d volumes, %d skipped",
                    final_name,
                    n_volumes,
                    len(skipped),
                )
            else:
                logger.error(
                    "acquisition %s failed after %d volumes: %s",
                    final_name, n_volumes, run_error,
                )
            if log_file:
                from shrimpy_tpu_torch.utils.logging import release_log_file

                release_log_file(log_file)
        return out_path

    # -- helpers -------------------------------------------------------------
    def _restore_refocus_from_previous(
        self, output_dir: Path, base_name: str, final_name: str
    ) -> None:
        """Seed refocus offsets from the latest earlier chunk's summary."""
        candidates = []
        for f in output_dir.glob(f"{base_name}*_summary_metadata.json"):
            stem = f.name.replace("_summary_metadata.json", "")
            # Only the auto-increment family counts as previous chunks:
            # base or base_<digits> ('plate_ctrl' must not seed 'plate').
            suffix = stem[len(base_name):]
            is_chunk = suffix == "" or (
                suffix.startswith("_") and suffix[1:].isdigit()
            )
            if stem != final_name and is_chunk:
                candidates.append(f)
        if not candidates:
            return
        latest = max(candidates, key=lambda f: f.stat().st_mtime)
        try:
            summary = json.loads(latest.read_text())
        except (OSError, json.JSONDecodeError):
            logger.warning("could not read previous chunk summary %s", latest)
            return
        totals = summary.get("refocus_total_z")
        if totals is not None:
            # Totals carry restored + own offsets across any chunk count.
            for p, total in totals.items():
                self._refocus_z[p] = int(total)
        else:
            # Older summaries: fall back to this chunk's own events
            # (lossy past two chunks, but the best available record).
            for t, p, delta in summary.get("refocus_events", []):
                self._refocus_z[p] = self._refocus_z.get(p, 0) + int(delta)
        if self._refocus_z:
            logger.info(
                "restored refocus offsets from %s: %s", latest.name, self._refocus_z
            )

    def _effective_exposure_ms(
        self, plan, p_key: str, ci: int, channels, ch_exposure
    ) -> float:
        """Exposure driving this (position, channel)'s brightness:
        the autoexposure result (exposure x relative laser power) when
        it selected one for this position's autoexposure channel, else
        the ChannelPlan's declared exposure."""
        ae = plan.autoexposure
        if ae.enabled and p_key in self._exposures:
            ae_name = ae.channel or channels[0]
            if channels[ci] == ae_name:
                exposure, power = self._exposures[p_key]
                return exposure * (power / NOMINAL_LASER_POWER)
        return ch_exposure[ci]

    def _physical_exposure_ms(
        self, plan, p_key: str, ci: int, channels, ch_exposure
    ) -> float:
        """Exposure the camera physically integrates for (timing model
        input): the autoexposure-selected exposure WITHOUT the laser-
        power brightness ratio — changing laser power does not change
        burst timing, and a below-nominal power must not push a valid
        lightsheet exposure under the sensor readout."""
        ae = plan.autoexposure
        if ae.enabled and p_key in self._exposures:
            ae_name = ae.channel or channels[0]
            if channels[ci] == ae_name:
                return self._exposures[p_key][0]
        return ch_exposure[ci]

    def _run_autoexposure(
        self, plan, p_key: str, chan_idx, channels, *, src_key: str | None = None
    ) -> None:
        from shrimpy_tpu_torch.engine.autoexposure import (
            ALGORITHMS,
            AutoexposureSettings,
            autoexpose_with_escalation,
            load_manual_exposures,
        )

        ae = plan.autoexposure
        if ae.algorithm == "manual":
            if not ae.manual_csv:
                raise ValueError("autoexposure algorithm 'manual' needs manual_csv")
            # Parse once per run, not once per position: the table is
            # the same file for every well, and a mid-run edit silently
            # diverging between positions would be worse than stale.
            cache_key = ("manual_ae", str(ae.manual_csv))
            table = getattr(self, "_manual_ae_cache", None)
            if table is None or table[0] != cache_key:
                table = (cache_key, load_manual_exposures(ae.manual_csv))
                self._manual_ae_cache = table
            table = table[1]
            well = p_key.rsplit("/", 1)[0].replace("/", "") or p_key
            if well in table or p_key in table:
                self._exposures[p_key] = table.get(p_key, table.get(well))
            return
        if ae.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown autoexposure algorithm {ae.algorithm!r}")
        settings = AutoexposureSettings(**ae.settings)
        c = (
            self.source.channel_index(ae.channel)
            if ae.channel is not None
            else chan_idx[0]
        )
        base = self.source.volume(src_key or p_key, 0, c)
        mid = base[base.shape[0] // 2].astype(np.float64)
        nominal_power = NOMINAL_LASER_POWER

        def acquire(exposure_ms, laser_power):
            # Replay camera model: recorded brightness corresponds to
            # the SOURCE recording's exposure (plan.source_exposure_ms)
            # at nominal power. The same model drives the written
            # volumes via _effective_exposure_ms — using any other
            # baseline here would make autoexposure pick an operating
            # point the replay then renders at a different brightness.
            scale = (exposure_ms / plan.source_exposure_ms) * (
                laser_power / nominal_power
            )
            return mid * scale

        exposure, power, converged = autoexpose_with_escalation(
            acquire, settings, algorithm=ae.algorithm, laser_power=nominal_power
        )
        self._exposures[p_key] = (exposure, power)
        logger.info(
            "autoexposure %s: exposure=%.2f ms power=%.1f converged=%s",
            p_key, exposure, power, converged,
        )

    def _run_refocus(
        self,
        plan,
        last_vol,
        t: int,
        p_key: str,
        channels,
        z_idx,
        *,
        src_key: str | None = None,
        offset: tuple[int, int, int] | None = None,
    ) -> None:
        from shrimpy_tpu_torch.engine.autofocus import focus_from_transverse_band

        rf = plan.refocus
        # The focus metric runs on rf.channel, defaulting to the FIRST
        # acquired channel (plan.py's documented contract) — last_vol is
        # the LAST channel of the visit, only reusable when it happens
        # to be the metric channel.
        metric_channel = rf.channel or channels[0]
        if metric_channel not in channels:
            raise ValueError(
                f"refocus.channel={metric_channel!r} is not among the "
                f"acquired channels {channels}"
            )
        if metric_channel == channels[-1]:
            vol = last_vol
        else:
            c = self.source.channel_index(metric_channel)
            vol = self.source.volume(
                src_key or p_key,
                t,
                c,
                offset_px_zyx=(
                    offset
                    if offset is not None
                    else self._stage_offset_px(p_key)
                ),
            )[z_idx]
        idx = focus_from_transverse_band(
            vol,
            pixel_size_um=self.source.zyx_scale[1],
            wavelength_um=rf.wavelength_um,
            na_det=rf.na_det,
            threshold=rf.threshold,
            device=self.device,
        )
        if idx is None:
            logger.warning("refocus: no prominent focus at t=%d p=%s", t, p_key)
            return
        # The metric ran on the STRIDED stack (z_idx may skip source
        # slices under ZPlan.step_um), but _refocus_z is applied as a
        # SOURCE-slice roll — convert strided-slice drift to source
        # slices or every correction under-corrects by the stride.
        z_stride = int(z_idx[1] - z_idx[0]) if len(z_idx) > 1 else 1
        delta = (idx - vol.shape[0] // 2) * z_stride
        if delta:
            self._refocus_z[p_key] = self._refocus_z.get(p_key, 0) + int(delta)
            self._refocus_events.append((t, p_key, int(delta)))
            logger.info(
                "refocus: t=%d p=%s in-focus slice %d -> z offset %+d "
                "(total %+d)",
                t, p_key, idx, delta, self._refocus_z[p_key],
            )

    def _stage_offset_px(self, p_key: str) -> tuple[int, int, int]:
        """Current corrected stage position -> pixel offset (ZYX),
        including accumulated remote-refocus z."""
        z_extra = self._refocus_z.get(p_key, 0)
        # A shared stage store (dual-arm) feeds offsets even to an arm
        # that runs no tracking of its own: the tracking arm's
        # corrections move this arm too.
        store = (
            self._tracking.store
            if self._tracking is not None
            else self._position_store
        )
        if store is None:
            return (z_extra, 0, 0)
        pos = store.get(p_key)
        if pos is None:
            if self._tracking is not None:
                store.set(p_key, 0.0, 0.0, 0.0)
            return (z_extra, 0, 0)
        sz, sy, sx = self.source.zyx_scale
        return (
            int(round(pos.z / sz)) + z_extra,
            int(round(pos.y / sy)),
            int(round(pos.x / sx)),
        )

    @staticmethod
    def _safe_hook(hook, vol, t, p, channel) -> None:
        """Viewer hooks never raise into the acquisition (reference
        ``feeder.py:9-13``)."""
        try:
            hook(vol, t, p, channel)
        except Exception:
            logger.exception("viewer hook failed (ignored)")
