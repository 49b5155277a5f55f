"""``shrimpy-tpu-torch`` CLI: the reconstruction and acquisition verbs of the
port, all 16 of the JAX CLI's (its 14 commands, ``plan`` counted as its
three: ``new``, ``validate``, ``show``).

The verbs ``deskew``, ``deconvolve``, ``phase``, ``reconstruct``, ``register``,
``track``, ``replay``, ``replay-dual``, ``measure-psf`` and ``train-vs`` take
the same options and YAML as ``shrimpy_tpu/cli/main.py``, plus ``--device``
(default ``cuda``); the store verbs' ``--devices N --space S`` run a
``(N / S, S)`` mesh of ranks (``_run_reconstruct``); ``replay --viewer`` streams each volume to the port's
live monitor (``viewer/``), and ``monitor`` (a store's progress, or
``--live`` attached to a running acquisition's ring, ``--serve`` for the
browser) is the JAX verb with its helpers ``_start_web`` and
``_monitor_live``, statement for statement, but that store mode draws its
PNGs only where matplotlib imports (:func:`_pyplot`); ``info``
and ``microscopes`` print the JAX CLI's JSON, and ``plan new | validate |
show`` write, check and print acquisition plans (``engine/plan.py``) as the
JAX CLI does. Pixel size and z step come from the store's scale
metadata and are injected into the settings, as in the JAX CLI. The
settings are the port's own pydantic models
(:mod:`shrimpy_tpu_torch.config.schemas`, a copy of the JAX package's:
one YAML runs on both packages); the port reads them by attribute.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import click


@click.group()
@click.version_option(version="0.1.0", prog_name="shrimpy-tpu-torch")
@click.option("-v", "--verbose", is_flag=True, help="DEBUG-level logging.")
def cli(verbose: bool) -> None:
    """PyTorch + CUDA reconstruction engine for mantis OME-Zarr datasets."""
    from shrimpy_tpu_torch.utils.logging import configure_logging

    configure_logging(level=logging.DEBUG if verbose else logging.INFO)


def _channel_index(names: list, channel: str) -> int:
    """Channel index, or a click error listing the available names."""
    try:
        return names.index(channel)
    except ValueError:
        raise click.ClickException(f"channel {channel!r} not in the store (has {names})") from None


def _device_or_exit(device: str):
    from shrimpy_tpu_torch.utils.device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as exc:
        raise click.ClickException(str(exc)) from None


def _inject_from_store(settings, input_path: Path) -> tuple:
    """Read (pixel size, z step) from the store scale and inject; returns
    the store and its first position."""
    from shrimpy_tpu_torch.config.schemas import inject_derived_parameters
    from shrimpy_tpu_torch.io.ngff import open_ngff

    store = open_ngff(input_path)
    pos = store.position()
    sz, sy, _ = pos.zyx_scale
    inject_derived_parameters(settings, pixel_size_um=sy, z_step_um=sz)
    return store, pos


def _store_rank(input, output, settings, batch, resume, *, mesh):
    """One rank of a ``--devices N`` run that this process spawned."""
    from shrimpy_tpu_torch.runtime.stream import reconstruct_store

    return reconstruct_store(input, output, settings, mesh=mesh, batch_size=batch, resume=resume)


def _run_reconstruct(
    input, output, settings, devices, space, batch, resume, profile_dir, device
):
    """JAX's ``_run_reconstruct`` with the port's process model: under
    torchrun (``WORLD_SIZE`` set) this process is one rank and
    ``--devices`` must be the world size; otherwise ``--devices N > 1``
    spawns N local ranks (gloo on the CPU with ``--device cpu``, NCCL on
    the cards ``cuda:0..N-1``), and ``--devices 1`` runs a one-device
    mesh here. Rank 0 prints the summary."""
    import os

    from shrimpy_tpu_torch.parallel.launch import RankError, resolve_launch, spawn
    from shrimpy_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from shrimpy_tpu_torch.runtime.stream import reconstruct_store
    from shrimpy_tpu_torch.utils.timing import profiler_trace

    dev = _device_or_exit(device)
    if space > 1 and not devices:
        raise click.ClickException(
            f"--space {space} needs --devices N (a multiple of {space}): the mesh's X "
            "sharding runs over N devices")
    _inject_from_store(settings, Path(input))
    cpu = dev is not None and dev.type == "cpu"
    world = os.environ.get("WORLD_SIZE")
    try:
        with profiler_trace(profile_dir):
            if world is not None and (devices or 1) != int(world):
                raise click.ClickException(
                    f"--devices {devices} under torchrun with WORLD_SIZE={world}: launch one "
                    "rank a device, e.g. `torchrun --nproc-per-node N -m "
                    "shrimpy_tpu_torch.cli.main reconstruct ... --devices N`")
            if world is not None and int(world) > 1:
                init_distributed(backend="gloo" if cpu else "nccl")
                mesh = make_mesh(devices, space=space,
                                 devices=["cpu"] * devices if cpu else None)
                summary = reconstruct_store(input, output, settings, mesh=mesh,
                                            batch_size=batch, resume=resume)
                if mesh.rank != 0:
                    return
            elif devices and devices > 1:
                try:
                    backend, devs = resolve_launch(devices, "gloo" if cpu else None,
                                                   ["cpu"] * devices if cpu else None)
                except ValueError as exc:
                    raise click.ClickException(str(exc)) from None
                summary = spawn(_store_rank, devices, space=space, backend=backend,
                                devices=devs, args=(input, output, settings, batch, resume))
            elif devices == 1:
                mesh = make_mesh(1, space=space, devices=[dev or "cuda"])
                summary = reconstruct_store(input, output, settings, mesh=mesh,
                                            batch_size=batch, resume=resume)
            else:
                summary = reconstruct_store(input, output, settings, batch_size=batch,
                                            resume=resume, device=device)
    except (NotImplementedError, RankError) as exc:
        raise click.ClickException(str(exc)) from None
    click.echo(json.dumps(summary, indent=2))


_shared = [
    click.argument("input", type=click.Path(exists=True)),
    click.option("-o", "--output", required=True, type=click.Path()),
    click.option("--devices", type=int, default=None, help="Mesh device count."),
    click.option("--space", type=int, default=1, help="X-axis sharding factor."),
    click.option("--batch", type=int, default=None, help="Volumes per step."),
    click.option("--resume", is_flag=True, help="Skip completed volumes."),
    click.option("--profile", "profile_dir", type=click.Path(), default=None,
                 help="Write a torch.profiler trace to this directory."),
    click.option("--device", default="cuda", show_default=True,
                 help="Torch device: 'cuda', 'cuda:N' or 'cpu'."),
]


def shared_options(f):
    for opt in reversed(_shared):
        f = opt(f)
    return f


@cli.command()
@shared_options
@click.option("--ls-angle-deg", type=float, default=None,
              help="Light-sheet tilt; default = the microscope profile's angle.")
@click.option("--px-to-scan-ratio", type=float, default=None)
@click.option("--keep-overhang", is_flag=True)
@click.option("--average-n-slices", type=int, default=1, show_default=True)
@click.option("--microscope", default="mantis", show_default=True,
              help="Profile supplying the instrument's optical defaults.")
def deskew(
    input, output, devices, space, batch, resume, profile_dir, device,
    ls_angle_deg, px_to_scan_ratio, keep_overhang, average_n_slices, microscope,
):
    """Deskew every volume of an OME-Zarr store."""
    from shrimpy_tpu_torch.config.microscopes import get_microscope
    from shrimpy_tpu_torch.config.schemas import DeskewSettings, ReconstructSettings

    try:
        prof = get_microscope(microscope)
    except KeyError as exc:
        raise click.ClickException(str(exc)) from None
    if not prof.implemented:
        raise click.ClickException(
            f"{prof.name} support is not yet implemented. Coming soon!"
        )
    if ls_angle_deg is None:
        if prof.ls_angle_deg is None:
            raise click.ClickException(
                f"microscope {microscope!r} declares no light-sheet "
                "angle; pass --ls-angle-deg"
            )
        ls_angle_deg = prof.ls_angle_deg
    settings = ReconstructSettings(
        deskew=DeskewSettings(
            ls_angle_deg=ls_angle_deg,
            px_to_scan_ratio=px_to_scan_ratio,
            keep_overhang=keep_overhang,
            average_n_slices=average_n_slices,
        )
    )
    _run_reconstruct(input, output, settings, devices, space, batch, resume,
                     profile_dir, device)


@cli.command()
@shared_options
@click.option("--psf", "psf_path", type=click.Path(exists=True), default=None,
              help="PSF volume (.npy or OME-Zarr); default synthetic.")
@click.option("--iterations", type=int, default=20, show_default=True)
@click.option("--algorithm",
              type=click.Choice(["auto", "fft", "separable", "hybrid"]),
              default="auto", show_default=True,
              help="'hybrid' warm-starts the exact FFT path with cheap separable "
              "iterations on a nonnegative rank-K PSF (non-separable PSFs).")
def deconvolve(
    input, output, devices, space, batch, resume, profile_dir, device,
    psf_path, iterations, algorithm,
):
    """Richardson-Lucy deconvolve every volume of an OME-Zarr store."""
    from shrimpy_tpu_torch.config.schemas import DeconvolveSettings, ReconstructSettings

    settings = ReconstructSettings(
        deconvolve=DeconvolveSettings(
            psf_path=psf_path, iterations=iterations, algorithm=algorithm
        )
    )
    _run_reconstruct(input, output, settings, devices, space, batch, resume,
                     profile_dir, device)


@cli.command()
@shared_options
@click.option("--config", "config_path", type=click.Path(exists=True), default=None,
              help="PhaseSettings YAML (transfer_function / apply_inverse).")
def phase(input, output, devices, space, batch, resume, profile_dir, device, config_path):
    """3-D phase reconstruction of brightfield defocus stacks."""
    from shrimpy_tpu_torch.config.schemas import (
        PhaseSettings,
        ReconstructSettings,
        load_yaml_config,
    )

    phase_settings = (
        load_yaml_config(config_path, PhaseSettings) if config_path else PhaseSettings()
    )
    settings = ReconstructSettings(phase=phase_settings)
    _run_reconstruct(input, output, settings, devices, space, batch, resume,
                     profile_dir, device)


@cli.command()
@shared_options
@click.option("-c", "--config", "config_path", type=click.Path(exists=True),
              required=True,
              help="ReconstructSettings YAML, or a multi-arm file with a "
                   "top-level 'arms:' mapping (per-arm output stores).")
def reconstruct(input, output, devices, space, batch, resume, profile_dir, device,
                config_path):
    """Run the configured pipeline (deskew/phase/register/deconvolve)."""
    import yaml

    from shrimpy_tpu_torch.config.schemas import (
        ReconstructArms,
        ReconstructSettings,
        load_yaml_config,
    )

    with open(config_path) as f:
        raw_cfg = yaml.safe_load(f) or {}
    if "arms" in raw_cfg:
        arms = ReconstructArms(**raw_cfg)
        out = Path(output)
        for arm_name, settings in arms.arms.items():
            arm_out = out.with_name(f"{out.stem}_{arm_name}.zarr")
            click.echo(f"== arm {arm_name} -> {arm_out}")
            _run_reconstruct(input, arm_out, settings, devices, space, batch,
                             resume, profile_dir, device)
        return
    settings = load_yaml_config(config_path, ReconstructSettings)
    _run_reconstruct(input, output, settings, devices, space, batch, resume,
                     profile_dir, device)


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("--fixed-channel", required=True)
@click.option("--moving-channel", required=True)
@click.option("--moving-input", type=click.Path(exists=True), default=None,
              help="Store holding the moving channel (defaults to INPUT): the "
                   "dual-arm case registers the lightsheet store against the "
                   "labelfree store.")
@click.option("-o", "--output", type=click.Path(), required=True,
              help="Output JSON transform file.")
@click.option("--timepoint", type=int, default=0, show_default=True)
@click.option("--method", type=click.Choice(["pcc", "pcc+refine"]),
              default="pcc+refine", show_default=True)
@click.option("--device", default="cuda", show_default=True,
              help="Torch device: 'cuda', 'cuda:N' or 'cpu'.")
def register(input, fixed_channel, moving_channel, moving_input, output, timepoint, method,
             device):
    """Estimate the affine transform aligning a moving channel onto a
    fixed channel (same store or a sibling arm store)."""
    import numpy as np
    import torch

    from shrimpy_tpu_torch.config.schemas import RegistrationSettings
    from shrimpy_tpu_torch.io.ngff import open_ngff
    from shrimpy_tpu_torch.ops.register import estimate_registration
    from shrimpy_tpu_torch.utils.fft import match_shape

    dev = _device_or_exit(device)
    pos = open_ngff(input).position()
    mov_pos = open_ngff(moving_input).position() if moving_input else pos
    fixed = pos.volume(timepoint, _channel_index(pos.channel_names, fixed_channel))
    moving = mov_pos.volume(timepoint, _channel_index(mov_pos.channel_names, moving_channel))
    fixed = torch.from_numpy(np.ascontiguousarray(fixed)).to(dev)
    moving = torch.from_numpy(np.ascontiguousarray(moving)).to(dev)
    if moving.shape != fixed.shape:
        # Cross-arm volumes may differ in extent: match on the fixed grid
        # (zero-pad / center-crop) before estimating.
        moving = match_shape(moving, tuple(fixed.shape), mode="constant")
    result = estimate_registration(fixed, moving, RegistrationSettings(method=method))
    transform = {
        "matrix_zyx": result.matrix.tolist(),
        "offset_zyx": result.offset.tolist(),
        "translation_seed_zyx": result.translation_seed.tolist(),
        "final_loss": result.final_loss,
        "fixed_channel": fixed_channel,
        "moving_channel": moving_channel,
    }
    Path(output).write_text(json.dumps(transform, indent=2))
    click.echo(json.dumps(transform, indent=2))


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("-c", "--config", "config_path", type=click.Path(exists=True),
              required=True, help="DynaTrackConfig YAML.")
@click.option("-o", "--output", type=click.Path(), default="shifts.csv",
              show_default=True, help="Shift journal CSV.")
@click.option("--device", default="cuda", show_default=True,
              help="Torch device: 'cuda', 'cuda:N' or 'cpu'.")
def track(input, config_path, output, device):
    """Run DynaTrack shift estimation over a time-lapse store."""
    import numpy as np

    from shrimpy_tpu_torch.config.schemas import DynaTrackConfig, load_yaml_config
    from shrimpy_tpu_torch.tracking import ShiftJournal, Tracker

    dev = _device_or_exit(device)
    cfg = load_yaml_config(config_path, DynaTrackConfig)
    store, pos = _inject_from_store(cfg, Path(input))
    # With a preprocessing chain, the tracker consumes the processed
    # product of the INPUT channel; otherwise the tracking channel is
    # read directly from the store.
    preprocessor = None
    track_scale = tuple(float(v) for v in pos.zyx_scale)
    if cfg.preprocessing:
        from shrimpy_tpu_torch.tracking.preprocess import Preprocessor

        preprocessor = Preprocessor(cfg, device=dev)
        c = _channel_index(pos.channel_names, cfg.input_channel)
        # Deskew changes the voxel grid: px->um conversion and the um
        # limits must use the PROCESSED stack's scale.
        track_scale = preprocessor.tracking_scale_zyx(
            tuple(pos.shape[2:]), track_scale
        )
    else:
        c = _channel_index(pos.channel_names, cfg.tracking_channel)
    tracker = Tracker(cfg, scale_zyx_um=track_scale, journal=ShiftJournal(output), device=dev)
    for key, p in store.positions().items():
        for t in range(p.shape[0]):
            stack = p.volume(t, c)
            if preprocessor is not None:
                stack = preprocessor.tracking_stack(stack)
            r = tracker.update(stack, t=t, p=key)
            click.echo(
                f"t={t} p={key} shift_px={np.round(r.shift_px_zyx, 2).tolist()} "
                f"stage_um={np.round(r.stage_shift_xyz, 3).tolist()}"
            )
    click.echo(f"journal: {output}")


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("-o", "--output-dir", required=True, type=click.Path())
@click.option("-n", "--name", default="replay", show_default=True)
@click.option("--plan", "plan_path", type=click.Path(exists=True), default=None,
              help="AcquisitionPlan YAML; default replays the full source.")
@click.option("--viewer/--no-viewer", default=False,
              help="Stream frames to the live monitor subprocess "
                   "(PNG previews under <output>/preview).")
@click.option("--viewer-cache-mb", type=float, default=512.0, show_default=True,
              help="Shared-memory ring budget for the viewer.")
@click.option("--microscope", default="mantis", show_default=True,
              help="Registered microscope profile (see `microscopes`).")
@click.option("--device", default="cuda", show_default=True,
              help="Torch device of the tracking and refocus: 'cuda', 'cuda:N' or 'cpu'.")
def replay(input, output_dir, name, plan_path, viewer, viewer_cache_mb, microscope, device):
    """Replay a pre-acquired dataset through the acquisition engine
    (hardware-free demo mode, the reference's ReplayCamera role)."""
    from shrimpy_tpu_torch.config.microscopes import get_microscope

    try:
        profile = get_microscope(microscope)
    except KeyError as exc:
        raise click.ClickException(str(exc)) from None
    if not profile.implemented:
        click.echo(click.style(
            f"{profile.name} acquisition is not yet implemented. "
            "Coming soon!", fg="yellow",
        ))
        return
    dev = _device_or_exit(device)
    from shrimpy_tpu_torch.engine import AcquisitionEngine, AcquisitionPlan, ReplaySource

    source = ReplaySource(input)
    plan = (
        AcquisitionPlan.from_yaml(plan_path)
        if plan_path
        else AcquisitionPlan(time={"n_timepoints": source.n_timepoints})
    )
    feeder = None
    hooks = []
    if viewer:
        from shrimpy_tpu_torch.viewer import ViewerFeeder

        ny, nx = source.shape_tczyx[3:]
        feeder = ViewerFeeder(
            frame_shape=(ny, nx),
            cache_mb=viewer_cache_mb,
            preview_dir=Path(output_dir) / "preview",
            # Ring floor: at least one whole volume must stay resident
            # or the seq check evicts everything (feeder.py).
            n_z=source.shape_tczyx[2],
        )
        feeder.start()
        hooks.append(feeder.on_volume)
    from shrimpy_tpu_torch.engine.control import RunControl

    control = RunControl(Path(output_dir) / "run_control.json")
    click.echo(
        f"run control: {control.path} "
        '(write {"command": "pause" | "run" | "abort"})'
    )
    engine = AcquisitionEngine(source, device=dev, viewer_hooks=hooks)
    try:
        out = engine.acquire(output_dir, name, plan, run_control=control)
    finally:
        if feeder is not None:
            feeder.stop()
    if engine.aborted_at is not None:
        click.echo(click.style(
            f"aborted at t={engine.aborted_at[0]} (partial output kept)",
            fg="yellow",
        ))
    click.echo(str(out))


@cli.command(name="replay-dual")
@click.argument("config", type=click.Path(exists=True))
@click.option("-o", "--output-dir", required=True, type=click.Path())
@click.option("-n", "--name", default="replay", show_default=True)
@click.option("--microscope", default="mantis", show_default=True,
              help="Profile whose arm inventory the config must match "
                   "(see `microscopes`).")
@click.option("--device", default="cuda", show_default=True,
              help="Torch device of every arm's tracking and refocus: 'cuda', 'cuda:N' or "
                   "'cpu'.")
def replay_dual(config, output_dir, name, microscope, device):
    """Dual-instance replay: every arm acquires simultaneously on its
    own engine + store, synchronized per timepoint and sharing one
    stage (the reference's two-MM-instance production topology,
    reference ``mantis/archive/pycromanager/acq_engine.py:98-183``).

    CONFIG is a YAML with an ``arms:`` mapping of
    ``{name: {input: <store>, plan: {...}}}`` plus an optional
    ``barrier_timeout_s``.
    """
    import yaml as _yaml

    from shrimpy_tpu_torch.config.microscopes import get_microscope
    from shrimpy_tpu_torch.engine.dual import DualArmAcquisition, DualReplayConfig
    from shrimpy_tpu_torch.engine.replay import ReplaySource

    try:
        profile = get_microscope(microscope)
    except KeyError as exc:
        raise click.ClickException(str(exc)) from None
    if not profile.implemented:
        click.echo(click.style(
            f"{profile.name} acquisition is not yet implemented. "
            "Coming soon!", fg="yellow",
        ))
        return
    dev = _device_or_exit(device)
    cfg = DualReplayConfig(**_yaml.safe_load(Path(config).read_text()))
    if profile.arms and set(cfg.arms) != set(profile.arms):
        # The arm inventory is instrument knowledge: the mantis has
        # exactly a label-free and a light-sheet arm.
        raise click.ClickException(
            f"config arms {sorted(cfg.arms)} do not match microscope "
            f"{profile.name!r} arms {sorted(profile.arms)}"
        )
    arms = {}
    for arm, a in cfg.arms.items():
        plan_a = a.plan
        cam = plan_a.camera
        if (
            profile.max_sequenced_events is not None
            and "max_sequenced_events" not in cam.model_fields_set
        ):
            # The trigger firmware's sequence length is instrument
            # knowledge; plans inherit it unless they pin their own cap.
            cam = cam.model_copy(
                update={
                    "max_sequenced_events": profile.max_sequenced_events
                }
            )
            plan_a = plan_a.model_copy(update={"camera": cam})
        if cam.model_acquisition and "mode" not in cam.model_fields_set:
            # An arm named after a camera mode inherits it unless the plan
            # says otherwise.
            from typing import get_args

            from shrimpy_tpu_torch.engine.plan import CameraPlan

            if arm in get_args(CameraPlan.model_fields["mode"].annotation):
                plan_a = plan_a.model_copy(
                    update={"camera": cam.model_copy(update={"mode": arm})}
                )
        arms[arm] = (ReplaySource(a.input), plan_a)
    from shrimpy_tpu_torch.engine.control import RunControl

    control = RunControl(Path(output_dir) / "run_control.json")
    click.echo(
        f"run control: {control.path} "
        '(write {"command": "pause" | "run" | "abort"}; applies to '
        "every arm at the timepoint barrier)"
    )
    session = DualArmAcquisition(
        arms, barrier_timeout_s=cfg.barrier_timeout_s, run_control=control, device=dev
    )
    results = session.run(output_dir, name)
    failed = [r for r in results.values() if r.error]
    click.echo(json.dumps({a: r.model_dump() for a, r in results.items()}))
    if failed:
        raise click.ClickException(
            f"{len(failed)}/{len(results)} arms failed"
        )


@cli.group()
def plan():
    """Author and validate acquisition plans (the headless counterpart
    of the reference's Qt acquisition widget, reference
    ``shrimpy/mantis/mantis_acquisition_widget.py``: build an MDA plan
    interactively, round-trip it to YAML, validate before running)."""


@plan.command("new")
@click.option("-o", "--output", "out_path", type=click.Path(), required=True)
@click.option("--timepoints", type=int, default=None,
              help="Skip the prompt for n_timepoints.")
@click.option("--interval-s", type=float, default=None)
@click.option("--channels", default=None,
              help="Comma-separated channel names (empty = all source).")
def plan_new(out_path, timepoints, interval_s, channels):
    """Interactively build an AcquisitionPlan YAML (prompts fill
    whatever the flags leave unset)."""
    import yaml as _yaml

    from shrimpy_tpu_torch.engine.plan import AcquisitionPlan

    if timepoints is None:
        timepoints = click.prompt("timepoints", type=int, default=1)
    if interval_s is None:
        interval_s = click.prompt(
            "timepoint interval [s] (0 = as fast as possible)",
            type=float, default=0.0,
        )
    if channels is None:
        channels = click.prompt(
            "channels (comma-separated; empty = all source channels)",
            default="", show_default=False,
        )
    chan_list = [c.strip() for c in channels.split(",") if c.strip()]
    data: dict = {"time": {"n_timepoints": timepoints, "interval_s": interval_s}}
    if chan_list:
        data["channels"] = [{"name": c} for c in chan_list]
    if click.confirm("enable demo autofocus?", default=False):
        rate = click.prompt("autofocus success rate", type=float, default=1.0)
        data["autofocus"] = {"enabled": True, "success_rate": rate}
    if click.confirm("enable drift tracking (DynaTrack)?", default=False):
        ch = chan_list[0] if chan_list else click.prompt("tracking channel")
        data["metadata"] = {"dynatrack": {
            "input_channel": ch, "tracking_channel": ch,
            "tracking_method": "pcc",
        }}
    validated = AcquisitionPlan(**data)  # fail fast before writing
    with open(out_path, "w") as f:
        _yaml.safe_dump(
            validated.model_dump(exclude_defaults=True), f, sort_keys=False
        )
    click.echo(f"plan written: {out_path}")


@plan.command("validate")
@click.argument("plan_path", type=click.Path(exists=True))
@click.option("--input", "store_path", type=click.Path(exists=True),
              default=None,
              help="Cross-check channels/positions against this store.")
def plan_validate(plan_path, store_path):
    """Validate a plan YAML (schema; with --input also against a store),
    mirroring the widget's pre-run validation."""
    from shrimpy_tpu_torch.engine.plan import AcquisitionPlan, validate_plan

    try:
        p = AcquisitionPlan.from_yaml(plan_path)
    except Exception as e:
        raise click.ClickException(f"invalid plan: {e}") from e
    source = None
    if store_path is not None:
        from shrimpy_tpu_torch.engine.replay import ReplaySource

        source = ReplaySource(store_path)
    # Single source of truth shared with the browser plan editor:
    # engine.plan.validate_plan (every check the engine fails fast on,
    # surfaced BEFORE the run).
    problems = validate_plan(p, source)
    if problems:
        raise click.ClickException("; ".join(problems))
    click.echo(json.dumps({"valid": True, "plan": str(plan_path)}))


@plan.command("show")
@click.argument("plan_path", type=click.Path(exists=True))
def plan_show(plan_path):
    """Print the fully-resolved plan (defaults filled in) as JSON."""
    from shrimpy_tpu_torch.engine.plan import AcquisitionPlan

    p = AcquisitionPlan.from_yaml(plan_path)
    click.echo(json.dumps(p.model_dump(), indent=2, default=str))


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("-o", "--output", "psf_out", type=click.Path(), required=True,
              help="Output PSF path (writes .npy + .json).")
@click.option("--geometry", type=click.Choice(["epi", "lightsheet"]),
              default="epi", show_default=True)
@click.option("--ls-angle-deg", type=float, default=30.0, show_default=True)
@click.option("--threshold-percentile", type=float, default=99.5, show_default=True)
@click.option("--device", default="cuda", show_default=True,
              help="Torch device of the light-sheet deskew: 'cuda', 'cuda:N' or 'cpu'.")
def measure_psf(input, psf_out, geometry, ls_angle_deg, threshold_percentile, device):
    """Measure a PSF from a bead z-stack store (deskews light-sheet data)."""
    from shrimpy_tpu_torch.config.schemas import DeskewSettings
    from shrimpy_tpu_torch.io.ngff import open_ngff
    from shrimpy_tpu_torch.psf import measure_psf as _measure

    dev = _device_or_exit(device)
    deskew_settings = None
    if geometry == "lightsheet":
        pos = open_ngff(input).position()
        sz, sy, _ = pos.zyx_scale
        deskew_settings = DeskewSettings(
            ls_angle_deg=ls_angle_deg, pixel_size_um=sy, scan_step_um=sz
        )
    report = _measure(
        input, psf_out, geometry=geometry, deskew=deskew_settings,
        threshold_percentile=threshold_percentile, device=dev,
    )
    click.echo(json.dumps(report.as_dict(), indent=2))


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("--preview-dir", type=click.Path(), default=None,
              help="Directory for preview PNGs (default: <input>/_preview).")
@click.option("--interval", type=float, default=2.0, show_default=True,
              help="Refresh period in seconds.")
@click.option("--once", is_flag=True, help="Render one snapshot and exit.")
@click.option("--live", is_flag=True,
              help="Attach to a running acquisition's viewer ring "
                   "(INPUT = the feeder's preview dir, or the output dir "
                   "containing preview/ring.json) and follow the latest "
                   "volumes. view.json / deskew.json in the preview dir "
                   "scrub time and edit the deskew geometry live.")
@click.option("--ls-angle-deg", type=float, default=None,
              help="[--live] Initial deskew-preview light-sheet angle.")
@click.option("--px-to-scan-ratio", type=float, default=None,
              help="[--live] Initial deskew-preview pixel/scan ratio.")
@click.option("--serve", type=int, default=None, metavar="PORT",
              help="Serve the previews + controls to browsers on "
                   "127.0.0.1:PORT (0 = pick a free port) — the "
                   "graphical counterpart of the reference napari "
                   "viewer, usable over an SSH port-forward.")
@click.option("--plan", "plan_path", type=click.Path(exists=True),
              default=None,
              help="[--serve] Attach this plan YAML to the browser's "
                   "plan editor (edit, validate, save — the graphical "
                   "counterpart of the reference acquisition widget's "
                   "settings editor).")
@click.option("--plan-store", type=click.Path(exists=True), default=None,
              help="[--serve --plan] Cross-check edited plans against "
                   "this replay store (the `plan validate --input` "
                   "tier).")
def monitor(input, preview_dir, interval, once, live, ls_angle_deg,
            px_to_scan_ratio, serve, plan_path, plan_store):
    """Watch a (possibly growing) store: progress stats + preview PNGs.

    The headless counterpart of the reference's live napari viewer
    (reference ``shrimpy/viewer/_napari_process.py``); add ``--serve``
    for an actual browser GUI over the same control files.
    """
    if live:
        _monitor_live(
            input, preview_dir, interval, once, ls_angle_deg,
            px_to_scan_ratio, serve, plan_path=plan_path,
            plan_store=plan_store,
        )
        return
    import time as _time

    plt = _pyplot()

    from shrimpy_tpu_torch.io.ngff import open_ngff

    out_dir = Path(preview_dir) if preview_dir else Path(input) / "_preview"
    out_dir.mkdir(parents=True, exist_ok=True)
    in_path = Path(input)
    # A store-mode monitor usually points at <output_dir>/<name>.zarr;
    # the engine's run-control file sits beside the store.
    web = _start_web(
        out_dir, serve, live=False, near=[in_path.parent],
        plan_path=plan_path, plan_store=plan_store,
    )
    # Reconstruction outputs carry a progress journal sidecar; a
    # growing acquisition store doesn't, but its written chunks are on
    # disk. Both are O(positions)/O(written chunks) per tick — never
    # O(timepoints x volume) voxel scans (round-1 monitor read whole
    # volumes backwards from the end on every refresh).
    journal = in_path.with_suffix(in_path.suffix + ".progress.jsonl")
    while True:
        store = open_ngff(input)
        # Per-(position, t) channel sets via the journal's single
        # source of truth (runtime/stream.py _Progress.iter_done_keys —
        # mark_failed records are not done).
        done_c: dict[str, dict[int, set[int]]] = {}
        if journal.exists():
            from shrimpy_tpu_torch.runtime.stream import _Progress

            for pos_key, t, c in _Progress.iter_done_keys(journal):
                done_c.setdefault(pos_key, {}).setdefault(t, set()).add(c)
        status = {}
        for key, pos in store.positions().items():
            t_size, c_size = pos.shape[0], pos.shape[1]
            if key in done_c:
                by_t = done_c[key]
                # A timepoint counts written only when EVERY channel's
                # record exists (a failed channel would otherwise show
                # as a black 'latest' preview of a healthy run).
                ts_written = sorted(
                    t for t, cs in by_t.items() if len(cs) >= c_size
                )
                # Preview channel: one that is actually on disk for the
                # newest (possibly partial) timepoint.
                t_latest = max(by_t) if by_t else None
                c_prev = min(by_t[t_latest]) if t_latest is not None else 0
            else:
                ts_written = pos.written_timepoints()
                t_latest = ts_written[-1] if ts_written else None
                c_prev = 0
            status[key] = {
                "timepoints_written": len(ts_written),
                "latest": ts_written[-1] if ts_written else None,
                "of": t_size,
            }
            if t_latest is not None and plt is not None:
                # Read ONLY the mid-z plane of the latest volume.
                mid_z = pos.shape[2] // 2
                mid = pos.read((t_latest, c_prev, mid_z))
                fig, ax = plt.subplots(figsize=(4, 4))
                ax.imshow(mid, cmap="gray")
                ax.set_title(f"{key} t={t_latest} c={c_prev} mid-z")
                ax.axis("off")
                fig.savefig(
                    out_dir / f"{key.replace('/', '_')}.png",
                    dpi=72, bbox_inches="tight",
                )
                plt.close(fig)
        if web is not None:
            # Surface the progress table on the web page's /state pane;
            # atomic publish — the server reads it concurrently.
            from shrimpy_tpu_torch.utils.fileio import atomic_write_text

            atomic_write_text(
                out_dir / "state.json", json.dumps(status, indent=2)
            )
        click.echo(json.dumps(status))
        if once:
            break
        _time.sleep(interval)
    if web is not None:
        web.stop()


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    missing (the ``ImportError`` logged once): store-mode ``monitor`` then
    draws no PNG and still prints its status, writes ``state.json`` and
    loops, as ``viewer/live.py`` does for the live monitor. The one
    difference from the JAX verb, which imports matplotlib unconditionally."""
    try:
        import matplotlib
    except ImportError as exc:
        logging.getLogger(__name__).warning("monitor: no preview PNGs (%s)", exc)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _start_web(out_dir, serve, *, live, near=None, plan_path=None,
               plan_store=None):
    """Start the browser UI against a preview dir (None = off).

    ``near`` are directories to search for a running acquisition's
    ``run_control.json`` (engine/control.py): when found, the page's
    pause/resume/abort buttons drive that run. ``plan_path`` attaches
    the browser plan editor; ``plan_store`` its store cross-checks.
    """
    if serve is None:
        return None
    from shrimpy_tpu_torch.viewer.web import MonitorWebServer

    run_control = None
    for d in near or ():
        cand = Path(d) / "run_control.json"
        if cand.exists():
            run_control = cand
            break
    web = MonitorWebServer(
        out_dir, port=serve, live=live, run_control=run_control,
        plan_path=plan_path, plan_store=plan_store,
    ).start()
    click.echo(json.dumps({
        "web_ui": web.url,
        "run_control": str(run_control) if run_control else None,
        "plan": str(plan_path) if plan_path else None,
    }))
    return web


def _monitor_live(input, preview_dir, interval, once, ls_angle_deg,
                  px_to_scan_ratio, serve=None, plan_path=None,
                  plan_store=None):
    """Attach-mode live monitor: ring descriptor + volumes.jsonl tail.

    Ports the reference napari process's live behaviors (follow-latest
    with scrub-pause, per-channel auto-contrast, editable deskew
    geometry — reference ``_napari_process.py:202-329,416-433``) onto
    the headless PNG renderer; see ``shrimpy_tpu_torch.viewer.live``.
    """
    import time as _time

    from shrimpy_tpu_torch.viewer.live import LiveMonitor, attach

    in_path = Path(input)
    ring_dir = in_path if (in_path / "ring.json").exists() else in_path / "preview"
    if not (ring_dir / "ring.json").exists():
        raise click.ClickException(
            f"no ring.json under {in_path} — is a --viewer acquisition running?"
        )
    deskew = None
    if ls_angle_deg is not None or px_to_scan_ratio is not None:
        if px_to_scan_ratio is None:
            raise click.ClickException(
                "--ls-angle-deg needs --px-to-scan-ratio too (the deskew "
                "preview resamples the scan axis by pixel/scan_step)"
            )
        if ls_angle_deg is None:
            # Symmetric with the check above: the tilt angle is
            # instrument knowledge (the deskew verb refuses to default
            # it without a microscope profile); silently assuming 30
            # deg would render a geometrically wrong preview.
            raise click.ClickException(
                "--px-to-scan-ratio needs --ls-angle-deg too (the "
                "preview's tilt angle is instrument-specific)"
            )
        from shrimpy_tpu_torch.config.schemas import DeskewSettings

        deskew = DeskewSettings(
            ls_angle_deg=ls_angle_deg,
            px_to_scan_ratio=px_to_scan_ratio,
        )
    out_dir = Path(preview_dir) if preview_dir else ring_dir
    try:
        ring, tail = attach(ring_dir)
    except FileNotFoundError as e:
        raise click.ClickException(
            f"viewer ring is gone ({e}) — the acquisition has finished; "
            "use plain `monitor <store>` on the output store instead"
        ) from e
    monitor = LiveMonitor(ring, out_dir, deskew=deskew)
    # `replay --viewer -o OUT` puts the ring under OUT/preview and the
    # run-control file in OUT itself; when attaching to either path the
    # control file is in the ring dir's parent (or the input itself).
    web = _start_web(
        out_dir, serve, live=True, near=[in_path, ring_dir.parent],
        plan_path=plan_path, plan_store=plan_store,
    )
    try:
        while True:
            for msg in tail.poll():
                monitor.on_volume(msg)
            monitor.refresh_controls()
            drawn = monitor.render_dirty()
            click.echo(json.dumps({
                "drawn": drawn,
                "displayed": monitor._last_drawn,
                "follow": monitor.follow,
                "evicted": monitor.evicted,
            }))
            if once:
                break
            _time.sleep(interval)
    finally:
        if web is not None:
            web.stop()
        ring.close()


@cli.command()
@click.argument("input", type=click.Path(exists=True))
@click.option("--input-channel", required=True)
@click.option("--target-channels", required=True,
              help="Comma-separated fluorescence target channel names.")
@click.option("-o", "--output", "ckpt_out", type=click.Path(), required=True,
              help="Checkpoint directory (consumed by virtual_staining.ckpt_path).")
@click.option("--steps", type=int, default=500, show_default=True)
@click.option("--batch", type=int, default=4, show_default=True)
@click.option("--patch", type=int, default=128, show_default=True)
@click.option("--learning-rate", type=float, default=1e-3, show_default=True)
@click.option("--architecture", type=click.Choice(["unet25d", "unext2"]),
              default="unet25d", show_default=True)
@click.option("--val-fraction", type=float, default=0.2, show_default=True,
              help="Held-out validation fraction (0 disables early stop).")
@click.option("--early-stop-patience", type=int, default=4, show_default=True,
              help="Stop after N validation evals without improvement.")
@click.option("--device", default="cuda", show_default=True,
              help="Torch device: 'cuda', 'cuda:N' or 'cpu'.")
def train_vs(input, input_channel, target_channels, ckpt_out, steps, batch,
             patch, learning_rate, architecture, val_fraction,
             early_stop_patience, device):
    """Train a virtual-staining model on paired channels of a store."""
    from shrimpy_tpu_torch.config import vs_settings
    from shrimpy_tpu_torch.models.train import train_vsunet

    dev = _device_or_exit(device)
    targets = [c.strip() for c in target_channels.split(",") if c.strip()]
    _, report = train_vsunet(
        input,
        input_channel=input_channel,
        target_channels=targets,
        settings=vs_settings(architecture=architecture, out_channels=targets),
        steps=steps,
        batch=batch,
        patch=patch,
        learning_rate=learning_rate,
        ckpt_path=ckpt_out,
        val_fraction=val_fraction,
        early_stop_patience=early_stop_patience,
        device=dev,
    )
    click.echo(json.dumps({
        "steps": report.steps,
        "final_loss": report.final_loss,
        "best_val_loss": report.best_val_loss,
        "stopped_early": report.stopped_early,
        "ckpt": str(ckpt_out),
    }))


@cli.command()
@click.argument("input", type=click.Path(exists=True))
def info(input):
    """Describe an OME-Zarr store (layout, positions, shapes, scales)."""
    from shrimpy_tpu_torch.io.ngff import open_ngff

    store = open_ngff(input)
    out = {
        "path": str(input),
        "ngff_version": store.version,
        "layout": "hcs-plate" if store.is_plate else "fov",
        "positions": {},
    }
    for key, pos in store.positions().items():
        out["positions"][key] = {
            "shape_tczyx": list(pos.shape),
            "dtype": str(pos.dtype),
            "channels": pos.channel_names,
            "zyx_scale_um": list(pos.zyx_scale),
        }
    click.echo(json.dumps(out, indent=2))


@cli.command()
def microscopes():
    """List registered microscope profiles (downstream packages add
    instruments via ``shrimpy_tpu_torch.config.microscopes.register_microscope``)."""
    from shrimpy_tpu_torch.config.microscopes import available_microscopes, get_microscope

    out = {}
    for name in available_microscopes():
        p = get_microscope(name)
        out[name] = {
            "description": p.description,
            "implemented": p.implemented,
            "ls_angle_deg": p.ls_angle_deg,
            "arms": p.arms,
        }
    click.echo(json.dumps(out, indent=2))


if __name__ == "__main__":
    cli()
