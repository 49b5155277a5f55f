"""``shrimpy-tpu-torch`` CLI: the reconstruction verbs of the port.

The verbs ``deskew``, ``deconvolve``, ``phase``, ``reconstruct``, ``register``
and ``track`` take the same options and YAML as ``shrimpy_tpu/cli/main.py``,
plus ``--device`` (default ``cuda``). Pixel size and z step come from the store's scale
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


def _run_reconstruct(
    input, output, settings, devices, space, batch, resume, profile_dir, device
):
    from shrimpy_tpu_torch.runtime.stream import reconstruct_store
    from shrimpy_tpu_torch.utils.device import resolve_device
    from shrimpy_tpu_torch.utils.timing import profiler_trace

    if (devices or 1) > 1 or space > 1:
        raise click.ClickException(
            "the PyTorch port runs one device (--devices/--space > 1 is "
            "ROADMAP queue 1 item 11)"
        )
    try:
        resolve_device(device)
    except RuntimeError as exc:
        raise click.ClickException(str(exc)) from None
    _inject_from_store(settings, Path(input))
    try:
        with profiler_trace(profile_dir):
            summary = reconstruct_store(
                input, output, settings, batch_size=batch, resume=resume, device=device
            )
    except NotImplementedError as exc:
        raise click.ClickException(str(exc)) from None
    click.echo(json.dumps(summary, indent=2))


_shared = [
    click.argument("input", type=click.Path(exists=True)),
    click.option("-o", "--output", required=True, type=click.Path()),
    click.option("--devices", type=int, default=None, help="Device count (1 only)."),
    click.option("--space", type=int, default=1, help="X-axis sharding factor (1 only)."),
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
    from shrimpy_tpu_torch.utils.device import resolve_device
    from shrimpy_tpu_torch.utils.fft import match_shape

    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        raise click.ClickException(str(exc)) from None
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
    from shrimpy_tpu_torch.utils.device import resolve_device

    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        raise click.ClickException(str(exc)) from None
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


if __name__ == "__main__":
    cli()
