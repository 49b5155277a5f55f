"""Settings as the port reads them.

The port reads its settings by attribute, so a pydantic
``ReconstructSettings`` — the port's own
(:mod:`shrimpy_tpu_torch.config.schemas`, a copy of the JAX package's,
so one YAML runs on both packages) or one a caller built with the JAX
package — works unchanged, and so does a :class:`types.SimpleNamespace`
with the same field names: what the compute path uses where pydantic
is not installed (a GPU host with only torch). The builders below make such
namespaces with the schema's defaults for exactly the fields the port
reads; ``tests/test_torch_pipeline.py`` pins these defaults to
``shrimpy_tpu/config/schemas.py``.

The pydantic models, ``inject_derived_parameters`` and
``load_yaml_config`` are attributes of this package too, imported from
:mod:`~shrimpy_tpu_torch.config.schemas` at first access, so
``import shrimpy_tpu_torch.config`` needs neither pydantic nor yaml.
"""

from __future__ import annotations

from types import SimpleNamespace

from shrimpy_tpu_torch.config.vs_sidecar import DEFAULT_OUT_CHANNELS, read_vs_sidecar

# Names served lazily from config/schemas.py (pydantic + yaml).
_SCHEMA_NAMES = (
    "DeconvolveSettings",
    "DeskewSettings",
    "DynaTrackConfig",
    "PhaseApplyInverseSettings",
    "PhaseSettings",
    "PhaseTransferFunctionSettings",
    "ReconstructArms",
    "ReconstructSettings",
    "RegistrationSettings",
    "RoiCenterSettings",
    "SegmentationSettings",
    "ShiftSettings",
    "inject_derived_parameters",
    "load_yaml_config",
)


def __getattr__(name: str):
    if name in _SCHEMA_NAMES:
        from shrimpy_tpu_torch.config import schemas

        return getattr(schemas, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

DESKEW_DEFAULTS = {
    "ls_angle_deg": 30.0,
    "px_to_scan_ratio": None,
    "pixel_size_um": None,
    "scan_step_um": None,
    "keep_overhang": False,
    "average_n_slices": 1,
    "backend": "auto",
}

DECONVOLVE_DEFAULTS = {
    "iterations": 20,
    "psf_path": None,
    "epsilon": 1e-6,
    "pad_mode": "reflect",
    "algorithm": "auto",
    "separable_tol": 1e-4,
    "max_separable_terms": 6,
    "psf_denoise": "auto",
    "psf_denoise_max_residual": 0.05,
    "psf_crop_tol": 1e-5,
    "max_extended_terms": 24,
    "separable_backend": "auto",
    "matmul_precision": "high",
    "fused_low_precision_iters": 0,
    "acceleration": "none",
    "donate_input": False,
    "fft_backend": "auto",
    "fft_z_chunk": 8,
    "hybrid_separable_iters": 16,
}

PHASE_TF_DEFAULTS = {
    "wavelength_illumination": 0.450,
    "index_of_refraction_media": 1.4,
    "numerical_aperture_detection": 1.35,
    "numerical_aperture_illumination": 0.52,
    "z_padding": 5,
    "invert_phase_contrast": False,
    "yx_pixel_size": None,
    "z_pixel_size": None,
}

PHASE_INVERSE_DEFAULTS = {
    "reconstruction_algorithm": "Tikhonov",
    "regularization_strength": 0.01,
    "transform": "auto",
}

REGISTRATION_DEFAULTS = {
    "method": "pcc+refine",
    "maximum_shift": 1.0,
    "refine_iterations": 100,
    "learning_rate": 0.05,
    "loss": "ncc",
    "parameterization": "triangular",
    "downsample_yx": 4,
    "transform_path": None,
}

IO_RETRY_DEFAULTS = {"attempts": 3, "wait_s": 1.0, "contain_failures": True}

TRACKING_METHODS = (
    "pcc",
    "intensity_center_of_mass",
    "roi_center_pcc",
    "multiotsu_center_of_mass",
    "multiotsu_pcc",
    "template_matching",
)

# DynaTrackConfig's fields (input_channel and tracking_channel, required by
# the schema, default to None here) and those of its nested blocks.
DYNATRACK_DEFAULTS = {
    "enabled": True,
    "input_channel": None,
    "z_device": None,
    "shift": None,
    "tracking_interval": 1,
    "tracking_method": "pcc",
    "segmentation": None,
    "roi_center": None,
    "template": None,
    "reference_update_interval": 0,
    "tracking_channel": None,
    "preprocessing": None,
    "deskew": None,
    "phase": None,
    "virtual_staining": None,
    "image_to_stage_matrix_xyz": None,
    "shift_log_path": None,
    "debug": False,
}

DYNATRACK_PARTS = {
    "shift": {"maximum": 1.0, "limits": None, "dampening": None},
    "segmentation": {"otsu_sigma": 5.0, "otsu_component": 0},
    "roi_center": {"blob_sigma": 10.0, "background_percentile": None, "blur_sigma": 0.0},
    "template": {"slice_zyx": None},
}

RECONSTRUCT_DEFAULTS = {
    "deskew": None,
    "phase": None,
    "registration": None,
    "deconvolve": None,
    "channels": None,
    "positions": None,
    "time_indices": None,
    "output_dtype": "float32",
    "pyramid_levels": 0,
    "shard_volumes": False,
}


def _make(defaults: dict, overrides: dict) -> SimpleNamespace:
    unknown = set(overrides) - set(defaults)
    if unknown:
        raise TypeError(f"unknown settings fields: {sorted(unknown)}")
    return SimpleNamespace(**{**defaults, **overrides})


def deskew_settings(**overrides) -> SimpleNamespace:
    return _make(DESKEW_DEFAULTS, overrides)


def deconvolve_settings(**overrides) -> SimpleNamespace:
    return _make(DECONVOLVE_DEFAULTS, overrides)


def phase_settings(transfer_function=None, apply_inverse=None) -> SimpleNamespace:
    """``PhaseSettings`` as a namespace; each part a dict of overrides
    of its defaults or a namespace."""
    parts = []
    for given, defaults in ((transfer_function, PHASE_TF_DEFAULTS),
                            (apply_inverse, PHASE_INVERSE_DEFAULTS)):
        parts.append(given if isinstance(given, SimpleNamespace)
                     else _make(defaults, dict(given or {})))
    return SimpleNamespace(transfer_function=parts[0], apply_inverse=parts[1])


def registration_settings(**overrides) -> SimpleNamespace:
    return _make(REGISTRATION_DEFAULTS, overrides)


def reconstruct_settings(**overrides) -> SimpleNamespace:
    ns = _make({**RECONSTRUCT_DEFAULTS, "io_retry": None}, overrides)
    if ns.io_retry is None:
        ns.io_retry = SimpleNamespace(**IO_RETRY_DEFAULTS)
    return ns


def dynatrack_settings(**overrides) -> SimpleNamespace:
    """``DynaTrackConfig`` as a namespace; each nested block (``shift``,
    ``segmentation``, ``roi_center``, ``template``) a dict of overrides
    of its defaults or a namespace. ``deskew``, ``phase`` and
    ``virtual_staining`` stay dicts, as in the schema. Every rule of the
    schema's validator holds, with its messages: the method checks, the
    channel-name rules (a ``vs_*`` tracking channel must be among the
    ``out_channels`` of ``virtual_staining``, of its checkpoint's sidecar or
    the defaults), the allowed steps and ``vs`` after ``phase``; the
    ``deskew`` and ``phase`` dicts must name known fields. A
    ``tracking_channel`` left unset (None) skips the channel rules."""
    ns = _make(DYNATRACK_DEFAULTS, overrides)
    for name, defaults in DYNATRACK_PARTS.items():
        given = getattr(ns, name)
        if not isinstance(given, SimpleNamespace):
            setattr(ns, name, _make(defaults, dict(given or {})))
    if ns.tracking_method not in TRACKING_METHODS:
        raise ValueError(f"Unknown tracking_method={ns.tracking_method!r}; "
                         f"use one of {TRACKING_METHODS}")
    if ns.tracking_method == "template_matching" and ns.template.slice_zyx is None:
        raise ValueError("tracking_method='template_matching' requires template.slice_zyx")
    channel = ns.tracking_channel
    if channel in ("raw", "phase", "deskewed"):
        raise ValueError(
            f"tracking_channel={channel!r} names an intermediate product; use the input "
            "channel name or a virtual_staining target channel")
    if channel is not None and channel.startswith("vs_"):
        vs = ns.virtual_staining or {}
        targets = vs.get("out_channels")
        if targets is None and vs.get("ckpt_path"):
            sidecar = read_vs_sidecar(vs["ckpt_path"])
            if sidecar is not None:
                targets = sidecar.get("out_channels")
        if targets is None and not vs.get("ckpt_path"):
            targets = DEFAULT_OUT_CHANNELS
        if targets is not None and channel not in targets:
            raise ValueError(f"tracking_channel={channel!r} is not among "
                             f"virtual_staining out_channels={targets}")
    if ns.preprocessing:
        unknown = set(ns.preprocessing) - {"deskew", "phase", "vs"}
        if unknown:
            raise ValueError(f"Unknown preprocessing steps: {sorted(unknown)}")
        if "vs" in ns.preprocessing and "phase" not in ns.preprocessing:
            raise ValueError("'vs' preprocessing requires 'phase' first")
    if ns.deskew is not None:
        deskew_settings(**ns.deskew)
    if ns.phase is not None:
        phase_settings(**ns.phase)
    return ns


UNET25D_DEFAULTS = {"base_width": 64, "depth": 3}

UNEXT2_DEFAULTS = {
    "encoder_blocks": [2, 2, 4],
    "dims": [48, 96, 192],
    "decoder_conv_blocks": 1,
    "stem_kernel_z": None,
    "head_conv_expansion_ratio": 4,
    "out_stack_depth": 1,
}

ARCH_DEFAULTS = {"unet25d": UNET25D_DEFAULTS, "unext2": UNEXT2_DEFAULTS}

VS_DEFAULTS = {
    "architecture": "unet25d",
    "arch_config": None,
    "in_slices": 5,
    "out_channels": DEFAULT_OUT_CHANNELS,
    "base_width": 64,
    "depth": 3,
    "ckpt_path": None,
    "seed": 0,
    "batch_slices": 8,
    "window_step": 1,
}


def arch_config_dict(architecture: str, cfg: dict) -> dict:
    """``UNet25DConfig(**cfg).model_dump()`` or ``UNeXt2Config``'s, with
    their checks and messages: unknown keys are rejected, unext2 needs
    ``encoder_blocks`` and ``dims`` of one length, at least 2 stages and
    ``out_stack_depth >= 1``."""
    if architecture not in ARCH_DEFAULTS:
        raise ValueError(f"architecture={architecture!r}; use one of {sorted(ARCH_DEFAULTS)}")
    defaults = ARCH_DEFAULTS[architecture]
    unknown = set(cfg) - set(defaults)
    if unknown:
        raise ValueError(f"unknown {architecture} arch_config fields: {sorted(unknown)}")
    out = {**defaults, **cfg}
    if architecture == "unext2":
        out["encoder_blocks"], out["dims"] = list(out["encoder_blocks"]), list(out["dims"])
        if len(out["encoder_blocks"]) != len(out["dims"]):
            raise ValueError(
                f"encoder_blocks ({len(out['encoder_blocks'])}) and dims "
                f"({len(out['dims'])}) must have the same number of stages")
        if len(out["dims"]) < 2:
            raise ValueError("unext2 needs at least 2 stages")
        if out["out_stack_depth"] < 1:
            raise ValueError("out_stack_depth must be >= 1")
    return out


def vs_settings(**overrides) -> SimpleNamespace:
    """``VSModelSettings`` (the ``virtual_staining`` block) as a namespace.
    ``fields_set`` holds the names given, as pydantic's ``model_fields_set``
    does: the checkpoint's sidecar may fill only the others."""
    ns = _make(VS_DEFAULTS, overrides)
    if ns.architecture not in ARCH_DEFAULTS:
        raise ValueError(f"architecture={ns.architecture!r}; use one of {sorted(ARCH_DEFAULTS)}")
    ns.out_channels = list(ns.out_channels)
    ns.fields_set = frozenset(overrides)
    return ns


def resolved_arch_config(settings) -> SimpleNamespace:
    """``VSModelSettings.resolved_arch_config()``: ``arch_config`` checked
    against the architecture's fields, the unet25d top-level ``base_width``
    and ``depth`` filling what it leaves unset. ``settings`` is read by
    attribute (this package's namespace or a pydantic model)."""
    cfg = dict(settings.arch_config or {})
    if settings.architecture == "unet25d":
        cfg.setdefault("base_width", settings.base_width)
        cfg.setdefault("depth", settings.depth)
    return SimpleNamespace(**arch_config_dict(settings.architecture, cfg))


def require_ratio(deskew) -> float:
    """``px_to_scan_ratio``, derived from ``pixel_size_um /
    scan_step_um`` (rounded to 3 places) when unset — the rule of
    ``DeskewSettings._derive_ratio``."""
    r = deskew.px_to_scan_ratio
    if r is None and deskew.pixel_size_um is not None and deskew.scan_step_um is not None:
        r = round(deskew.pixel_size_um / deskew.scan_step_um, 3)
    if r is None:
        raise ValueError(
            "px_to_scan_ratio is not set; provide it directly or via "
            "pixel_size_um + scan_step_um (normally injected from "
            "dataset metadata — see inject_derived_parameters)"
        )
    if not r > 0:
        raise ValueError("px_to_scan_ratio must be > 0")
    return r
