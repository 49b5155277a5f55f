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

import copy
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
    """``ReconstructSettings`` as a namespace, with its validator's rule:
    ``shard_volumes`` refuses the separable and hybrid deconvolutions
    (``_check_shard_volumes``, with its message)."""
    ns = _make({**RECONSTRUCT_DEFAULTS, "io_retry": None}, overrides)
    if ns.io_retry is None:
        ns.io_retry = SimpleNamespace(**IO_RETRY_DEFAULTS)
    if (ns.shard_volumes and ns.deconvolve is not None
            and ns.deconvolve.algorithm in ("separable", "hybrid")):
        raise ValueError(
            "shard_volumes requires the FFT deconvolution path "
            "(algorithm='fft' or 'auto'); the separable kernels "
            f"(algorithm='{ns.deconvolve.algorithm}') are "
            "volume-local"
        )
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
    ``deskew`` and ``phase`` dicts must pass ``DeskewSettings``' and
    ``PhaseSettings``' checks. A ``tracking_channel`` left unset (None) skips
    the channel rules. The three dicts are copies of those given, as
    pydantic's are: :func:`inject_dynatrack_parameters` leaves the caller's
    dicts (a plan's ``metadata``) as they were."""
    ns = _make(DYNATRACK_DEFAULTS, overrides)
    for name in ("deskew", "phase", "virtual_staining"):
        if isinstance(getattr(ns, name), dict):
            setattr(ns, name, dict(getattr(ns, name)))
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
        _check_deskew(ns.deskew)
    if ns.phase is not None:
        _check_phase(ns.phase)
    return ns


def _check_deskew(fields: dict) -> None:
    """``DeskewSettings(**fields)``' checks, with its messages: known fields,
    ``average_n_slices >= 1``, an angle in (0, 90) and a positive ratio,
    given or derived from ``pixel_size_um / scan_step_um``."""
    s = deskew_settings(**fields)
    ratio = s.px_to_scan_ratio
    if ratio is None and s.pixel_size_um is not None and s.scan_step_um is not None:
        ratio = round(s.pixel_size_um / s.scan_step_um, 3)
    if s.average_n_slices < 1:
        raise ValueError("average_n_slices must be >= 1")
    if not (0.0 < s.ls_angle_deg < 90.0):
        raise ValueError("ls_angle_deg must be in (0, 90)")
    if ratio is not None and not ratio > 0:
        raise ValueError("px_to_scan_ratio must be > 0")


_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


def _lax_float(v) -> float:
    if isinstance(v, (bool, int, float, str)):
        return float(v)  # an int past float's range raises, as pydantic does
    raise TypeError(f"a number, not {v!r}")


def _lax_int(v) -> int:
    if isinstance(v, int):  # a bool too
        return int(v)
    f = _lax_float(v)
    if not f.is_integer():
        raise ValueError(f"an integer, not {v!r}")
    return int(f)


def _lax_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE + _FALSE:
        return v.lower() in _TRUE
    raise ValueError(f"a boolean, not {v!r}")


def deskew_geometry(**fields) -> SimpleNamespace:
    """``DeskewSettings(**fields)`` as a :func:`deskew_settings` namespace:
    what the model rejects raises (an unknown field, a value of another
    type, a slice count that is not whole, a backend it does not name,
    ``_derive_ratio``'s checks with their messages), and what it takes comes
    out as its ``model_dump()`` would: pydantic's lax coercions (a number
    from a bool or a numeric string, a whole float as the count, ``"yes"`` /
    ``"off"`` / 0 / 1 as the flag) and the ratio derived from
    ``pixel_size_um / scan_step_um`` when unset."""
    s = deskew_settings(**fields)
    s.ls_angle_deg = _lax_float(s.ls_angle_deg)
    for name in ("px_to_scan_ratio", "pixel_size_um", "scan_step_um"):
        if getattr(s, name) is not None:
            setattr(s, name, _lax_float(getattr(s, name)))
    s.keep_overhang = _lax_bool(s.keep_overhang)
    s.average_n_slices = _lax_int(s.average_n_slices)
    if s.backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', not {s.backend!r}")
    if s.px_to_scan_ratio is None and s.pixel_size_um is not None and s.scan_step_um is not None:
        s.px_to_scan_ratio = round(s.pixel_size_um / s.scan_step_um, 3)
    _check_deskew(vars(s))
    return s


def _check_phase(fields: dict) -> None:
    """``PhaseSettings(**fields)``' checks, with its messages: known fields,
    and a transfer function whose detection NA is within the medium's index
    and whose ``z_padding`` is not negative."""
    unknown = set(fields) - {"transfer_function", "apply_inverse"}
    if unknown:
        raise TypeError(f"unknown phase settings fields: {sorted(unknown)}")
    tf = phase_settings(**fields).transfer_function
    if tf.numerical_aperture_detection > tf.index_of_refraction_media:
        raise ValueError("detection NA cannot exceed the medium index")
    if tf.z_padding < 0:
        raise ValueError("z_padding must be >= 0")


def inject_dynatrack_parameters(config, *, pixel_size_um: float, z_step_um: float) -> None:
    """``inject_derived_parameters`` for a :func:`dynatrack_settings`
    namespace: the store's pixel size and z step go into the ``deskew``
    (``pixel_size_um``, ``scan_step_um``) and ``phase`` (the transfer
    function's ``yx_pixel_size``, ``z_pixel_size``) dicts where these do not
    set them, a listed step without a dict gets one, and each dict is checked
    again. The JAX function's ``DynaTrackConfig`` branch, statement for
    statement, with this package's checks in the place of the models."""
    steps = tuple(config.preprocessing or ())
    if config.deskew is None and "deskew" in steps:
        config.deskew = {}
    if config.phase is None and "phase" in steps:
        config.phase = {}
    if config.deskew is not None:
        config.deskew.setdefault("pixel_size_um", pixel_size_um)
        config.deskew.setdefault("scan_step_um", z_step_um)
        _check_deskew(config.deskew)
    if config.phase is not None:
        tf = config.phase.setdefault("transfer_function", {})
        tf.setdefault("yx_pixel_size", pixel_size_um)
        tf.setdefault("z_pixel_size", z_step_um)
        _check_phase(config.phase)


# engine/plan.py's AutofocusPlan (the demo PFS of DemoAutofocus).
AUTOFOCUS_DEFAULTS = {"enabled": False, "success_rate": 1.0, "fail_at_indices": None, "seed": 0}


def autofocus_plan(**overrides) -> SimpleNamespace:
    """``AutofocusPlan`` as a namespace, with its validator's two rules and
    messages: ``success_rate`` in [0, 1], and no failure settings while the
    demo PFS is off."""
    ns = _make(AUTOFOCUS_DEFAULTS, overrides)
    if not 0.0 <= ns.success_rate <= 1.0:
        raise ValueError(f"success_rate must be in [0, 1], got {ns.success_rate}")
    if not ns.enabled and (ns.fail_at_indices is not None or ns.success_rate != 1.0):
        raise ValueError(
            "autofocus failure settings (fail_at_indices / "
            "success_rate) require enabled: true"
        )
    return ns


# engine/plan.py's AcquisitionPlan and its blocks: the fields in the schema's
# order with its defaults (a required field None here).
TIME_DEFAULTS = {"n_timepoints": 1, "interval_s": 0.0}
CHANNEL_DEFAULTS = {"name": None, "exposure_ms": 10.0}
Z_DEFAULTS = {"n_slices": None, "step_um": None}
REFOCUS_DEFAULTS = {"enabled": False, "interval_timepoints": 1, "channel": None,
                    "wavelength_um": 0.55, "na_det": 1.35, "threshold": 0.0}
AUTOEXPOSURE_DEFAULTS = {"enabled": False, "algorithm": "intensity_percentile", "channel": None,
                         "manual_csv": None, "settings": {}}
STAGE_DEFAULTS = {"model_speed": False, "slow_speed_mm_s": 2.0, "fast_speed_mm_s": 5.75,
                  "short_distance_um": 2000.0, "negligible_distance_um": 1.0, "time_scale": 1.0}
CAMERA_DEFAULTS = {"model_acquisition": False, "mode": "demo", "max_fps": 30.0,
                   "readout_ms": 10.0, "piezo_step_ms": 1.5, "post_readout_delay_ms": 0.05,
                   "channel_change_ms": None, "time_scale": 1.0, "max_sequenced_events": None}
LASER_DEFAULTS = {"channel": None, "wavelength_nm": 488, "max_power_mw": 100.0,
                  "power_mw": 10.0, "port": None}
HARDWARE_DEFAULTS = {"enabled": False, "lasers": [], "shutter": True, "o3_port": None,
                     "o3_steps_per_slice": 10, "daq": True}
PLAN_DEFAULTS = {"time": None, "channels": None, "z": None, "positions": None,
                 "positions_csv": None, "stage_positions": None, "source_exposure_ms": 10.0,
                 "mode": "volume", "axis_order": "tpcz", "autofocus": None, "refocus": None,
                 "autoexposure": None, "stage": None, "camera": None, "hardware": None,
                 "metadata": {}, "watchdog_s": 100.0}

# What the pydantic plan emulates on the host, by the block's name: set, the
# namespace raises (acquisition_plan).
HOST_EMULATIONS = ("camera.model_acquisition", "stage.model_speed", "hardware.enabled",
                   "autoexposure.enabled", "stage_positions", "positions_csv")


def _dump(value):
    """pydantic's ``model_dump`` of a field: blocks (a model, a plan block or
    a settings namespace) as dicts, containers copied."""
    if hasattr(value, "model_dump"):
        return value.model_dump()
    if isinstance(value, SimpleNamespace):
        return {k: _dump(v) for k, v in vars(value).items()}
    if isinstance(value, list):
        return [_dump(v) for v in value]
    if isinstance(value, dict):
        return {k: _dump(v) for k, v in value.items()}
    return copy.deepcopy(value)


class PlanBlock(SimpleNamespace):
    """A block of the plan as a namespace; ``model_dump()`` is the pydantic
    model's."""

    def model_dump(self) -> dict:
        return {k: _dump(v) for k, v in vars(self).items()}


class ZBlock(PlanBlock):
    """``ZPlan`` as a namespace."""

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


class PlanNamespace(PlanBlock):
    """``AcquisitionPlan`` as a namespace (:func:`acquisition_plan`)."""

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

    def dynatrack_metadata(self) -> dict | None:
        """The ``metadata.dynatrack`` block (reference
        ``metadata.mantis.dynatrack``, ``manager.py:170-240``)."""
        return self.metadata.get("dynatrack")


def _fields(given) -> dict:
    """A block's fields given as a dict, a namespace or None."""
    return dict(vars(given) if isinstance(given, SimpleNamespace) else given or {})


def _block(defaults: dict, given, cls=PlanBlock, required: str | None = None) -> PlanBlock:
    """A block from a dict of overrides of its defaults or a namespace
    (checked again): unknown fields raise, and so does a ``required`` field
    left unset."""
    block = cls(**vars(_make(copy.deepcopy(defaults), _fields(given))))
    if required is not None and getattr(block, required) is None:
        raise ValueError(f"field {required!r} is required")
    return block


def _check_stage(stage) -> None:
    if stage.slow_speed_mm_s <= 0 or stage.fast_speed_mm_s <= 0:
        raise ValueError("stage speeds must be > 0")
    if stage.time_scale < 0:
        raise ValueError("time_scale must be >= 0")
    if stage.negligible_distance_um < 0:
        raise ValueError("negligible_distance_um must be >= 0")


def _check_camera(cam) -> None:
    if cam.mode not in ("demo", "labelfree", "lightsheet"):
        raise ValueError(f"camera.mode={cam.mode!r}; use 'demo', 'labelfree' or 'lightsheet'")
    for f in ("max_fps", "readout_ms", "piezo_step_ms"):
        if getattr(cam, f) <= 0:
            raise ValueError(f"camera.{f} must be > 0")
    if cam.post_readout_delay_ms < 0 or cam.time_scale < 0:
        raise ValueError(
            "camera.post_readout_delay_ms and camera.time_scale "
            "must be >= 0"
        )
    if cam.channel_change_ms is not None and cam.channel_change_ms < 0:
        raise ValueError("camera.channel_change_ms must be >= 0")
    if cam.max_sequenced_events is not None and cam.max_sequenced_events < 1:
        raise ValueError("camera.max_sequenced_events must be >= 1")


def _check_hardware(hw) -> None:
    for laser in hw.lasers:
        if laser.max_power_mw <= 0 or laser.power_mw < 0:
            raise ValueError("laser powers must be positive")
        if laser.power_mw > laser.max_power_mw:
            raise ValueError(
                f"laser {laser.channel}: power_mw ({laser.power_mw}) exceeds "
                f"max_power_mw ({laser.max_power_mw})"
            )
    if hw.o3_steps_per_slice < 1:
        raise ValueError("hardware.o3_steps_per_slice must be >= 1")
    seen: set[str] = set()
    for laser in hw.lasers:
        if laser.channel in seen:
            raise ValueError(f"hardware.lasers: duplicate channel {laser.channel!r}")
        seen.add(laser.channel)


def acquisition_plan(**fields) -> PlanNamespace:
    """``engine/plan.py::AcquisitionPlan`` as a namespace, for the engine on
    a host without pydantic (the card's).

    Every field of the plan with the schema's defaults; each block
    (``time``, ``channels``, ``z``, ``autofocus``, ``refocus``,
    ``autoexposure``, ``stage``, ``camera``, ``hardware``) a dict of
    overrides of its defaults or a namespace, with its validator's rules and
    messages, and the plan's own. ``z.resolve_z_indices``,
    ``resolve_positions`` and ``dynatrack_metadata`` are the plan's methods
    statement for statement, and ``model_dump()`` is pydantic's dump, so
    ``acquisition_plan(**plan.model_dump())`` carries a plan of either
    package across. The engine's host emulations that call the pydantic
    models' methods (a camera timing model, the stage-speed model, the
    instrument rig, autoexposure, a generated plate grid, a position CSV;
    :data:`HOST_EMULATIONS`) are not carried: one of them set raises
    ``NotImplementedError``, and ``engine.plan.AcquisitionPlan`` runs it on a
    host with pydantic."""
    ns = _make(PLAN_DEFAULTS, fields)
    plan = PlanNamespace()
    plan.time = _block(TIME_DEFAULTS, ns.time)
    if plan.time.n_timepoints < 1:
        raise ValueError("n_timepoints must be >= 1")
    plan.channels = None
    if ns.channels is not None:
        plan.channels = [_block(CHANNEL_DEFAULTS, c, required="name") for c in ns.channels]
        for c in plan.channels:
            if not c.exposure_ms > 0:
                raise ValueError("exposure_ms must be > 0")
    plan.z = _block(Z_DEFAULTS, ns.z, ZBlock)
    if plan.z.step_um is not None and not plan.z.step_um > 0:
        raise ValueError("step_um must be > 0")
    if plan.z.n_slices is not None and plan.z.n_slices < 1:
        raise ValueError("n_slices must be >= 1")
    plan.positions = None if ns.positions is None else list(ns.positions)
    plan.positions_csv = ns.positions_csv
    plan.stage_positions = ns.stage_positions
    plan.source_exposure_ms = ns.source_exposure_ms
    if ns.mode not in ("volume", "camera"):
        raise ValueError(f"mode={ns.mode!r}; use 'volume' or 'camera'")
    plan.mode = ns.mode
    plan.axis_order = ns.axis_order
    plan.autofocus = PlanBlock(**vars(autofocus_plan(**_fields(ns.autofocus))))
    plan.refocus = _block(REFOCUS_DEFAULTS, ns.refocus)
    if plan.refocus.interval_timepoints < 1:
        raise ValueError("interval_timepoints must be >= 1")
    plan.autoexposure = _block(AUTOEXPOSURE_DEFAULTS, ns.autoexposure)
    plan.stage = _block(STAGE_DEFAULTS, ns.stage)
    _check_stage(plan.stage)
    plan.camera = _block(CAMERA_DEFAULTS, ns.camera)
    _check_camera(plan.camera)
    hw = _fields(ns.hardware)
    plan.hardware = _block(HARDWARE_DEFAULTS, {
        **hw, "lasers": [_block(LASER_DEFAULTS, laser, required="channel")
                   for laser in hw.get("lasers", [])]})
    _check_hardware(plan.hardware)
    plan.metadata = dict(ns.metadata)
    plan.watchdog_s = ns.watchdog_s
    # AcquisitionPlan._check
    if plan.channels is not None and not plan.channels:
        raise ValueError(
            "channels must be a non-empty list (omit it or use null "
            "for all source channels)"
        )
    if plan.positions is not None and not plan.positions:
        raise ValueError(
            "positions must be a non-empty list (omit it or use "
            "null for all source positions)"
        )
    if plan.axis_order != "tpcz":
        raise ValueError("only axis_order='tpcz' is supported")
    n_sources = sum(
        x is not None
        for x in (plan.positions, plan.positions_csv, plan.stage_positions)
    )
    if n_sources > 1:
        raise ValueError(
            "set only one of positions / positions_csv / stage_positions"
        )
    if not plan.source_exposure_ms > 0:
        raise ValueError("source_exposure_ms must be > 0")
    for name in HOST_EMULATIONS:
        block, _, flag = name.partition(".")
        value = getattr(getattr(plan, block), flag) if flag else getattr(plan, block)
        if value:
            raise NotImplementedError(
                f"{name} is emulated on the host by shrimpy_tpu_torch.engine.plan."
                "AcquisitionPlan (pydantic), which the engine runs where pydantic is "
                "installed; this namespace does not carry it"
            )
    return plan


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
