"""Strict pydantic configuration schemas.

The port's own copy of ``shrimpy_tpu/config/schemas.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_config.py`` pins every
model, default and validator to the original. Only comments differ: they
describe the port's backends.

Mirrors the reference's config layer behavior (reference
``shrimpy/dynatrack/tracking.py:45-234``, ``config/mda/mantis/
dynatrack_demo.yaml``):

* every model rejects unknown keys (``extra="forbid"``) so a mistyped
  setting fails fast;
* the XY pixel size and Z step are *not* config fields — they are
  derived from the dataset/acquisition metadata and injected at runtime
  by :func:`inject_derived_parameters` (single source of truth, no
  config drift; reference ``manager.py:242-262`` and the NOTE block in
  ``dynatrack_demo.yaml``);
* the deskew/phase sub-configs are validated against *our own* first-
  party schemas (the reference defers to external biahub/waveorder
  schemas — we own the whole stack, so validation is eager and local).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Literal

import yaml
from pydantic import BaseModel, ConfigDict, Field, model_validator

# ---------------------------------------------------------------------------
# Kernel settings (replace biahub.settings.DeskewSettings / waveorder
# phase settings with first-party equivalents)
# ---------------------------------------------------------------------------


class DeskewSettings(BaseModel):
    """Oblique-plane light-sheet deskew geometry.

    Raw volumes are indexed ``(scan, tilt, coverslip)`` = (Z, Y, X) of
    the acquisition. The light sheet is inclined at ``ls_angle_deg`` to
    the coverslip and the stage scans along the coverslip, so raw pixel
    ``(s, t, x)`` sits at lab coordinates (in units of the camera pixel
    size)::

        z_lab = t * sin(theta)
        y_lab = s / px_to_scan_ratio + t * cos(theta)
        x_lab = x

    Matches the parameter surface of the reference's deskew config
    (reference ``dynatrack_demo.yaml`` deskew block and
    ``preprocessing.py:277-294``): ``ls_angle_deg``,
    ``px_to_scan_ratio`` (or ``pixel_size_um`` + ``scan_step_um``),
    ``keep_overhang``, ``average_n_slices``.
    """

    model_config = ConfigDict(extra="forbid")

    ls_angle_deg: float = 30.0
    px_to_scan_ratio: float | None = None
    pixel_size_um: float | None = None
    scan_step_um: float | None = None
    keep_overhang: bool = False
    average_n_slices: int = 1
    # Kernel backend: "pallas" is the fused kernel, "xla" the gather
    # path; "auto" selects the kernel (single-device path).
    backend: Literal["auto", "xla", "pallas"] = "auto"

    @model_validator(mode="after")
    def _derive_ratio(self) -> "DeskewSettings":
        if self.px_to_scan_ratio is None:
            if self.pixel_size_um is not None and self.scan_step_um is not None:
                self.px_to_scan_ratio = round(self.pixel_size_um / self.scan_step_um, 3)
        if self.average_n_slices < 1:
            raise ValueError("average_n_slices must be >= 1")
        if not (0.0 < self.ls_angle_deg < 90.0):
            raise ValueError("ls_angle_deg must be in (0, 90)")
        if self.px_to_scan_ratio is not None and not self.px_to_scan_ratio > 0:
            raise ValueError("px_to_scan_ratio must be > 0")
        return self

    def require_ratio(self) -> float:
        if self.px_to_scan_ratio is None:
            raise ValueError(
                "px_to_scan_ratio is not set; provide it directly or via "
                "pixel_size_um + scan_step_um (normally injected from "
                "dataset metadata — see inject_derived_parameters)"
            )
        return self.px_to_scan_ratio


class PhaseTransferFunctionSettings(BaseModel):
    """Parameters of the 3-D weak-object phase transfer function.

    Parameter surface mirrors the reference's waveorder config
    (reference ``dynatrack_demo.yaml`` phase.transfer_function block):
    illumination wavelength, refractive index of the medium, detection /
    illumination NA, z padding, contrast inversion. ``yx_pixel_size``
    and ``z_pixel_size`` are injected at runtime (see module docstring).
    """

    model_config = ConfigDict(extra="forbid")

    wavelength_illumination: float = 0.450  # um
    index_of_refraction_media: float = 1.4
    numerical_aperture_detection: float = 1.35
    numerical_aperture_illumination: float = 0.52
    z_padding: int = 5
    invert_phase_contrast: bool = False
    yx_pixel_size: float | None = None  # um, injected
    z_pixel_size: float | None = None  # um, injected

    @model_validator(mode="after")
    def _check(self) -> "PhaseTransferFunctionSettings":
        if self.numerical_aperture_detection > self.index_of_refraction_media:
            raise ValueError("detection NA cannot exceed the medium index")
        if self.z_padding < 0:
            raise ValueError("z_padding must be >= 0")
        return self


class PhaseApplyInverseSettings(BaseModel):
    """Inverse (reconstruction) parameters for phase retrieval."""

    model_config = ConfigDict(extra="forbid")

    reconstruction_algorithm: Literal["Tikhonov"] = "Tikhonov"
    regularization_strength: float = 0.01
    # 3-D transform implementation: "matmul" evaluates the forward and
    # inverse transforms as matmul-DFT einsums (ops/dft.py — exact);
    # "xla" keeps the library FFT. "auto" resolves per platform.
    transform: Literal["auto", "xla", "matmul"] = "auto"


class PhaseSettings(BaseModel):
    """3-D phase reconstruction settings (transfer function + inverse)."""

    model_config = ConfigDict(extra="forbid")

    transfer_function: PhaseTransferFunctionSettings = Field(
        default_factory=PhaseTransferFunctionSettings
    )
    apply_inverse: PhaseApplyInverseSettings = Field(
        default_factory=PhaseApplyInverseSettings
    )


class DeconvolveSettings(BaseModel):
    """Richardson-Lucy deconvolution settings.

    ``iterations=20`` matches the headline benchmark config
    (BASELINE.json configs[1]).
    """

    model_config = ConfigDict(extra="forbid")

    iterations: int = 20
    psf_path: str | None = None  # OME-Zarr or .npy PSF volume
    epsilon: float = 1e-6  # ratio-guard floor
    pad_mode: Literal["reflect", "edge", "constant"] = "reflect"
    # Algorithm selection: "separable" runs RL as per-axis banded
    # convolutions (fast path for (near-)separable PSFs); "auto" picks
    # it when the PSF is
    # rank-decomposable within separable_tol, else falls back to "fft".
    # "hybrid" warm-starts the exact FFT/DFT-path iteration with
    # ``hybrid_separable_iters`` cheap separable iterations on a
    # NONNEGATIVE rank-K CP approximation of the PSF (signed
    # truncations diverge on dark scenes — ops/deconv.py::
    # nonneg_cp_decompose): RL's early iterations restore bulk contrast —
    # work the truncated operator does nearly as well at a fraction of
    # the cost — and the exact tail (``iterations``) converges on the
    # TRUE operator's trajectory, so the limit point is plain exact
    # RL's, not the truncated PSF's biased one. The lever for genuinely
    # non-separable PSFs, where every exact iteration is transform-
    # bound (see ops/deconv.py::rl_hybrid for the measured quality and
    # cost model).
    algorithm: Literal["auto", "fft", "separable", "hybrid"] = "auto"
    separable_tol: float = 1e-4  # PSF reconstruction rel error budget
    max_separable_terms: int = 6
    # Measured-PSF denoising: bead-measured PSFs carry iid noise that
    # no finite rank captures, so strict decomposition always fails on
    # them. "auto" truncates the PSF to its top-K separable terms (SVD
    # truncation IS the denoiser) when the discarded residual is below
    # psf_denoise_max_residual (noise-like), keeping real data on the
    # fast path; larger residuals (true aberration structure) still
    # route to the exact FFT path. Every denoise/fallback is logged.
    psf_denoise: Literal["auto", "off"] = "auto"
    psf_denoise_max_residual: float = 0.05
    # Trim near-zero PSF border planes before planning: measured PSFs
    # arrive in fixed 31-41 voxel patches whose radius would otherwise
    # set every backend's cost (and push z radius past the fused/linear
    # kernels' bounds). Relative to the PSF max; 0 disables.
    psf_crop_tol: float = 1e-5
    # Extended-rank ceiling tried before falling back to FFT. The
    # separable cost is linear in the rank and an FFT iteration costs a
    # fixed multiple of a rank-1 one, so the crossover lies at a rank
    # well past this cap; 24 keeps margin while bounding set-up time
    # and on-chip memory. Applies to both the strict tier
    # (aberrated-but-clean PSFs often need rank 7-10) and the denoise
    # tier (which stops at the residual-drop plateau once the
    # sufficiency target is met, so it rarely reaches the cap).
    max_extended_terms: int = 24
    # Matmul precision for the separable path where the products run in
    # reduced-precision passes: "default" (one bf16 pass) fails the 1e-3
    # parity budget over 20 iterations; "high" (bf16x3) and "highest"
    # meet it at a multiple of the cost.
    matmul_precision: Literal["default", "high", "highest"] = "high"
    # Conv backend within the separable path:
    # * "matmul": per-axis circulant/banded matrix products (circular
    #   boundary on the padded grid);
    # * "zy_pallas": fused z+y kernel with circular boundaries, then the
    #   x axis; kept opt-in;
    # * "linear_pallas": zero-boundary RL on the half-PSF padded grid
    #   (zeros are absorbing under the multiplicative update), z+y
    #   kernel + banded x;
    # * "fused": zero-boundary RL with one kernel pass per half-step;
    # * "fused_iter": one kernel launch per WHOLE RL iteration (both
    #   half-steps pipelined along z through on-chip rings, the ratio
    #   never written to device memory); opt-in, "auto" never picks it.
    # "auto" picks "fused" where its kernels' bounds take the geometry,
    # otherwise "matmul" (ops/deconv.py::resolve_separable_backend).
    separable_backend: Literal[
        "auto", "matmul", "zy_pallas", "linear_pallas", "fused",
        "fused_iter",
    ] = "auto"
    # Precision schedule for the fused backend: run this many LEADING
    # iterations with 2-pass bf16 dots before the 3-pass (HIGH) tail.
    # RL is a fixed-point iteration: the exact tail contracts the cheap
    # phase's trajectory error away. 0 = all HIGH.
    fused_low_precision_iters: int = 0
    # Layout of the FFT fallback path (non-separable PSFs):
    # * "fft3": plain 3-D rFFT update on the padded 5-smooth grid;
    # * "fft2z": the same circular update with the z axis taken OUT of
    #   the transform — batched 2-D rFFTs over (y, x) plus an explicit
    #   banded circular sum over z (the PSF is only kz voxels wide in
    #   z), streamed in z chunks of ``fft_z_chunk`` slices. Identical
    #   math on the identical grid; the chunking bounds the FFT working
    #   set;
    # * "dft2z": the fft2z layout with every 2-D transform evaluated as
    #   matmul-DFT einsums (ops/dft.py four-step Cooley-Tukey);
    # * "dft3": plain whole-volume update with matmul-DFT transforms —
    #   no z-banding, so no banded-sum traffic;
    # * "dftz": the dft2z layout with the banded z sum replaced by an
    #   exact z-DFT matmul + one OTF multiply per half-step.
    # "auto" = platform-resolved 2z backend for 3-D volumes, fft3
    # otherwise.
    fft_backend: Literal["auto", "fft3", "fft2z", "dft2z", "dft3", "dftz"] = "auto"
    # Biggs-Andrews vector acceleration of the RL update (Appl. Opt.
    # 36(8):1766, 1997): before each update, extrapolate the estimate
    # along its last step with a gradient-correlation step length —
    # the same point on the convergence trajectory in roughly half the
    # iterations (accel-10 lands between plain-20 and plain-30). Every
    # single-device backend honors it: the fused backend inside its
    # half-step kernels, the others via the shared outer loop
    # (ops/rl_outer.py); drop `iterations` accordingly (e.g. 20 -> 10).
    # What it nets per backend is a measurement (PERF.md), not a
    # constant. Costs one extra estimate-sized carry (the step/gradient
    # state is held in bf16 — see ops/rl_outer.py for the numerics
    # bound). The distributed shard_volumes path runs plain RL only and
    # raises if asked to accelerate.
    acceleration: Literal["none", "biggs"] = "none"
    # algorithm="hybrid" only: number of warm-start iterations run with
    # the nonneg rank-K CP PSF before the ``iterations`` exact FFT/DFT-
    # path iterations. Each warm iteration advances the exact
    # trajectory by ~0.9-1.0 exact iterations on the bench PSF
    # (measured, tests/test_deconv.py hybrid trajectory tests) at
    # ~1/9 the cost, so hybrid(s=16, e=6) beats plain exact RL-20 at
    # ~2.5x the throughput; 0 degenerates to the plain FFT path.
    # ``acceleration`` applies to both phases (each restarts the Biggs
    # alpha at its boundary); accelerating the warm phase is
    # load-bearing — hybrid(s=16, e=3, acceleration='biggs') beats
    # plain exact RL-20 by a ~34% trajectory margin (the fastest
    # RL-20-equivalent non-separable configuration,
    # tests/test_deconv.py::test_hybrid_biggs_beats_plain_rl20).
    hybrid_separable_iters: int = 16
    # Donate the input volume's buffer to the deconvolution: the INPUT
    # IS CONSUMED — the caller's array is invalid after the call. The
    # raw volume is dead after the padded data/est carries are built,
    # so donating it frees one volume of device memory for the
    # iteration arena. Honored at richardson_lucy's dispatch boundary;
    # inert inside the pipeline step, which owns its intermediates. Off
    # by default because consuming the input is a real API side effect.
    donate_input: bool = False
    fft_z_chunk: int = 8

    @model_validator(mode="after")
    def _check(self) -> "DeconvolveSettings":
        if self.iterations < 1:
            raise ValueError("iterations must be >= 1")
        if self.fused_low_precision_iters < 0:
            raise ValueError("fused_low_precision_iters must be >= 0")
        if self.hybrid_separable_iters < 0:
            raise ValueError("hybrid_separable_iters must be >= 0")
        if self.fft_z_chunk < 1:
            raise ValueError("fft_z_chunk must be >= 1")
        return self


class RegistrationSettings(BaseModel):
    """Cross-modality (label-free <-> fluorescence) registration.

    Estimate = phase cross-correlation for the translation seed, then
    optional differentiable affine refinement by gradient descent on a
    similarity loss (the JAX-native upgrade of the reference's fixed
    3x3 ``image_to_stage_matrix_xyz``, reference ``tracking.py:1172-1181``).
    """

    model_config = ConfigDict(extra="forbid")

    method: Literal["pcc", "pcc+refine"] = "pcc+refine"
    maximum_shift: float = 1.0
    refine_iterations: int = 100
    learning_rate: float = 0.05
    loss: Literal["mse", "ncc"] = "ncc"
    # "triangular" (default) constrains the refined matrix to
    # lower-triangular (scale + shear + translation — the mantis
    # label-free<->light-sheet misalignment model; no rotation). An
    # exactly triangular matrix applies through the gather-free shear
    # path (~2 orders of magnitude faster per volume at apply time,
    # ops/register.py::_triangular_apply_jit). "full" refines all 9
    # matrix entries and applies through the trilinear gather.
    parameterization: Literal["triangular", "full"] = "triangular"
    # Refinement evaluates the loss on a y/x-strided output grid
    # (sampling positions stay full-res; only the number of constraint
    # points drops — 12 affine params vs ~260k samples at stride 4),
    # with no loss of recovered-shift accuracy.
    downsample_yx: int = 4
    # Apply-time transform source for the reconstruction pipeline: the
    # JSON written by the `register` CLI verb ({"matrix_zyx", "offset_zyx"}).
    transform_path: str | None = None


# ---------------------------------------------------------------------------
# Tracking settings (DynaTrack parity; reference tracking.py:45-234)
# ---------------------------------------------------------------------------


class ShiftSettings(BaseModel):
    """Shift search range, per-axis bounds, and dampening.

    Same semantics as the reference (``tracking.py:45-67``): ``maximum``
    scales the FFT padding of the PCC search; ``limits`` maps axis name
    ("z"/"y"/"x") to (min, max) microns — below min the shift is zeroed
    (deadband), above max it is clipped preserving sign; ``dampening``
    multiplies the (z, y, x) shift.
    """

    model_config = ConfigDict(extra="forbid")

    maximum: float = 1.0
    limits: dict[str, tuple[float, float]] | None = None
    dampening: tuple[float, float, float] | None = None


class SegmentationSettings(BaseModel):
    """Parameters for the ``multiotsu_*`` methods (reference ``tracking.py:69-84``)."""

    model_config = ConfigDict(extra="forbid")

    otsu_sigma: float = 5.0
    otsu_component: int = 0


class RoiCenterSettings(BaseModel):
    """Parameters for referenceless ROI-centre methods (reference ``tracking.py:86-113``)."""

    model_config = ConfigDict(extra="forbid")

    blob_sigma: float = 10.0
    background_percentile: float | None = None
    blur_sigma: float = 0.0


class TemplateSettings(BaseModel):
    """Parameters for the ``template_matching`` method (reference archive
    ``autotracker.py:162-184``): per-axis ``(start, stop)`` bounds of
    the template region sliced from the reference stack."""

    model_config = ConfigDict(extra="forbid")

    slice_zyx: tuple[
        tuple[int, int], tuple[int, int], tuple[int, int]
    ] | None = None

    @model_validator(mode="after")
    def _check(self) -> "TemplateSettings":
        if self.slice_zyx is not None:
            for ax, (start, stop) in enumerate(self.slice_zyx):
                if start < 0 or stop <= start:
                    raise ValueError(
                        f"template slice_zyx[{ax}]={start, stop} must satisfy "
                        "0 <= start < stop"
                    )
        return self


TRACKING_METHODS = (
    "pcc",
    "intensity_center_of_mass",
    "roi_center_pcc",
    "multiotsu_center_of_mass",
    "multiotsu_pcc",
    "template_matching",
)

# Methods whose target is the ROI centre rather than a stored reference
# stack (reference tracking.py:237-240) — must match the referenceless
# dispatch in tracking/core.py (_roi_center_shift callers).
ROI_CENTER_METHODS = frozenset({
    "intensity_center_of_mass",
    "multiotsu_center_of_mass",
    "roi_center_pcc",
})


class DynaTrackConfig(BaseModel):
    """DynaTrack position-tracking configuration.

    Field-for-field parity with the reference's ``DynaTrackConfig``
    (``tracking.py:115-234``), with the nested deskew/phase configs
    validated eagerly against our first-party schemas instead of
    lazily against external biahub/waveorder ones.
    """

    model_config = ConfigDict(extra="forbid")

    enabled: bool = True
    input_channel: str
    z_device: str | None = None
    shift: ShiftSettings = Field(default_factory=ShiftSettings)
    tracking_interval: int = 1
    tracking_method: str = "pcc"
    segmentation: SegmentationSettings = Field(default_factory=SegmentationSettings)
    roi_center: RoiCenterSettings = Field(default_factory=RoiCenterSettings)
    template: TemplateSettings = Field(default_factory=TemplateSettings)
    reference_update_interval: int = 0
    tracking_channel: str
    preprocessing: list[str] | None = None
    deskew: dict[str, Any] | None = None
    phase: dict[str, Any] | None = None
    virtual_staining: dict[str, Any] | None = None
    image_to_stage_matrix_xyz: list[list[float]] | None = None
    shift_log_path: str | Path | None = None
    debug: bool = False

    @model_validator(mode="after")
    def _check(self) -> "DynaTrackConfig":
        if self.tracking_method not in TRACKING_METHODS:
            raise ValueError(
                f"Unknown tracking_method={self.tracking_method!r}; "
                f"use one of {TRACKING_METHODS}"
            )
        if self.tracking_method == "template_matching" and (
            self.template.slice_zyx is None
        ):
            raise ValueError(
                "tracking_method='template_matching' requires "
                "template.slice_zyx (per-axis (start, stop) bounds of the "
                "template region in the reference stack)"
            )
        # Channel-name rules (reference tracking.py:180-190): the
        # intermediate products are not trackable by name; "vs_*" target
        # channels are valid only when virtual staining is configured.
        if self.tracking_channel in ("raw", "phase", "deskewed"):
            raise ValueError(
                f"tracking_channel={self.tracking_channel!r} names an "
                "intermediate product; use the input channel name or a "
                "virtual_staining target channel"
            )
        if self.tracking_channel.startswith("vs_"):
            vs = self.virtual_staining or {}
            targets = vs.get("out_channels")
            if targets is None and vs.get("ckpt_path"):
                # ckpt_path-only configs take out_channels from the
                # checkpoint's sidecar when it exists (written by
                # VirtualStainer.save_ckpt).
                from shrimpy_tpu_torch.config.vs_sidecar import read_vs_sidecar

                sidecar = read_vs_sidecar(vs["ckpt_path"])
                if sidecar is not None:
                    targets = sidecar.get("out_channels")
            if targets is None and not vs.get("ckpt_path"):
                from shrimpy_tpu_torch.config.vs_sidecar import DEFAULT_OUT_CHANNELS

                targets = DEFAULT_OUT_CHANNELS
            if targets is not None and self.tracking_channel not in targets:
                raise ValueError(
                    f"tracking_channel={self.tracking_channel!r} is not among "
                    f"virtual_staining out_channels={targets}"
                )
        if self.preprocessing:
            allowed = {"deskew", "phase", "vs"}
            unknown = set(self.preprocessing) - allowed
            if unknown:
                raise ValueError(f"Unknown preprocessing steps: {sorted(unknown)}")
            if "vs" in self.preprocessing and "phase" not in self.preprocessing:
                raise ValueError("'vs' preprocessing requires 'phase' first")
        # Eagerly validate nested kernel configs.
        if self.deskew is not None:
            DeskewSettings(**self.deskew)
        if self.phase is not None:
            PhaseSettings(**self.phase)
        return self

    @property
    def referenceless(self) -> bool:
        return self.tracking_method in ROI_CENTER_METHODS

    def deskew_settings(self) -> DeskewSettings | None:
        return DeskewSettings(**self.deskew) if self.deskew is not None else None

    def phase_settings(self) -> PhaseSettings | None:
        return PhaseSettings(**self.phase) if self.phase is not None else None


# ---------------------------------------------------------------------------
# Top-level reconstruction settings (CLI surface)
# ---------------------------------------------------------------------------


class IORetrySettings(BaseModel):
    """Streaming-IO fault tolerance (the reference's retry layer,
    reference ``shrimpy/robust_cmmcore.py:24-53``, applied to the
    tensorstore read/write surface): each item read/write retries in
    place; a persistently failing item is journaled failed-and-skipped
    so one bad chunk cannot abort a plate run (reference
    ``position_update.py:409-413`` contains per-item failures the same
    way). Failed items are NOT marked done, so ``resume=True`` retries
    them."""

    model_config = ConfigDict(extra="forbid")

    attempts: int = 3
    wait_s: float = 1.0
    # False = first persistent failure aborts the run (strict mode).
    contain_failures: bool = True

    @model_validator(mode="after")
    def _check(self):
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.wait_s < 0:
            raise ValueError("wait_s must be >= 0")
        return self


class ReconstructSettings(BaseModel):
    """Settings for the ``reconstruct`` verb: which stages to run.

    The TPU-side fused pipeline applies the enabled stages per
    (position, timepoint, channel) volume: deskew -> phase -> register
    -> deconvolve.
    """

    model_config = ConfigDict(extra="forbid")

    deskew: DeskewSettings | None = None
    phase: PhaseSettings | None = None
    registration: RegistrationSettings | None = None
    deconvolve: DeconvolveSettings | None = None
    channels: list[str] | None = None  # None = all
    positions: list[str] | None = None  # None = all
    time_indices: list[int] | None = None  # None = all
    output_dtype: Literal["float32", "uint16"] = "float32"
    # Multiscale pyramid levels written through to the output store
    # (reference datasets carry NGFF pyramids, docs/data_structure.md:
    # 60-94); 0 = base resolution only.
    pyramid_levels: int = 0
    # Volumes larger than one device's HBM: keep each volume's X extent
    # sharded over the mesh's 'space' axis through the volumetric
    # stages too (distributed slab FFTs via XLA collectives), instead
    # of resharding to whole volumes per device. Forces the FFT RL
    # path — the Pallas/separable kernels are volume-local (SURVEY §5.7).
    shard_volumes: bool = False
    io_retry: IORetrySettings = Field(default_factory=IORetrySettings)

    @model_validator(mode="after")
    def _check_shard_volumes(self) -> "ReconstructSettings":
        if (
            self.shard_volumes
            and self.deconvolve is not None
            and self.deconvolve.algorithm in ("separable", "hybrid")
        ):
            raise ValueError(
                "shard_volumes requires the FFT deconvolution path "
                "(algorithm='fft' or 'auto'); the separable kernels "
                f"(algorithm='{self.deconvolve.algorithm}') are "
                "volume-local"
            )
        return self


class ReconstructArms(BaseModel):
    """Multi-arm reconstruction: per-arm settings over channel subsets.

    The mantis dual-arm layout (label-free + light-sheet, reference
    archive ``acq_engine.py:98-1653``; on disk the reference keeps
    ``*_labelfree.zarr`` / ``*_lightsheet.zarr`` siblings): each arm is
    a full :class:`ReconstructSettings` whose ``channels`` field selects
    the channels it processes; outputs land in per-arm stores.
    """

    model_config = ConfigDict(extra="forbid")

    arms: dict[str, ReconstructSettings]

    @model_validator(mode="after")
    def _check(self) -> "ReconstructArms":
        if not self.arms:
            raise ValueError("arms must not be empty")
        return self


# ---------------------------------------------------------------------------
# Derived-parameter injection + YAML loading
# ---------------------------------------------------------------------------


def inject_derived_parameters(
    config: DynaTrackConfig | ReconstructSettings,
    *,
    pixel_size_um: float,
    z_step_um: float,
) -> None:
    """Inject the runtime-derived pixel size / z step into sub-configs.

    The single-source-of-truth rule from the reference
    (``manager.py:242-262``): the dataset/acquisition metadata supplies
    ``pixel_size_um`` and ``z_step_um``; they are pushed into the deskew
    (``pixel_size_um``/``scan_step_um``) and phase
    (``yx_pixel_size``/``z_pixel_size``) blocks rather than duplicated
    in config files.
    """
    if isinstance(config, DynaTrackConfig):
        # A LISTED preprocessing step without a settings block runs with
        # defaults + these injected parameters (the Preprocessor
        # contract: never a silent skip) — materialize the block so the
        # injection has somewhere to land.
        steps = tuple(config.preprocessing or ())
        if config.deskew is None and "deskew" in steps:
            config.deskew = {}
        if config.phase is None and "phase" in steps:
            config.phase = {}
        if config.deskew is not None:
            config.deskew.setdefault("pixel_size_um", pixel_size_um)
            config.deskew.setdefault("scan_step_um", z_step_um)
            DeskewSettings(**config.deskew)  # re-validate
        if config.phase is not None:
            tf = config.phase.setdefault("transfer_function", {})
            tf.setdefault("yx_pixel_size", pixel_size_um)
            tf.setdefault("z_pixel_size", z_step_um)
            PhaseSettings(**config.phase)
        return

    if config.deskew is not None:
        if config.deskew.pixel_size_um is None:
            config.deskew.pixel_size_um = pixel_size_um
        if config.deskew.scan_step_um is None:
            config.deskew.scan_step_um = z_step_um
        if config.deskew.px_to_scan_ratio is None:
            config.deskew.px_to_scan_ratio = round(
                config.deskew.pixel_size_um / config.deskew.scan_step_um, 3
            )
    if config.phase is not None:
        tf = config.phase.transfer_function
        if tf.yx_pixel_size is None:
            tf.yx_pixel_size = pixel_size_um
        if tf.z_pixel_size is None:
            tf.z_pixel_size = z_step_um


def load_yaml_config(path: str | Path, model: type[BaseModel]) -> BaseModel:
    """Load and validate a YAML file against a pydantic model."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return model(**raw)
