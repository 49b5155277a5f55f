"""Single-device reconstruction step: deskew -> phase -> register ->
deconvolve (counterpart of ``shrimpy_tpu/parallel/pipeline.py``:
``build_reconstruct_step``, ``reconstruct_batch``, ``output_shape``,
``_stage_fns``, ``_register_fn``, ``_deconv_fn``,
``_stage_input_shape_for_phase``).

The JAX step is one jit program mapped over the batch and sharded over
a mesh. PyTorch runs eagerly, so the port's step is a Python loop over
the volumes of a ``(B, S, T, X)`` batch on one device, in the JAX
order: the deskew kernel; the phase inverse (``torch.fft``, with the
transfer function the caller passes or the step computes once per
shape on the host); the affine warp of a transform JSON when
``registration.transform_path`` is set (one kernel launch); then RL as
``richardson_lucy`` dispatches it: separable (the half-step kernels),
``hybrid`` (separable warm iterations, then the FFT RL) or the FFT RL
(``torch.fft`` and, on ``fft2z``, the band kernel) for ``fft`` and for
a PSF no separable tier takes. ``shard_volumes`` and a mesh are not
ported yet and raise :class:`NotImplementedError`.

Settings are read by attribute: a pydantic ``ReconstructSettings`` or
a :class:`types.SimpleNamespace` with the same field names (see
:mod:`shrimpy_tpu_torch.config`).
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.ops.deconv import (
    check_ported,
    plan_hybrid_terms,
    plan_terms,
    prepare_psf,
    rl_hybrid,
    rl_separable,
)
from shrimpy_tpu_torch.ops.deskew import (
    DESKEW_BACKENDS,
    deskew_plain,
    deskew_volume,
    get_deskewed_shape,
)
from shrimpy_tpu_torch.ops.phase import (
    apply_inverse_transfer_function,
    compute_transfer_function,
    tf_tensor,
)
from shrimpy_tpu_torch.ops.register import affine_apply, affine_apply_plain
from shrimpy_tpu_torch.ops.rl_fft import rl_fft
from shrimpy_tpu_torch.utils.device import as_tensor, resolve_device


def _check_ported(settings, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port runs one device: mesh must be None (multi-GPU is "
            "ROADMAP queue 1 item 11)"
        )
    if getattr(settings, "shard_volumes", False):
        raise NotImplementedError(
            "shard_volumes is not ported yet: ROADMAP queue 1 item 11"
        )


def _deskew_fn(settings, *, plain: bool, dtype: torch.dtype):
    desk = settings.deskew
    if desk is None:
        return None
    if desk.backend not in DESKEW_BACKENDS:
        raise ValueError(f"deskew backend {desk.backend!r} not in {DESKEW_BACKENDS}")
    if plain:
        return lambda raw: deskew_plain(raw, desk, dtype=dtype)
    return lambda raw: deskew_volume(raw, desk)


def _phase_fn(settings, *, dtype: torch.dtype):
    """Per-volume phase inverse ``fn(vol, tf)``, ``tf`` a complex tensor
    on the volume's device; None without ``settings.phase``."""
    phase = settings.phase
    if phase is None:
        return None
    z_padding = phase.transfer_function.z_padding

    def inverse(vol: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
        return apply_inverse_transfer_function(vol, tf, phase.apply_inverse,
                                               z_padding=z_padding, dtype=dtype)

    return inverse


def _register_fn(settings, *, plain: bool, dtype: torch.dtype):
    """Affine-apply stage from the transform JSON the ``register`` verb
    writes (``{"matrix_zyx", "offset_zyx"}``), read once here; None
    without ``registration.transform_path``, as in the JAX package."""
    reg = settings.registration
    if reg is None or reg.transform_path is None:
        return None
    import json

    with open(reg.transform_path) as f:
        transform = json.load(f)
    matrix = np.asarray(transform["matrix_zyx"], np.float32)
    offset = np.asarray(transform["offset_zyx"], np.float32)
    if plain:
        return lambda vol: affine_apply_plain(vol, matrix, offset, tuple(vol.shape), dtype=dtype)
    # The map on each device the step meets, copied there once: a copy from
    # the host a volume would wait for the card to finish the deskew.
    maps = {}

    def apply(vol: torch.Tensor) -> torch.Tensor:
        if vol.device not in maps:
            maps[vol.device] = (torch.from_numpy(matrix).to(vol.device),
                                torch.from_numpy(offset).to(vol.device))
        return affine_apply(vol, *maps[vol.device], tuple(vol.shape))

    return apply


def _deconv_fn(settings, psf, *, terms=None, plain: bool, dtype: torch.dtype):
    """Per-volume RL stage with the PSF (and its separable or warm terms)
    fixed at build time, dispatched as JAX's ``_deconv_fn`` and
    ``richardson_lucy`` do: ``hybrid`` (with warm iterations) through
    :func:`~shrimpy_tpu_torch.ops.deconv.rl_hybrid`, ``auto`` and
    ``separable`` through the separable path where the PSF decomposes,
    the FFT RL otherwise and under ``fft``. ``terms`` overrides the
    planned separable (or, under ``hybrid``, warm) terms."""
    deconv = settings.deconvolve
    if deconv is None:
        return None
    if psf is None:
        raise ValueError("deconvolve stage enabled but no PSF provided")
    check_ported(deconv)
    psf_np = prepare_psf(psf, deconv)
    kw = {"plain": plain, "dtype": dtype}
    if deconv.algorithm == "hybrid" and deconv.hybrid_separable_iters:
        warm = terms if terms is not None else plan_hybrid_terms(psf_np, deconv)[0]
        return lambda vol: rl_hybrid(vol, psf_np, warm, deconv, deconv.iterations, **kw)
    if deconv.algorithm in ("auto", "separable"):
        if terms is None:
            terms = plan_terms(psf_np, deconv)
        if terms is not None:
            return lambda vol: rl_separable(vol, psf_np, terms, deconv, deconv.iterations, **kw)
    return lambda vol: rl_fft(vol, psf_np, deconv, deconv.iterations, **kw)


def _stage_fns(settings, psf, mesh=None, *, terms=None, plain=False,
               dtype=torch.float32):
    """``(deskew_fn, phase_fn, register_fn, deconv_fn)`` per-volume
    stages, each None where the settings leave it out."""
    _check_ported(settings, mesh)
    return (
        _deskew_fn(settings, plain=plain, dtype=dtype),
        _phase_fn(settings, dtype=dtype),
        _register_fn(settings, plain=plain, dtype=dtype),
        _deconv_fn(settings, psf, terms=terms, plain=plain, dtype=dtype),
    )


def build_reconstruct_step(
    settings,
    *,
    psf: np.ndarray | None = None,
    mesh=None,
    device: str | torch.device | None = None,
    terms=None,
    plain: bool = False,
    dtype: torch.dtype = torch.float32,
    donate: bool = True,
):
    """Batched step ``fn(batch_raw, tf=None) -> batch_out``.

    ``batch_raw`` is ``(B, S, T, X)``: a tensor, which stays on its
    device unless ``device`` moves it, or a numpy array, which goes to
    ``device`` (the card when None, raising where there is none;
    ``"cpu"`` asks for the CPU). The output is ``(B, Z, Y, X)`` on the
    same device. ``tf`` is the phase stage's transfer function for the
    volume entering it (:func:`compute_transfer_function` of
    :func:`_stage_input_shape_for_phase`): complex, or the (2, Z, Y, X)
    real pair the JAX step takes. With the phase stage set and ``tf``
    None, the step computes it on the host once per volume shape and
    keeps it on the device. ``terms`` overrides the planned separable
    decomposition (numpy ``(wz, wy, wx)`` triples; under ``hybrid`` the
    warm terms). On a CUDA device the stages run the CUDA kernels;
    ``plain=True`` runs their plain PyTorch versions in ``dtype`` instead
    (the reference path).

    ``donate`` (JAX's default, True) lets the step drop its own reference
    to the batch once the last volume has entered the first stage, so a
    device copy the step made of a numpy batch returns to the allocator
    before the later stages run. The step never writes or empties the
    caller's tensor (unlike ``donate_input``, which consumes the image,
    ``ops/rl_fused.py::consume``), so a caller may reuse its batch under
    both values; ``donate=False`` keeps the reference for the whole call.
    """
    dev = resolve_device(device)
    deskew_fn, phase_fn, register_fn, deconv_fn = _stage_fns(
        settings, psf, mesh, terms=terms, plain=plain, dtype=dtype
    )
    computed = {}

    def phase_tf(vol: torch.Tensor, tf) -> torch.Tensor:
        if tf is not None:
            return tf_tensor(tf, vol.device)
        key = (tuple(vol.shape), vol.device)
        if key not in computed:
            computed.clear()
            computed[key] = tf_tensor(compute_transfer_function(
                key[0], settings.phase.transfer_function), vol.device)
        return computed[key]

    def step(batch_raw, tf=None) -> torch.Tensor:
        batch = as_tensor(batch_raw, dev)
        if batch.dim() != 4:
            raise ValueError(f"batch must be (B, S, T, X), got {tuple(batch.shape)}")
        outs, n = [], batch.shape[0]
        for b in range(n):
            vol = batch[b]
            if donate and b == n - 1:
                batch = None
            if deskew_fn is not None:
                vol = deskew_fn(vol)
            if phase_fn is not None:
                vol = phase_fn(vol, phase_tf(vol, tf))
            if register_fn is not None:
                vol = register_fn(vol)
            if deconv_fn is not None:
                vol = deconv_fn(vol)
            outs.append(vol.to(dtype))
        return outs[0][None] if len(outs) == 1 else torch.stack(outs)

    return step


def reconstruct_batch(batch_raw, settings, *, psf=None, mesh=None, device=None,
                      terms=None) -> torch.Tensor:
    """One-shot convenience: build the step and run it (``device`` as in
    :func:`build_reconstruct_step`)."""
    step = build_reconstruct_step(settings, psf=psf, mesh=mesh, device=device, terms=terms,
                                  donate=False)
    return step(batch_raw)


def _stage_input_shape_for_phase(raw_shape: tuple[int, int, int],
                                 settings) -> tuple[int, int, int]:
    """Shape of the volume entering the phase stage (post-deskew if any)."""
    if settings.deskew is not None:
        shape, _ = get_deskewed_shape(tuple(raw_shape), settings.deskew)
        return shape
    return tuple(raw_shape)


def output_shape(raw_shape: tuple[int, int, int], settings) -> tuple[int, int, int]:
    """Static output ZYX shape of the reconstruction for ``raw_shape``."""
    return _stage_input_shape_for_phase(raw_shape, settings)
