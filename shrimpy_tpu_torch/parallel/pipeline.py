"""Single-device reconstruction step: deskew -> register -> deconvolve
(counterpart of ``shrimpy_tpu/parallel/pipeline.py``:
``build_reconstruct_step``, ``reconstruct_batch``, ``output_shape``,
``_stage_fns``, ``_register_fn``, ``_deconv_fn``).

The JAX step is one jit program mapped over the batch and sharded over
a mesh. PyTorch runs eagerly, so the port's step is a Python loop over
the volumes of a ``(B, S, T, X)`` batch on one device: the deskew
kernel, then the affine warp of a transform JSON when
``registration.transform_path`` is set (one kernel launch), then
separable RL (two half-step kernels per iteration). The phase stage,
``shard_volumes`` and a mesh are not ported yet and raise
:class:`NotImplementedError`.

Settings are read by attribute: a pydantic ``ReconstructSettings`` or
a :class:`types.SimpleNamespace` with the same field names (see
:mod:`shrimpy_tpu_torch.config`).
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.ops.deconv import (
    check_ported,
    plan_terms,
    prepare_psf,
    rl_separable,
)
from shrimpy_tpu_torch.ops.deskew import (
    DESKEW_BACKENDS,
    deskew_plain,
    deskew_volume,
    get_deskewed_shape,
)
from shrimpy_tpu_torch.ops.register import affine_apply, affine_apply_plain
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
    if settings.phase is not None:
        raise NotImplementedError(
            "the phase stage is not ported yet: ROADMAP queue 1 item 7"
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
    """Per-volume RL stage with the PSF (and its separable terms) fixed
    at build time."""
    deconv = settings.deconvolve
    if deconv is None:
        return None
    if psf is None:
        raise ValueError("deconvolve stage enabled but no PSF provided")
    check_ported(deconv)
    psf_np = prepare_psf(psf, deconv)
    if terms is None:
        terms = plan_terms(psf_np, deconv)

    def rl(vol: torch.Tensor) -> torch.Tensor:
        return rl_separable(
            vol, psf_np, terms, deconv, deconv.iterations, plain=plain, dtype=dtype
        )

    return rl


def _stage_fns(settings, psf, mesh=None, *, terms=None, plain=False,
               dtype=torch.float32):
    """``(deskew_fn, register_fn, deconv_fn)`` per-volume stages, each
    None where the settings leave it out."""
    _check_ported(settings, mesh)
    return (
        _deskew_fn(settings, plain=plain, dtype=dtype),
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
):
    """Batched step ``fn(batch_raw, tf=None) -> batch_out``.

    ``batch_raw`` is ``(B, S, T, X)``: a tensor, which stays on its
    device unless ``device`` moves it, or a numpy array, which goes to
    ``device`` (the card when None, raising where there is none;
    ``"cpu"`` asks for the CPU). The output is ``(B, Z, Y, X)`` on the
    same device. ``tf`` is accepted for the JAX signature and unused
    (the phase stage is not ported). ``terms`` overrides the planned
    separable decomposition (numpy ``(wz, wy, wx)`` triples). On a CUDA
    device the stages run the CUDA kernels; ``plain=True`` runs their
    plain PyTorch versions in ``dtype`` instead (the reference path).
    """
    dev = resolve_device(device)
    deskew_fn, register_fn, deconv_fn = _stage_fns(
        settings, psf, mesh, terms=terms, plain=plain, dtype=dtype
    )

    def step(batch_raw, tf=None) -> torch.Tensor:
        batch = as_tensor(batch_raw, dev)
        if batch.dim() != 4:
            raise ValueError(f"batch must be (B, S, T, X), got {tuple(batch.shape)}")
        outs = []
        for b in range(batch.shape[0]):
            vol = batch[b]
            if deskew_fn is not None:
                vol = deskew_fn(vol)
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
    step = build_reconstruct_step(settings, psf=psf, mesh=mesh, device=device, terms=terms)
    return step(batch_raw)


def output_shape(raw_shape: tuple[int, int, int], settings) -> tuple[int, int, int]:
    """Static output ZYX shape of the reconstruction for ``raw_shape``."""
    if settings.deskew is not None:
        shape, _ = get_deskewed_shape(tuple(raw_shape), settings.deskew)
        return shape
    return tuple(raw_shape)
