"""Affine registration: PCC seed, gradient refine, affine apply
(counterpart of ``shrimpy_tpu/ops/register.py``: ``affine_apply``,
``_affine_apply_jit``, ``_trilinear_sample``, ``mse_loss``, ``ncc_loss``,
``RegistrationResult``, ``_refine_jit``, ``estimate_registration``,
``affine_apply_reference_scipy``).

Conventions are the JAX package's: ``matrix`` (3, 3) and ``offset`` (3,)
map OUTPUT (fixed-frame) voxel coordinates to INPUT (moving-frame) ones,
ZYX, ``in = matrix @ out + offset``, as ``scipy.ndimage.affine_transform``
does; the warp is scipy's order-1 ``grid-constant`` (trilinear, corners
outside the volume weigh 0).

:func:`affine_apply` runs the kernel of ``csrc/affine.cu`` on a CUDA
tensor, for every matrix, and the plain version :func:`affine_apply_plain`
on a CPU tensor. The JAX package dispatches a concrete matrix to one of
four XLA tiers (a translation by masked rolls, a triangular map by 1-D
shear passes, a blocked candidate window, the one-shot gather), which
compute the same function and exist because gathers serialize on the
TPU; on the card one gather kernel is the fast path for all four, so the
plain version ports the gather tier alone and is held against all four
in the tests.

The refine (:func:`estimate_registration`, ``pcc+refine``) is
``_refine_jit`` in torch: the objective and its gradient with respect to
the map in one call (:class:`RefineObjective`; on the card two kernel
launches, :func:`~shrimpy_tpu_torch.ops.affine_cuda.refine_objective_cuda`,
on the CPU :func:`refine_objective_plain`: the closed-form derivative of
the loss by the warp, then torch autograd of the plain warp) and
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, in exact
arithmetic the update of ``optax.adam(lr)``; the two round differently
(torch divides by ``sqrt(v) / sqrt(1 - b2^t) + eps``, optax by
``sqrt(v / (1 - b2^t)) + eps``), so parameters agree to float32 rounding
grown over the iterations (``tests/test_torch_register.py``: 1e-5 after
1 and 5 iterations).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from shrimpy_tpu_torch.config import registration_settings
from shrimpy_tpu_torch.ops.pcc import phase_cross_correlation
from shrimpy_tpu_torch.utils.device import as_tensor

# Output voxels a chunk of the plain version samples at once: its index and
# weight temporaries stay ~1 GB in float64 at the production volume.
PLAIN_CHUNK_VOXELS = 1 << 24


# ---------------------------------------------------------------------------
# Affine apply
# ---------------------------------------------------------------------------


def _as_map(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)


def _trilinear_sample(vol: torch.Tensor, coords) -> torch.Tensor:
    """Sample ``vol`` at fractional ZYX ``coords`` (three tensors of one
    shape), zero outside: the JAX function's corner order and weights."""
    nz, ny, nx = vol.shape
    floors = [torch.floor(c) for c in coords]
    fracs = [c - f for c, f in zip(coords, floors)]
    base = [f.to(torch.int64) for f in floors]
    flat = vol.reshape(-1)
    out = torch.zeros(coords[0].shape, dtype=vol.dtype, device=vol.device)
    for dz in (0, 1):
        for dy in (0, 1):
            idx0, idx1 = base[0] + dz, base[1] + dy
            w_zy = (fracs[0] if dz else 1.0 - fracs[0]) * (fracs[1] if dy else 1.0 - fracs[1])
            valid_zy = (idx0 >= 0) & (idx0 < nz) & (idx1 >= 0) & (idx1 < ny)
            lin_zy = (idx0.clamp(0, nz - 1) * ny + idx1.clamp(0, ny - 1)) * nx
            for dx in (0, 1):
                idx2 = base[2] + dx
                w = w_zy * (fracs[2] if dx else 1.0 - fracs[2])
                valid = valid_zy & (idx2 >= 0) & (idx2 < nx)
                vals = torch.take(flat, lin_zy + idx2.clamp(0, nx - 1))
                out = out + torch.where(valid, w, 0.0) * vals
    return out


def affine_apply_plain(vol, matrix, offset=(0.0, 0.0, 0.0), output_shape=None, *,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The warp in plain PyTorch (any device): ``_affine_apply_jit`` +
    ``_trilinear_sample`` in ``dtype`` (float32 as the JAX package forms
    it, float64 for the oracle), over chunks of output z-slabs of about
    :data:`PLAIN_CHUNK_VOXELS` voxels. Differentiable in ``matrix`` and
    ``offset`` when they are tensors that require a gradient."""
    if vol.is_cuda:
        affine_apply_plain.cuda_calls += 1
    vol = vol.to(dtype)
    dev = vol.device
    shape = tuple(int(s) for s in (output_shape or vol.shape))
    m, t = _as_map(matrix, dtype, dev), _as_map(offset, dtype, dev)
    oz, oy, ox = shape
    yy = torch.arange(oy, dtype=dtype, device=dev)[:, None]
    xx = torch.arange(ox, dtype=dtype, device=dev)[None, :]
    slabs = max(1, PLAIN_CHUNK_VOXELS // max(1, oy * ox))
    parts = []
    for z0 in range(0, oz, slabs):
        zz = torch.arange(z0, min(z0 + slabs, oz), dtype=dtype, device=dev)[:, None, None]
        coords = [m[a, 0] * zz + m[a, 1] * yy + m[a, 2] * xx + t[a] for a in range(3)]
        parts.append(_trilinear_sample(vol, torch.broadcast_tensors(*coords)))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


# Calls of the plain version on a CUDA tensor since the last reset: the
# reference path makes them, a kernel path never does.
affine_apply_plain.cuda_calls = 0


def affine_apply(vol, matrix, offset=(0.0, 0.0, 0.0), output_shape=None, *,
                 device=None) -> torch.Tensor:
    """Warp ``vol`` by the inverse map ``in = matrix @ out + offset`` (ZYX)
    to ``output_shape`` (default ``vol``'s), float32.

    Oracle: ``scipy.ndimage.affine_transform(vol, matrix, offset,
    output_shape, order=1, mode='grid-constant')``. ``vol`` is a tensor,
    which stays on its device unless ``device`` moves it, or a numpy
    array, which goes to ``device`` (the card when None; ``"cpu"`` asks
    for the CPU). A CUDA tensor runs the kernel of ``csrc/affine.cu`` and
    raises if it cannot; a CPU tensor runs :func:`affine_apply_plain`.
    """
    vol = as_tensor(vol, device)
    shape = tuple(output_shape or vol.shape)
    if not vol.is_cuda:
        return affine_apply_plain(vol, matrix, offset, shape)
    from shrimpy_tpu_torch.ops.affine_cuda import affine_warp_cuda, map_params

    dev = vol.device
    params = map_params(_as_map(matrix, torch.float32, dev), _as_map(offset, torch.float32, dev))
    return affine_warp_cuda(vol.to(torch.float32).contiguous(), params, shape)


# ---------------------------------------------------------------------------
# Similarity losses
# ---------------------------------------------------------------------------


def mse_loss(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """MSE, optionally weighted (``w`` masks out-of-support voxels)."""
    if w is None:
        return torch.mean((a - b) ** 2)
    return torch.sum(w * (a - b) ** 2) / torch.clamp_min(torch.sum(w), 1.0)


def ncc_loss(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """1 - normalized cross-correlation, optionally weighted."""
    if w is None:
        a = a - torch.mean(a)
        b = b - torch.mean(b)
        denom = torch.sqrt(torch.sum(a**2) * torch.sum(b**2)) + 1e-8
        return 1.0 - torch.sum(a * b) / denom
    n = torch.clamp_min(torch.sum(w), 1.0)
    a = a - torch.sum(w * a) / n
    b = b - torch.sum(w * b) / n
    denom = torch.sqrt(torch.sum(w * a**2) * torch.sum(w * b**2)) + 1e-8
    return 1.0 - torch.sum(w * a * b) / denom


def _loss_and_grad_out(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor, loss: str):
    """The loss of :func:`ncc_loss` or :func:`mse_loss` (weights ``w``) and
    ``d loss / d a`` in closed form, in ``a``'s dtype: with ``n =
    clamp_min(sum w, 1)``, mse ``2 w (a - b) / n``; ncc, with the centred
    sums S and ``D = sqrt(Saa Sbb) + 1e-8``, ``w (Sab Sbb (a - ma) /
    (D^2 sqrt(Saa Sbb)) - (b - mb) / D)``."""
    n = torch.clamp_min(torch.sum(w), 1.0)
    if loss == "mse":
        d = a - b
        return torch.sum(w * d * d) / n, 2.0 * w * d / n
    ac = a - torch.sum(w * a) / n
    bc = b - torch.sum(w * b) / n
    saa, sbb, sab = torch.sum(w * ac * ac), torch.sum(w * bc * bc), torch.sum(w * ac * bc)
    r = torch.sqrt(saa * sbb)
    d = r + 1e-8
    return 1.0 - sab / d, w * (sab * sbb / (d * d * r) * ac - bc / d)


def refine_objective_plain(moving: torch.Tensor, fixed: torch.Tensor, matrix, offset,
                           loss: str = "ncc", *, grad: bool = True,
                           dtype: torch.dtype = torch.float32):
    """The refine's objective and its gradient in plain PyTorch (any
    device): ``(value, d_matrix, d_offset)`` (the last two None without
    ``grad``), the loss of the warp of ``moving`` onto ``fixed``'s grid
    against ``fixed`` over the voxels whose support (the warp of ones)
    exceeds 0.999 (no gradient through the mask, as JAX's
    ``stop_gradient``). The warp and its autograd run in ``dtype``, the
    loss's sums and ``d loss / d warp`` in float64 (closed form, as the
    kernels form them), the value in ``dtype``."""
    shape = tuple(fixed.shape)
    m = _as_map(matrix, dtype, moving.device).detach().requires_grad_(grad)
    t = _as_map(offset, dtype, moving.device).detach().requires_grad_(grad)
    with torch.enable_grad() if grad else torch.no_grad():
        warped = affine_apply_plain(moving, m, t, shape, dtype=dtype)
    with torch.no_grad():
        support = affine_apply_plain(torch.ones_like(moving), m, t, shape, dtype=dtype)
        w = (support > 0.999).to(torch.float64)
        value, grad_out = _loss_and_grad_out(warped.detach().double(), fixed.double(), w, loss)
    if not grad:
        return value.to(dtype), None, None
    dm, dt = torch.autograd.grad(warped, (m, t), grad_out.to(dtype))
    return value.to(dtype), dm, dt


class RefineObjective(torch.autograd.Function):
    """A loss of the map whose forward also computes its gradient:
    ``RefineObjective.apply(matrix, offset, pair)`` returns ``value`` of
    ``pair(matrix, offset) -> (value, d_matrix, d_offset)``, and the
    backward hands back that gradient times the incoming one, so the
    parameters of the map (``tril``, the grid's scale) take it through
    autograd and Adam as before."""

    @staticmethod
    def forward(ctx, matrix, offset, pair):
        value, dm, dt = pair(matrix.detach(), offset.detach())
        ctx.save_for_backward(dm, dt)
        return value

    @staticmethod
    def backward(ctx, grad_value):
        dm, dt = ctx.saved_tensors
        return grad_value * dm, grad_value * dt, None


# ---------------------------------------------------------------------------
# Estimate: PCC seed + differentiable refinement
# ---------------------------------------------------------------------------


@dataclass
class RegistrationResult:
    matrix: np.ndarray  # (3, 3) ZYX inverse map
    offset: np.ndarray  # (3,)
    translation_seed: np.ndarray  # (3,) PCC estimate
    final_loss: float | None  # None when no refinement ran ('pcc' mode)


def _refine(fixed: torch.Tensor, moving: torch.Tensor, offset0: np.ndarray, iterations: int,
            loss_name: str, learning_rate: float, down: int, param: str = "triangular", *,
            plain: bool = False):
    """``_refine_jit``: Adam on the similarity of the warp over a y/x
    strided grid of ``fixed``. Returns (full-resolution matrix, offset,
    final loss, seed loss). A step on a CUDA tensor (unless ``plain``) is
    the two launches of :func:`refine_objective_cuda`, which make no
    tensor of the grid; else :func:`refine_objective_plain`."""
    fixed = fixed.to(torch.float32)
    moving = moving.to(torch.float32).contiguous()
    dev = fixed.device
    fixed_s = fixed[:, ::down, ::down].contiguous() if down > 1 else fixed.contiguous()
    if moving.is_cuda and not plain:
        from shrimpy_tpu_torch.ops.affine_cuda import refine_objective_cuda, refine_scratch

        partials = refine_scratch(moving, fixed_s.shape)

        def pair(m, t, grad=True):
            return refine_objective_cuda(moving, fixed_s, m, t, loss_name, partials, grad=grad)
    else:
        def pair(m, t, grad=True):
            return refine_objective_plain(moving, fixed_s, m, t, loss_name, grad=grad)
    # The strided grid maps back to full-resolution moving coordinates
    # through the scale; dm is in edge-pixel units (one unit moves the far
    # edge by one pixel), as in the JAX package.
    scale = torch.diag(torch.tensor([1.0, float(down), float(down)], dtype=torch.float32,
                                    device=dev))
    coord_scale = float(max(fixed.shape))

    def matrix_of(dm):
        return scale + (torch.tril(dm) if param == "triangular" else dm) / coord_scale

    def objective(dm, off):
        if not torch.is_grad_enabled():
            return pair(matrix_of(dm), off, grad=False)[0]
        return RefineObjective.apply(matrix_of(dm), off, pair)

    dm = torch.zeros((3, 3), dtype=torch.float32, device=dev, requires_grad=True)
    off = torch.tensor(np.asarray(offset0, np.float32), device=dev, requires_grad=True)
    with torch.no_grad():
        seed_loss = objective(dm, off)
    opt = torch.optim.Adam([dm, off], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        objective(dm, off).backward()
        opt.step()
    with torch.no_grad():
        final_loss = objective(dm, off)
        # Full-resolution inverse map: divide the y/x columns by down.
        col_scale = torch.tensor([1.0, 1.0 / down, 1.0 / down], dtype=torch.float32, device=dev)
        matrix_full = matrix_of(dm) * col_scale[None, :]
    return (matrix_full.cpu().numpy(), off.detach().cpu().numpy(), float(final_loss),
            float(seed_loss))


def estimate_registration(fixed, moving, settings=None, *, device=None,
                          plain: bool = False) -> RegistrationResult:
    """Estimate the affine map aligning ``moving`` onto ``fixed`` (ZYX):
    ``affine_apply(moving, matrix, offset)`` ~ ``fixed``.

    ``pcc``: translation only (DFT-upsampled seed, x20). ``pcc+refine``: a
    parabolic PCC seed, then the refine; when its final loss is not at or
    below the seed's (NaN included) the PCC translation is kept, with a
    warning. ``settings`` is read by attribute (a ``RegistrationSettings``
    or :func:`shrimpy_tpu_torch.config.registration_settings`). Inputs as in :func:`affine_apply`;
    ``plain`` runs the plain versions on any device (the reference path).
    """
    s = settings or registration_settings()
    fixed, moving = as_tensor(fixed, device), as_tensor(moving, device)
    if moving.device != fixed.device:
        moving = moving.to(fixed.device)
    if not fixed.dim() == moving.dim() == 3:
        raise ValueError(f"fixed and moving must be 3-D, got {fixed.dim()}-D and {moving.dim()}-D")
    shift = phase_cross_correlation(
        fixed, moving, maximum_shift=s.maximum_shift,
        upsample="parabolic" if s.method == "pcc+refine" else "dft", upsample_factor=20)
    # Positive shift: moving displaced positively, so the inverse map's
    # offset is +shift.
    offset0 = np.asarray(shift, np.float32)
    eye = np.eye(3, dtype=np.float32)
    if s.method == "pcc":
        return RegistrationResult(matrix=eye, offset=offset0, translation_seed=shift,
                                  final_loss=None)
    matrix, offset, final_loss, seed_loss = _refine(
        fixed, moving, offset0, s.refine_iterations, s.loss, s.learning_rate,
        s.downsample_yx, getattr(s, "parameterization", "triangular"), plain=plain)
    if not final_loss <= seed_loss:
        logging.getLogger(__name__).warning(
            "affine refinement diverged (loss %.4f > seed %.4f); "
            "keeping the PCC translation-only estimate", final_loss, seed_loss)
        return RegistrationResult(matrix=eye, offset=offset0, translation_seed=shift,
                                  final_loss=seed_loss)
    return RegistrationResult(matrix=matrix, offset=offset, translation_seed=shift,
                              final_loss=final_loss)


def affine_apply_reference_scipy(vol: np.ndarray, matrix: np.ndarray, offset: np.ndarray,
                                 output_shape=None) -> np.ndarray:
    """Trusted CPU oracle for :func:`affine_apply`."""
    from scipy import ndimage

    return ndimage.affine_transform(
        np.asarray(vol, dtype=np.float64), np.asarray(matrix, dtype=np.float64),
        offset=np.asarray(offset, dtype=np.float64), output_shape=output_shape or vol.shape,
        order=1, mode="grid-constant", cval=0.0,
    ).astype(np.float32)
