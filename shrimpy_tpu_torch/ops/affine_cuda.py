"""The affine warp and the refine's objective on the card: wrappers of
``csrc/affine.cu``.

No TPU kernel: the JAX package computes the warp in XLA
(``shrimpy_tpu/ops/register.py::affine_apply`` :472, four tiers that
avoid gathers on the TPU) and the refine's gradient with ``jax.grad``
through it inside ``_refine_jit`` (:609). Here one kernel computes the
warp for every matrix (:func:`affine_warp_cuda`; its plain version is
:func:`shrimpy_tpu_torch.ops.register.affine_apply_plain`), and a refine
step is two launches that materialise nothing of the refine grid
(:func:`refine_objective_cuda`): the loss's weighted sums
(:func:`refine_sums_cuda`), then its gradient with respect to the map
(:func:`refine_grad_cuda`), which forms ``d loss / d warp`` per voxel
from those sums; see the note in ``csrc/affine.cu``. Their plain
version is :func:`shrimpy_tpu_torch.ops.register.refine_objective_plain`.

The map reaches the kernels as 12 float64 on the device (``M``
row-major, then ``t``; :func:`map_params`), so a map the refine holds on
the card is read without a host sync.
"""

from __future__ import annotations

import torch

# Entries of map_params / the gradient: M row-major (9), then t (3).
N_PARAMS = 12


def map_params(matrix: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``matrix`` (3, 3) and ``offset`` (3,) as the kernels' 12 float64."""
    return torch.cat([matrix.reshape(9), offset.reshape(3)]).to(torch.float64).contiguous()


def _check_vol(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 3-D float32 CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")


def _check_params(params: torch.Tensor, dev) -> None:
    if (params.device != dev or params.dtype != torch.float64 or params.shape != (N_PARAMS,)
            or not params.is_contiguous()):
        raise ValueError(f"params must be {N_PARAMS} contiguous float64 on {dev}, got "
                         f"{params.dtype} {tuple(params.shape)} on {params.device}")


def affine_warp_cuda(vol: torch.Tensor, params: torch.Tensor, output_shape) -> torch.Tensor:
    """``out[u] = trilinear(vol)(M u + t)``, zero outside, on the card.

    ``vol`` is a contiguous float32 CUDA (Z, Y, X) tensor, ``params``
    :func:`map_params` on its device. Launches on the current stream;
    raises on a wrong input or a launch error.
    """
    _check_vol("affine_warp_cuda", vol)
    _check_params(params, vol.device)
    from shrimpy_tpu_torch.kernels.build import check, load_library

    shape = tuple(int(s) for s in output_shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"output_shape must be 3 positive extents, got {output_shape}")
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    code = load_library().shrimpy_affine_warp(
        vol.data_ptr(), out.data_ptr(), params.data_ptr(), *vol.shape, *shape,
        torch.cuda.current_stream(vol.device).cuda_stream)
    check(code, "shrimpy_affine_warp")
    affine_warp_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets them).
affine_warp_cuda.launches = 0


# Entries of refine_sums_cuda's stats: the loss, the coefficients alpha,
# beta, ma, mb of d loss / d warp = w (alpha (a - ma) + beta (b - mb)), and
# sum w (csrc/affine.cu::kStats).
N_STATS = 6
LOSSES = ("ncc", "mse")


def refine_scratch(vol: torch.Tensor, grid_shape) -> torch.Tensor:
    """The float64 scratch of the refine's launches for ``vol`` and a
    refine grid of ``grid_shape``: one row of 12 a block, the most of
    any of its kernels (made once an estimate, not a step)."""
    from shrimpy_tpu_torch.kernels.build import check, load_library

    blocks = load_library().shrimpy_affine_refine_blocks(*vol.shape, *tuple(grid_shape)[:2])
    if blocks < 1:
        check(-blocks, "shrimpy_affine_refine_blocks")
    return torch.empty((blocks, N_PARAMS), dtype=torch.float64, device=vol.device)


def _check_refine(vol, fixed, params, partials) -> None:
    _check_vol("refine: moving", vol)
    _check_vol("refine: fixed", fixed)
    _check_params(params, vol.device)
    if (partials.device != vol.device or partials.dtype != torch.float64 or partials.dim() != 2
            or partials.shape[1] != N_PARAMS or not partials.is_contiguous()):
        raise ValueError("partials must be refine_scratch(vol, fixed.shape)")


def refine_sums_cuda(vol: torch.Tensor, fixed: torch.Tensor, params: torch.Tensor, loss: str,
                     partials: torch.Tensor):
    """The sums launch and its finish: ``(value, stats)``, the loss
    (``register.py::ncc_loss`` or ``mse_loss``) of the warp of ``vol`` by
    ``params`` onto ``fixed``'s grid against ``fixed``, over the voxels
    whose support exceeds 0.999, as a 0-d float32 CUDA tensor, and
    ``stats`` (:data:`N_STATS` float64). Sums in float64, in block order:
    the same bits on every run. Raises on a wrong input or a launch
    error."""
    _check_refine(vol, fixed, params, partials)
    if loss not in LOSSES:
        raise ValueError(f"loss {loss!r} not in {LOSSES}")
    from shrimpy_tpu_torch.kernels.build import check, load_library

    stats = torch.empty(N_STATS, dtype=torch.float64, device=vol.device)
    value = torch.empty((), dtype=torch.float32, device=vol.device)
    check(load_library().shrimpy_affine_refine_sums(
        vol.data_ptr(), fixed.data_ptr(), params.data_ptr(), partials.data_ptr(),
        partials.shape[0], stats.data_ptr(), value.data_ptr(), *vol.shape, *fixed.shape,
        LOSSES.index(loss), torch.cuda.current_stream(vol.device).cuda_stream,
    ), "shrimpy_affine_refine_sums")
    refine_sums_cuda.launches += 1
    return value, stats


def refine_grad_cuda(vol: torch.Tensor, fixed: torch.Tensor, params: torch.Tensor,
                     stats: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """The gradient launch and its finish: ``d loss / d (M, t)`` as 12
    float64 (``M`` row-major, then ``t``) for the ``stats`` that
    :func:`refine_sums_cuda` gave with the same operands; the same bits on
    every run (no atomics)."""
    _check_refine(vol, fixed, params, partials)
    if stats.device != vol.device or stats.dtype != torch.float64 or stats.shape != (N_STATS,):
        raise ValueError(f"stats must be the {N_STATS} float64 of refine_sums_cuda")
    from shrimpy_tpu_torch.kernels.build import check, load_library

    grad = torch.empty(N_PARAMS, dtype=torch.float64, device=vol.device)
    check(load_library().shrimpy_affine_refine_grad(
        vol.data_ptr(), fixed.data_ptr(), params.data_ptr(), stats.data_ptr(),
        partials.data_ptr(), partials.shape[0], grad.data_ptr(), *vol.shape, *fixed.shape,
        torch.cuda.current_stream(vol.device).cuda_stream,
    ), "shrimpy_affine_refine_grad")
    refine_grad_cuda.launches += 1
    return grad


# Launches of the refine's two kernels since the last reset, counted where
# each is launched (its finish rides with it).
refine_sums_cuda.launches = 0
refine_grad_cuda.launches = 0


def refine_objective_cuda(moving: torch.Tensor, fixed: torch.Tensor, matrix: torch.Tensor,
                          offset: torch.Tensor, loss: str, partials: torch.Tensor, *,
                          grad: bool = True):
    """The refine's objective on the card: ``(value, d_matrix, d_offset)``
    in ``matrix``'s and ``offset``'s dtypes (the last two None without
    ``grad``), the sums launch and, with ``grad``, the gradient launch.
    ``partials`` is :func:`refine_scratch` of ``moving`` and ``fixed``'s
    shape."""
    params = map_params(matrix, offset)
    value, stats = refine_sums_cuda(moving, fixed, params, loss, partials)
    if not grad:
        return value, None, None
    g = refine_grad_cuda(moving, fixed, params, stats, partials)
    return value, g[:9].reshape(3, 3).to(matrix.dtype), g[9:].to(offset.dtype)
