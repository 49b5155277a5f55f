"""The affine warp on the card: wrappers of ``csrc/affine.cu`` and the
autograd function the refine differentiates.

No TPU kernel: the JAX package computes the warp in XLA
(``shrimpy_tpu/ops/register.py::affine_apply`` :472, four tiers that
avoid gathers on the TPU) and its gradient with ``jax.grad`` inside
``_refine_jit`` (:609). Here one kernel computes the warp for every
matrix (:func:`affine_warp_cuda`), and one its gradient with respect to
the map (:func:`affine_warp_grad_cuda`); see the note in
``csrc/affine.cu``. Their plain version is
:func:`shrimpy_tpu_torch.ops.register.affine_apply_plain`, which torch
autograd differentiates.

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


def affine_warp_cuda(vol: torch.Tensor, params: torch.Tensor, output_shape, *,
                     support: bool = False):
    """``out[u] = trilinear(vol)(M u + t)``, zero outside, on the card.

    ``vol`` is a contiguous float32 CUDA (Z, Y, X) tensor, ``params``
    :func:`map_params` on its device. With ``support`` also returns the
    warp of a volume of ones, ``(out, support)``. Launches on the current
    stream; raises on a wrong input or a launch error.
    """
    _check_vol("affine_warp_cuda", vol)
    _check_params(params, vol.device)
    from shrimpy_tpu_torch.kernels.build import check, load_library

    shape = tuple(int(s) for s in output_shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"output_shape must be 3 positive extents, got {output_shape}")
    out = torch.empty(shape, dtype=torch.float32, device=vol.device)
    sup = torch.empty_like(out) if support else None
    code = load_library().shrimpy_affine_warp(
        vol.data_ptr(), out.data_ptr(), None if sup is None else sup.data_ptr(),
        params.data_ptr(), *vol.shape, *shape,
        torch.cuda.current_stream(vol.device).cuda_stream)
    check(code, "shrimpy_affine_warp")
    affine_warp_cuda.launches += 1
    return (out, sup) if support else out


def affine_warp_grad_cuda(vol: torch.Tensor, grad_out: torch.Tensor,
                          params: torch.Tensor) -> torch.Tensor:
    """``d loss / d (M, t)`` as 12 float64 (``M`` row-major, then ``t``)
    from ``grad_out = d loss / d out`` of :func:`affine_warp_cuda`, on the
    card; the same bits on every run (no atomics)."""
    _check_vol("affine_warp_grad_cuda", vol)
    _check_vol("affine_warp_grad_cuda grad_out", grad_out)
    _check_params(params, vol.device)
    from shrimpy_tpu_torch.kernels.build import check, load_library

    lib = load_library()
    blocks = lib.shrimpy_affine_grad_blocks(*vol.shape, *grad_out.shape[:2])
    if blocks < 1:
        check(-blocks, "shrimpy_affine_grad_blocks")
    partials = torch.empty((blocks, N_PARAMS), dtype=torch.float64, device=vol.device)
    grad = torch.empty(N_PARAMS, dtype=torch.float64, device=vol.device)
    code = lib.shrimpy_affine_warp_grad(
        vol.data_ptr(), grad_out.data_ptr(), params.data_ptr(), partials.data_ptr(),
        grad.data_ptr(), *vol.shape, *grad_out.shape,
        torch.cuda.current_stream(vol.device).cuda_stream)
    check(code, "shrimpy_affine_warp_grad")
    affine_warp_grad_cuda.launches += 1
    return grad


# Kernel launches since the last reset (chip_smoke.py reads and resets them).
affine_warp_cuda.launches = 0
affine_warp_grad_cuda.launches = 0


class AffineWarp(torch.autograd.Function):
    """The warp with the map as the differentiable input, on the card:
    forward :func:`affine_warp_cuda`, backward :func:`affine_warp_grad_cuda`.

    ``AffineWarp.apply(vol, matrix, offset, output_shape, support)``
    returns the warp, or ``(warp, support)`` (the warp of ones, not
    differentiable). ``vol`` gets no gradient: it raises if it asks for
    one. On a CPU tensor use the plain version, which torch autograd
    differentiates.
    """

    @staticmethod
    def forward(ctx, vol, matrix, offset, output_shape, support=False):
        if vol.requires_grad:
            raise ValueError("AffineWarp differentiates the map only: vol must not require "
                             "a gradient")
        params = map_params(matrix, offset)
        res = affine_warp_cuda(vol, params, output_shape, support=support)
        ctx.save_for_backward(vol, params)
        ctx.dtypes = (matrix.dtype, offset.dtype)
        if support:
            ctx.mark_non_differentiable(res[1])
        return res

    @staticmethod
    def backward(ctx, grad_out, *_):
        vol, params = ctx.saved_tensors
        grad = affine_warp_grad_cuda(vol, grad_out.to(torch.float32).contiguous(), params)
        return (None, grad[:9].reshape(3, 3).to(ctx.dtypes[0]), grad[9:].to(ctx.dtypes[1]),
                None, None)
