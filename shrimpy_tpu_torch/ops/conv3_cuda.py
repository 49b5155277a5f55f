"""Zero-boundary separable convolution of the ``linear_pallas`` backend
(counterpart of the linear half of ``shrimpy_tpu/ops/conv3_pallas.py``).

The JAX backend convolves each separable term with one Pallas kernel for
z and y (``_convzy_linear_jit``: z taps on the VPU, then a banded-y MXU
dot) and runs x outside it as a dense banded-Toeplitz einsum
(``deconv.py::_toeplitz_banded``). Here:

* :func:`convzy_linear` is the z+y step: :func:`convzy_linear_cuda`
  (``csrc/convzy_linear.cu``, one launch) for a CUDA tensor,
  :func:`convzy_linear_plain` for a CPU tensor;
* the x axis is :func:`x_toeplitz_plain` (the dense product, as the
  JAX package computes it) in the plain version, and the port's
  ``conv_x`` kernel on the card (``csrc/rl_fused.cu``): the same
  zero-boundary product, which also sums the terms and applies the RL
  epilogue in its launch. The dense product costs ~2 TFLOP per term and
  convolution at the production carry, the banded one 21 FMAs a voxel.

The TPU's padded-carry layout (``lp_layout``, ``lp_pad``,
``lp_y_stencil``: 8-plane z pads, 128-row y pads, x rounded to 128
lanes, so every DMA start is tile-aligned and the pads stay zero under
the multiplicative update) is not ported. A CUDA block masks its own
edges, so the port keeps the carry on the exact G grid, as its ``fused``
backend does, and both backends share the pad/crop code. The result is
the same zero-boundary convolution: the JAX pads hold zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.ops.rl_fused import (
    _SMEM_BYTES,
    Stencil,
    _check_cuda_operand,
    _check_distinct,
    _conv_axis_plain,
    _epilogue,
    check_io_cuda,
    run_terms_cuda,
)

# Tile constants of csrc/convzy_linear.cu: kBz, kTx and the smaller of
# its two y tiles (kTy = 64 where that slab fits, else 32), and the grid
# bound of a launch.
_BZ, _TY, _TX = 8, 32, 32
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1


def convzy_linear_plain(v: torch.Tensor, kz, ky) -> torch.Tensor:
    """z taps, then y taps, zero outside the grid, in the convention
    ``out[n] = sum_i k[i] v[n + r - i]`` (any device, any float dtype)."""
    if v.is_cuda:
        convzy_linear_plain.cuda_calls += 1
    return _conv_axis_plain(_conv_axis_plain(v, np.asarray(kz, np.float64), 0),
                            np.asarray(ky, np.float64), 1)


# Calls of the plain version on a CUDA tensor since the last reset.
convzy_linear_plain.cuda_calls = 0


def convzy_smem_bytes(rz: int, ry: int) -> int:
    """Shared memory of one kTy = 32 ``convzy_linear`` block: the input
    slab and the taps."""
    return ((_BZ + 2 * rz) * (_TY + 2 * ry) * _TX + 2 * (rz + ry + 1)) * 4


def convzy_linear_cuda(v: torch.Tensor, kz, ky, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """The z+y step with the kernel of ``csrc/convzy_linear.cu``.

    ``v`` is a (gz, gy, gx) float32 CUDA tensor; ``kz``/``ky`` are tap
    lists (numpy, or float32 tensors on ``v``'s device); ``out`` must not
    alias ``v``. Raises on radii whose slab exceeds shared memory.
    """
    if v.dim() != 3:
        raise ValueError(f"convzy_linear_cuda takes a 3-D carry, got {tuple(v.shape)}")
    shape = tuple(v.shape)
    gz, gy, gx = shape
    _check_cuda_operand("v", v, shape)
    kz, ky = (t if isinstance(t, torch.Tensor)
              else torch.tensor(np.asarray(t, np.float32), device=v.device) for t in (kz, ky))
    for name, t in (("kz", kz), ("ky", ky)):
        if t.dtype != torch.float32 or t.device != v.device or t.dim() != 1 or t.numel() % 2 == 0:
            raise ValueError(f"convzy_linear_cuda: {name} must be an odd-length float32 "
                             "tap list on the carry's device")
    rz, ry = kz.numel() // 2, ky.numel() // 2
    if convzy_smem_bytes(rz, ry) > _SMEM_BYTES:
        raise ValueError(f"convzy_linear_cuda: radii (z {rz}, y {ry}) exceed the kernel's "
                         "shared memory")
    if max(gz * gy, gy * gx) > _MAX_INT or -(-gy // _TY) > _MAX_GRID_YZ \
            or -(-gz // _BZ) > _MAX_GRID_YZ:
        raise ValueError(f"convzy_linear_cuda: carry {shape} exceeds the launch grid")
    if out is None:
        out = torch.empty_like(v)
    _check_cuda_operand("out", out, shape)
    _check_distinct(v=v, out=out)

    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_convzy_linear(
        v.data_ptr(), out.data_ptr(), kz.data_ptr(), kz.numel(), ky.data_ptr(), ky.numel(),
        gz, gy, gx, torch.cuda.current_stream(v.device).cuda_stream,
    ), "shrimpy_convzy_linear")
    convzy_linear_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets it).
convzy_linear_cuda.launches = 0


def convzy_linear(v: torch.Tensor, kz, ky, *, out=None) -> torch.Tensor:
    """z+y step: the kernel for a CUDA tensor, the plain version for a
    CPU tensor (``out`` is a kernel buffer, unused there)."""
    if v.is_cuda:
        return convzy_linear_cuda(v, kz, ky, out=out)
    return convzy_linear_plain(v, kz, ky)


def toeplitz_banded(n: int, taps) -> np.ndarray:
    """n x n banded Toeplitz of the centred zero-boundary convolution
    (``deconv.py::_toeplitz_banded``, in float64)."""
    taps = np.asarray(taps, np.float64)
    r = len(taps) // 2
    mat = np.zeros((n, n), np.float64)
    rows = np.arange(n)
    for i, k in enumerate(taps):
        cols = rows - (i - r)
        ok = (cols >= 0) & (cols < n)
        mat[rows[ok], cols[ok]] += k
    return mat


def x_toeplitz_plain(h: torch.Tensor, kx) -> torch.Tensor:
    """The x axis as the JAX package computes it: the dense product
    ``einsum("ab,zyb->zya", T, h)`` with ``T = toeplitz_banded(gx, kx)``."""
    t = torch.from_numpy(toeplitz_banded(h.shape[2], kx)).to(h.device, h.dtype)
    return torch.matmul(h, t.T)


def linear_half_step_plain(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6):
    """One RL half-step on the linear route in plain PyTorch: per term
    :func:`convzy_linear_plain` then :func:`x_toeplitz_plain`, summed,
    then the epilogue of ``mode`` (``ratio``, ``mult`` or ``plain``)."""
    if mode not in ("ratio", "mult", "plain"):
        raise ValueError(f"mode {mode!r} not in ('ratio', 'mult', 'plain')")
    acc = None
    for wz, wy, wx in stencil.host:
        w = x_toeplitz_plain(convzy_linear_plain(inp, wz, wy), wx)
        acc = w if acc is None else acc.add_(w)
    return _epilogue(acc, aux, mode, eps)


def linear_half_step_cuda(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                          out=None, scratch=None) -> torch.Tensor:
    """One RL half-step on the linear route with the kernels: per term
    :func:`convzy_linear_cuda` into scratch, then ``conv_x`` adds the
    earlier terms' sum and applies the epilogue. ``out`` may be ``aux``
    (the in-place mult update) but not ``inp``; ``scratch`` (1 carry, 2
    with more than one term) is allocated when not given."""
    if mode not in ("ratio", "mult", "plain"):
        raise ValueError(f"mode {mode!r} not in ('ratio', 'mult', 'plain')")
    check_io_cuda(inp, aux, mode, "linear_half_step_cuda")
    return run_terms_cuda(inp, aux, stencil, mode, eps,
                          lambda v, kz, ky, scratch: convzy_linear_cuda(v, kz, ky, out=scratch[0]),
                          1, out=out, scratch=scratch, name="linear_half_step_cuda")


def linear_half_step(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                     out=None, scratch=None) -> torch.Tensor:
    """Linear-route RL half-step: the kernels for a CUDA tensor, the
    plain version for a CPU tensor (``out``/``scratch`` unused there)."""
    if inp.is_cuda:
        return linear_half_step_cuda(inp, aux, stencil, mode, eps, out=out, scratch=scratch)
    return linear_half_step_plain(inp, aux, stencil, mode, eps)

