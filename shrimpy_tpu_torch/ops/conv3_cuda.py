"""Separable convolution of the ``linear_pallas`` and ``zy_pallas``
backends, and the all-axes circular ``conv3_circular`` (counterpart of
``shrimpy_tpu/ops/conv3_pallas.py``).

The JAX backends convolve each separable term with one Pallas kernel for
z and y (z taps on the VPU, then a banded-y MXU dot) and run x outside
it as a dense einsum: ``linear_pallas`` with zero boundaries
(``_convzy_linear_jit``, ``deconv.py::_toeplitz_banded``), ``zy_pallas``
circular (``_convzy_pallas_jit`` over per-call wrap pads,
``deconv.py::_circulant``). Here, for ``boundary`` ``"zero"`` or
``"circular"``:

* :func:`convzy_linear` / :func:`convzy_circular` is the z+y step:
  one launch of ``csrc/convzy.cu`` (:func:`convzy_linear_cuda`,
  :func:`convzy_circular_cuda`, the same kernel with wrapped slab loads)
  for a CUDA tensor, the plain version for a CPU tensor;
* the x axis is the dense product the JAX package computes
  (:func:`x_toeplitz_plain`, :func:`x_circulant_plain`) in the plain
  version, and the port's ``conv_x`` kernel on the card
  (``csrc/rl_fused.cu``, its row loaded at ``(x - r) mod gx`` when
  circular), which also sums the terms and applies the RL epilogue in
  its launch. The dense product costs ~2 TFLOP per term and
  convolution at the production carry, the banded one 21 FMAs a voxel;
* :func:`conv3_half_step` is one RL half-step of either route.

The TPU's layouts are not ported: the padded carry of ``linear_pallas``
(``lp_layout``, ``lp_pad``, ``lp_y_stencil``: 8-plane z pads, 128-row y
pads, x rounded to 128 lanes, so every DMA start is tile-aligned), the
wrap pads ``zy_pallas`` builds on every call, and its banded-y MXU
stencil ``_y_stencil``. A CUDA block masks or wraps its own edges, so
both routes keep the carry on the exact G grid, as the ``fused``
backend does, and share its pad/crop code.

:func:`conv3_circular` (kernel 5, ``_conv3_pallas_jit``: all three axes
as shifted FMAs over wrap-padded tiles) is off the RL path, as in JAX;
on the card each term runs :func:`convzy_circular_cuda` and then the
circular x pass.
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.ops.rl_fused import (
    _SMEM_BYTES,
    Stencil,
    _check_cuda_operand,
    _check_distinct,
    _conv_axis_circular_plain,
    _conv_axis_plain,
    _epilogue,
    check_io_cuda,
    run_terms_cuda,
)

# Tile constants of csrc/convzy.cu: kBz, kTx and the smaller of its two
# y tiles (kTy = 64 where that slab fits, else 32), and the grid bound of
# a launch.
_BZ, _TY, _TX = 8, 32, 32
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1
_HALF_MODES = ("ratio", "mult", "plain")


def convzy_linear_plain(v: torch.Tensor, kz, ky) -> torch.Tensor:
    """z taps, then y taps, zero outside the grid, in the convention
    ``out[n] = sum_i k[i] v[n + r - i]`` (any device, any float dtype)."""
    if v.is_cuda:
        convzy_linear_plain.cuda_calls += 1
    return _conv_axis_plain(_conv_axis_plain(v, np.asarray(kz, np.float64), 0),
                            np.asarray(ky, np.float64), 1)


# Calls of the plain version on a CUDA tensor since the last reset.
convzy_linear_plain.cuda_calls = 0


def convzy_circular_plain(v: torch.Tensor, kz, ky) -> torch.Tensor:
    """z taps, then y taps, circular: ``out[n] = sum_i k[i] v[(n + r -
    i) mod N]`` on each axis (any device, any float dtype; any radius)."""
    if v.is_cuda:
        convzy_circular_plain.cuda_calls += 1
    return _conv_axis_circular_plain(
        _conv_axis_circular_plain(v, np.asarray(kz, np.float64), 0),
        np.asarray(ky, np.float64), 1)


convzy_circular_plain.cuda_calls = 0


def convzy_smem_bytes(rz: int, ry: int) -> int:
    """Shared memory of one kTy = 32 ``convzy`` block: the input slab and
    the taps."""
    return ((_BZ + 2 * rz) * (_TY + 2 * ry) * _TX + 2 * (rz + ry + 1)) * 4


def _max_ry(rz: int) -> int:
    """The largest y radius whose kTy = 32 slab fits beside z radius
    ``rz`` (-1 when none does)."""
    ry = -1
    while convzy_smem_bytes(rz, ry + 1) <= _SMEM_BYTES:
        ry += 1
    return ry


def device_taps(taps, device) -> torch.Tensor:
    """A tap list as a float32 tensor on ``device``; a tensor passes as
    is. Numpy taps are copied: a reversed (adjoint) list has a negative
    stride, which ``torch.tensor`` refuses, and ``np.ascontiguousarray``
    keeps a one-tap reversed view as it is."""
    if isinstance(taps, torch.Tensor):
        return taps
    return torch.tensor(np.array(taps, np.float32), device=device)


def _convzy_cuda(v: torch.Tensor, kz, ky, out, entry: str, name: str) -> torch.Tensor:
    """Check the operands of a ``csrc/convzy.cu`` launch and launch
    ``entry`` (the zero-boundary or circular kernel)."""
    if v.dim() != 3:
        raise ValueError(f"{name} takes a 3-D carry, got {tuple(v.shape)}")
    shape = tuple(v.shape)
    gz, gy, gx = shape
    _check_cuda_operand("v", v, shape)
    kz, ky = (device_taps(t, v.device) for t in (kz, ky))
    for label, t in (("kz", kz), ("ky", ky)):
        if t.dtype != torch.float32 or t.device != v.device or t.dim() != 1 or t.numel() % 2 == 0:
            raise ValueError(f"{name}: {label} must be an odd-length float32 "
                             "tap list on the carry's device")
    rz, ry = kz.numel() // 2, ky.numel() // 2
    if convzy_smem_bytes(rz, ry) > _SMEM_BYTES:
        raise ValueError(
            f"{name}: radii (z {rz}, y {ry}) exceed the kernel's shared memory: the "
            f"kTy = {_TY} slab takes {convzy_smem_bytes(rz, ry)} bytes of {_SMEM_BYTES}; "
            f"at z radius {rz} the y radius bound is {_max_ry(rz)}")
    if max(gz * gy, gy * gx) > _MAX_INT or -(-gy // _TY) > _MAX_GRID_YZ \
            or -(-gz // _BZ) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: carry {shape} exceeds the launch grid")
    if out is None:
        out = torch.empty_like(v)
    _check_cuda_operand("out", out, shape)
    _check_distinct(v=v, out=out)

    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(getattr(load_library(), entry)(
        v.data_ptr(), out.data_ptr(), kz.data_ptr(), kz.numel(), ky.data_ptr(), ky.numel(),
        gz, gy, gx, torch.cuda.current_stream(v.device).cuda_stream,
    ), entry)
    return out


def convzy_linear_cuda(v: torch.Tensor, kz, ky, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """The zero-boundary z+y step with the kernel of ``csrc/convzy.cu``.

    ``v`` is a (gz, gy, gx) float32 CUDA tensor; ``kz``/``ky`` are tap
    lists (numpy, or float32 tensors on ``v``'s device); ``out`` must not
    alias ``v``. Raises on radii whose slab exceeds shared memory.
    """
    out = _convzy_cuda(v, kz, ky, out, "shrimpy_convzy_linear", "convzy_linear_cuda")
    convzy_linear_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets it).
convzy_linear_cuda.launches = 0


def convzy_circular_cuda(v: torch.Tensor, kz, ky, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """The circular z+y step (replaces ``conv3_pallas.py::
    _convzy_pallas_jit``) with the kernel of ``csrc/convzy.cu``: the
    zero-boundary kernel with its slab rows loaded at ``m mod N``, so
    radii past an axis (``r >= N``) wrap more than once. Operands as
    :func:`convzy_linear_cuda`; the same shared-memory bound on the
    radii applies, and the error names it (JAX's ``zy_pallas`` has
    none)."""
    out = _convzy_cuda(v, kz, ky, out, "shrimpy_convzy_circular", "convzy_circular_cuda")
    convzy_circular_cuda.launches += 1
    return out


convzy_circular_cuda.launches = 0


def convzy_linear(v: torch.Tensor, kz, ky, *, out=None) -> torch.Tensor:
    """z+y step: the kernel for a CUDA tensor, the plain version for a
    CPU tensor (``out`` is a kernel buffer, unused there)."""
    if v.is_cuda:
        return convzy_linear_cuda(v, kz, ky, out=out)
    return convzy_linear_plain(v, kz, ky)


def convzy_circular(v: torch.Tensor, kz, ky, *, flip: bool = False, out=None) -> torch.Tensor:
    """Circular z+y step (counterpart of ``convzy_circular_pallas``;
    ``flip`` reverses both tap lists, the adjoint): the kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    kz, ky = (np.asarray(t, np.float32) for t in (kz, ky))
    if flip:
        kz, ky = kz[::-1], ky[::-1]
    if v.is_cuda:
        return convzy_circular_cuda(v, kz, ky, out=out)
    return convzy_circular_plain(v, kz, ky)


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


def circulant(n: int, taps) -> np.ndarray:
    """n x n circulant of the centred circular convolution
    (``deconv.py::_circulant``, in float64): taps that wrap onto one
    column (more taps than ``n``) add up."""
    taps = np.asarray(taps, np.float64)
    r = len(taps) // 2
    mat = np.zeros((n, n), np.float64)
    rows = np.arange(n)
    for i, k in enumerate(taps):
        mat[rows, (rows - (i - r)) % n] += k
    return mat


def _x_dense(h: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """``einsum("ab,zyb->zya", mat, h)``."""
    return torch.matmul(h, torch.from_numpy(mat).to(h.device, h.dtype).T)


def x_toeplitz_plain(h: torch.Tensor, kx) -> torch.Tensor:
    """The zero-boundary x axis as the JAX package computes it: the dense
    product ``einsum("ab,zyb->zya", T, h)`` with ``T = toeplitz_banded(gx, kx)``."""
    return _x_dense(h, toeplitz_banded(h.shape[2], kx))


def x_circulant_plain(h: torch.Tensor, kx) -> torch.Tensor:
    """The circular x axis as ``_rl_sep_zy`` computes it: the dense
    product ``einsum("ab,zyb->zya", C, h)`` with ``C = circulant(gx, kx)``."""
    return _x_dense(h, circulant(h.shape[2], kx))


# Per boundary: the plain z+y step, the plain x axis, the z+y kernel and
# whether the x pass wraps.
_ROUTES = {
    "zero": (convzy_linear_plain, x_toeplitz_plain, convzy_linear_cuda, False),
    "circular": (convzy_circular_plain, x_circulant_plain, convzy_circular_cuda, True),
}


def _route(boundary: str, mode: str):
    if boundary not in _ROUTES:
        raise ValueError(f"boundary {boundary!r} not in {tuple(_ROUTES)}")
    if mode not in _HALF_MODES:
        raise ValueError(f"mode {mode!r} not in {_HALF_MODES}")
    return _ROUTES[boundary]


def conv3_half_step_plain(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                          boundary: str) -> torch.Tensor:
    """One RL half-step of the ``linear_pallas`` (``boundary="zero"``) or
    ``zy_pallas`` (``"circular"``) route in plain PyTorch: per term the
    plain z+y step then the dense x product, summed, then the epilogue
    of ``mode`` (``ratio``, ``mult`` or ``plain``)."""
    zy_plain, x_plain, _, _ = _route(boundary, mode)
    acc = None
    for wz, wy, wx in stencil.host:
        w = x_plain(zy_plain(inp, wz, wy), wx)
        acc = w if acc is None else acc.add_(w)
    return _epilogue(acc, aux, mode, eps)


def conv3_half_step_cuda(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                         boundary: str, out=None, scratch=None) -> torch.Tensor:
    """One RL half-step of either route with the kernels: per term the
    z+y kernel into scratch, then ``conv_x`` (wrapped when circular) adds
    the earlier terms' sum and applies the epilogue. ``out`` may be
    ``aux`` (the in-place mult update) but not ``inp``; ``scratch`` (1
    carry, 2 with more than one term) is allocated when not given."""
    _, _, zy_cuda, wrap = _route(boundary, mode)
    check_io_cuda(inp, aux, mode, "conv3_half_step_cuda")
    return run_terms_cuda(inp, aux, stencil, mode, eps,
                          lambda v, kz, ky, scratch: zy_cuda(v, kz, ky, out=scratch[0]),
                          1, out=out, scratch=scratch, wrap=wrap, name="conv3_half_step_cuda")


def conv3_half_step(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                    boundary: str, out=None, scratch=None) -> torch.Tensor:
    """RL half-step of either route: the kernels for a CUDA tensor, the
    plain version for a CPU tensor (``out``/``scratch`` unused there)."""
    if inp.is_cuda:
        return conv3_half_step_cuda(inp, aux, stencil, mode, eps, boundary=boundary,
                                    out=out, scratch=scratch)
    return conv3_half_step_plain(inp, aux, stencil, mode, eps, boundary=boundary)


def conv3_circular_plain(v: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """``sum_t`` of the circular z, y and x passes (any device, any float
    dtype)."""
    if v.is_cuda:
        conv3_circular_plain.cuda_calls += 1
    acc = None
    for wz, wy, wx in stencil.host:
        w = _conv_axis_circular_plain(v, wz, 0)
        w = _conv_axis_circular_plain(w, wy, 1)
        w = _conv_axis_circular_plain(w, wx, 2)
        acc = w if acc is None else acc.add_(w)
    return acc


conv3_circular_plain.cuda_calls = 0


def conv3_circular_cuda(v: torch.Tensor, stencil: Stencil, *, out=None, scratch=None) -> torch.Tensor:
    """Circular separable conv3 on the card (replaces ``conv3_pallas.py::
    _conv3_pallas_jit``): per term :func:`convzy_circular_cuda`, then the
    circular x pass in mode ``plain`` adding the earlier terms."""
    out = conv3_half_step_cuda(v, None, stencil, "plain", boundary="circular", out=out,
                               scratch=scratch)
    conv3_circular_cuda.launches += 1
    return out


conv3_circular_cuda.launches = 0


def conv3_circular(vol: torch.Tensor, terms, *, flip: bool = False) -> torch.Tensor:
    """Circular separable conv of ``vol`` by ``sum_k kz_k x ky_k x kx_k``
    (counterpart of ``conv3_circular_pallas``; ``flip=True`` applies the
    adjoint): the kernels for a CUDA tensor, the plain version for a CPU
    tensor. Terms must share per-axis odd tap lengths (``ValueError``
    otherwise, as in JAX)."""
    stencil = Stencil(terms, flip=flip, device=vol.device)
    if vol.is_cuda:
        return conv3_circular_cuda(vol, stencil)
    return conv3_circular_plain(vol, stencil)
