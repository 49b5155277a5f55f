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

* :func:`convzy_linear` / :func:`convzy_circular` is the z+y step: on a
  CUDA tensor the route :func:`convzy_route` picks from the shapes alone,
  ``"march"`` (:func:`convzy_march`, one launch of ``csrc/convzy.cu``,
  compiled for the tap lengths, the tile and the boundary, that marches
  through z with a ring of input slabs in shared memory) where its block
  fits (:func:`convzy_layout`), else ``"two_pass"``
  (:func:`convzy_two_pass`, a z pass and a y pass of
  ``rl_fused.py::conv_axis_cuda``: ``csrc/rl_pass.cu`` compiled for the
  tap count up to 63 taps, else ``csrc/rl_fused.cu``'s ``conv_axis``,
  circular when the boundary is). Both give the plain version's bits; a
  CPU tensor runs the plain version;
* the x axis is the dense product the JAX package computes
  (:func:`x_toeplitz_plain`, :func:`x_circulant_plain`) in the plain
  version, and the port's x pass on the card (``rl_fused.py::conv_x_cuda``:
  ``csrc/rl_pass.cu`` or ``csrc/rl_fused.cu``, its row loaded at
  ``(x - r) mod gx`` when circular), which also sums the terms and applies
  the RL epilogue in its launch. The dense product costs ~2 TFLOP per term and
  convolution at the production carry, the banded one 21 FMAs a voxel;
* :func:`conv3_half_step` is one RL half-step of either backend.

Between them the routes take every z and y radius, as JAX's
``zy_pallas`` does (and all that its ``linear_pallas`` takes, ``rz <= 8``,
``ry <= 125``: ``lp_layout``): where the two-pass route's column of
``32 + 2 r`` rows outgrows a block's shared memory (radii past 211),
``conv_axis`` takes the taps in chunks, each going on from the partial
sums the chunk before wrote. The TPU's layouts are not
ported: the padded carry of ``linear_pallas`` (``lp_layout``,
``lp_pad``, ``lp_y_stencil``: 8-plane z pads, 128-row y pads, x rounded
to 128 lanes, so every DMA start is tile-aligned), the wrap pads
``zy_pallas`` builds on every call, and its banded-y MXU stencil
``_y_stencil``. A CUDA block fills or wraps its own edges, so both
routes keep the carry on the exact G grid, as the ``fused`` backend
does, and share its pad/crop code.

:func:`conv3_circular` (kernel 5, ``_conv3_pallas_jit``: all three axes
and every term as shifted FMAs over wrap-padded tiles, one call) is off
the RL path, as in JAX. On the card it is one launch of
``csrc/rl_half.cu``'s circular build (``RL_HALF_WRAP=1``, mode
``plain``: :func:`conv3_one_launch`) where that kernel's block fits, else
each term's circular z+y step and then the circular x pass
(:func:`conv3_half_step_cuda` in mode ``plain``);
:func:`conv3_circular_route` chooses from the
shapes alone, and both routes give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from shrimpy_tpu_torch.ops.rl_fused import (
    _MAX_GRID_YZ,
    _MAX_INT,
    _SMEM_BYTES,
    Stencil,
    _check_cuda_operand,
    _check_distinct,
    _check_stencil,
    _conv_axis_circular_plain,
    _conv_axis_plain,
    _epilogue,
    _round4,
    check_io_cuda,
    conv_axis_cuda,
    half_layout,
    host_taps,
    run_terms_cuda,
    window_taps,
)
from shrimpy_tpu_torch.utils.shapes import round_up

_HALF_MODES = ("ratio", "mult", "plain")
BOUNDARIES = ("zero", "circular")
ROUTES = ("march", "two_pass")
# (ty, tx) tiles of csrc/convzy.cu in order of preference: the first that
# fits runs (PERF.md has their times at the production carry). The kernel
# is compiled for the tap lengths, the tile and the boundary.
CONVZY_TILES = ((64, 32), (32, 64), (32, 32), (16, 32), (8, 32))
# A block of csrc/convzy.cu: its threads (one 4-row piece of the y pass
# each at most), the rows and columns of a TMA box, the rows of zeros
# before the z pass's plane, the planes in flight.
_ZY_THREADS = 512
_ZY_BOX = 256
_ZY_GUARD_ROWS = 4
_ZY_DEPTH = 3


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


def convzy_smem_bytes(tile, radii) -> int:
    """Dynamic shared memory of one ``csrc/convzy.cu`` block on a (ty,
    tx) ``tile`` with z and y ``radii``: the taps (``kz`` to a multiple of
    4, the ``ky`` window), the ring of ``2 rz + 1 + 3`` input slabs of
    (ty + 2 ry) x tx floats (three in flight), two z-pass planes after
    their guard rows, each region a multiple of 128 bytes, and an
    mbarrier a slot. The kernel's own sum is ``shrimpy_convzy_smem``."""
    (ty, tx), (rz, ry) = tile, radii
    slab, slots = (ty + 2 * ry) * tx, 2 * rz + 1 + _ZY_DEPTH
    taps = round_up(_round4(2 * rz + 1) + window_taps(2 * ry + 1), 32)
    floats = (taps + slots * round_up(slab, 32)
              + 2 * round_up(_ZY_GUARD_ROWS * tx + slab, 32) + _round4(2 * slots))
    return 4 * floats


def convzy_layout(shape, radii, *, tile=None) -> dict | None:
    """The tile the march kernel runs a (gz, gy, gx) carry with, for z
    and y ``radii``: ``{"tile": (ty, tx), "threads": n, "smem_bytes": n,
    "blocks": n}``, or None when none of :data:`CONVZY_TILES` fits (the
    ring's shared memory, a TMA box of 256 x 256, a thread's 4-row piece
    of the y pass, the launch grid). ``tile`` forces one."""
    gz, gy, gx = shape
    rz, ry = radii
    if gy * gx > _MAX_INT:
        return None
    for cand in ((tuple(tile),) if tile is not None else CONVZY_TILES):
        ty, tx = cand
        smem = convzy_smem_bytes(cand, radii)
        if (ty % 4 == 0 and tx % 4 == 0 and (ty // 4) * tx <= _ZY_THREADS
                and ty + 2 * ry <= _ZY_BOX and tx <= _ZY_BOX and smem <= _SMEM_BYTES
                and -(-gy // ty) <= _MAX_GRID_YZ):
            return {"tile": cand, "threads": _ZY_THREADS, "smem_bytes": smem,
                    "blocks": -(-gy // ty) * -(-gx // tx)}
    return None


def _check_boundary(boundary: str) -> None:
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary {boundary!r} not in {BOUNDARIES}")


def convzy_route(shape, radii, boundary: str = "zero") -> str:
    """Which kernels run the z+y step of a (gz, gy, gx) carry with z and
    y ``radii``: ``"march"`` (``csrc/convzy.cu``) where its block fits,
    else ``"two_pass"`` (two ``conv_axis`` launches). Both give the same
    bits and take every radius; the choice reads the shapes and nothing
    else, so it is the same on every device."""
    _check_boundary(boundary)
    return ROUTES[0] if convzy_layout(shape, radii) is not None else ROUTES[1]


def device_taps(taps, device) -> torch.Tensor:
    """A tap list as a float32 tensor on ``device``; a tensor passes as
    is. Numpy taps are copied: a reversed (adjoint) list has a negative
    stride, which ``torch.tensor`` refuses, and ``np.ascontiguousarray``
    keeps a one-tap reversed view as it is."""
    if isinstance(taps, torch.Tensor):
        return taps
    return torch.tensor(np.array(taps, np.float32), device=device)


def zy_taps(kz: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    """The taps as the march kernel reads them: ``kz`` with zeros to a
    multiple of 4, then the ``ky`` window (3 zeros, ``ky``, zeros), the
    first part of a row of :meth:`Stencil.packed`."""
    nkz, nky = kz.numel(), ky.numel()
    zeros = kz.new_zeros(_round4(nkz) + window_taps(nky) - nkz - nky)
    lead = _round4(nkz) - nkz
    return torch.cat([kz, zeros[:lead + 3], ky, zeros[lead + 3:]])


def convzy_march(v: torch.Tensor, taps: torch.Tensor, nkz: int, nky: int, *, boundary: str,
                 out: torch.Tensor, tile=None) -> torch.Tensor:
    """The z+y step as one launch of ``csrc/convzy.cu``, compiled for the
    tap lengths, the tile and the boundary at the first call with them
    (``kernels/build.py::load_geometry_library``). ``taps`` is
    :func:`zy_taps` (or a row of ``Stencil.packed``) on ``v``'s device;
    operands are checked by the caller. ``tile`` takes a (ty, tx) other
    than :func:`convzy_layout`'s choice. Raises :class:`ValueError` where
    the block does not fit."""
    shape = tuple(v.shape)
    layout = convzy_layout(shape, (nkz // 2, nky // 2), tile=tile)
    if layout is None:
        raise ValueError(f"convzy_march: tap lengths ({nkz}, {nky}) on {shape} fit no tile "
                         f"{'of ' + str(CONVZY_TILES) if tile is None else tuple(tile)}")

    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = shape
    geometry = (nkz, nky, *layout["tile"], int(boundary == "circular"))
    vec = gx % 4 == 0 and v.data_ptr() % 16 == 0
    check(load_geometry_library("convzy", geometry).shrimpy_convzy(
        v.data_ptr(), out.data_ptr(), taps.data_ptr(), nkz, nky, gz, gy, gx, *geometry[2:],
        int(vec), None, torch.cuda.current_stream(v.device).cuda_stream,
    ), "shrimpy_convzy")
    convzy_march.launches += 1
    return out


def convzy_two_pass(v: torch.Tensor, kz: torch.Tensor, ky: torch.Tensor, *, boundary: str,
                    out: torch.Tensor, tmp: torch.Tensor | None = None,
                    host=None) -> torch.Tensor:
    """The z+y step as two passes of ``rl_fused.py::conv_axis_cuda``
    (``csrc/rl_pass.cu`` compiled for the tap count, or past 63 taps
    ``csrc/rl_fused.cu``'s ``conv_axis``), a z pass into ``tmp`` (a carry,
    allocated when not given) and a y pass into ``out``, circular when
    ``boundary`` is: the route past the march kernel's block. ``host``:
    the (kz, ky) float32 host copies (made here when None). Operands are
    checked by the caller."""
    gz, gy, gx = v.shape
    if tmp is None:
        tmp = torch.empty_like(v)
    _check_cuda_operand("tmp", tmp, tuple(v.shape))
    _check_distinct(v=v, out=out, tmp=tmp)
    hz, hy = host if host is not None else (host_taps(kz), host_taps(ky))
    wrap = boundary == "circular"
    conv_axis_cuda(v, tmp, kz, hz, 1, gz, gy * gx, wrap=wrap)
    convzy_two_pass.launches += 1
    conv_axis_cuda(tmp, out, ky, hy, gz, gy, gx, wrap=wrap)
    convzy_two_pass.launches += 1
    return out


# Kernel launches of each route since the last reset, counted where they are
# launched: one a step on the march, two on the two-pass route.
convzy_march.launches = 0
convzy_two_pass.launches = 0


def _convzy_cuda(v: torch.Tensor, kz, ky, out, boundary: str, name: str, taps=None, host=None):
    """Check the operands of a z+y step on the card and run it on the
    route of :func:`convzy_route` (``host``: the float32 host copies of
    the tap lists, for the two-pass route)."""
    if v.dim() != 3:
        raise ValueError(f"{name} takes a 3-D carry, got {tuple(v.shape)}")
    shape = tuple(v.shape)
    _check_cuda_operand("v", v, shape)
    if host is None and not any(isinstance(t, torch.Tensor) for t in (kz, ky)):
        host = (host_taps(kz), host_taps(ky))
    kz, ky = (device_taps(t, v.device) for t in (kz, ky))
    for label, t in (("kz", kz), ("ky", ky)):
        if t.dtype != torch.float32 or t.device != v.device or t.dim() != 1 or t.numel() % 2 == 0:
            raise ValueError(f"{name}: {label} must be an odd-length float32 "
                             "tap list on the carry's device")
    radii = (kz.numel() // 2, ky.numel() // 2)
    route = convzy_route(shape, radii, boundary)
    if out is None:
        out = torch.empty_like(v)
    _check_cuda_operand("out", out, shape)
    _check_distinct(v=v, out=out)
    if route == ROUTES[1]:
        return convzy_two_pass(v, kz, ky, boundary=boundary, out=out, host=host)
    if taps is None:
        taps = zy_taps(kz, ky)
    if not taps.is_cuda or taps.dtype != torch.float32 or taps.device != v.device \
            or taps.numel() < _round4(kz.numel()) + window_taps(ky.numel()):
        raise ValueError(f"{name}: taps must be the packed float32 taps on the carry's device")
    return convzy_march(v, taps, kz.numel(), ky.numel(), boundary=boundary, out=out)


def convzy_linear_cuda(v: torch.Tensor, kz, ky, *, out: torch.Tensor | None = None,
                       taps: torch.Tensor | None = None, host=None) -> torch.Tensor:
    """The zero-boundary z+y step on the card (replaces ``conv3_pallas.py::
    _convzy_linear_jit``), on the route of :func:`convzy_route`.

    ``v`` is a (gz, gy, gx) float32 CUDA tensor; ``kz``/``ky`` are tap
    lists (numpy, or float32 tensors on ``v``'s device); ``out`` must not
    alias ``v``; ``taps`` (the march kernel's layout, :func:`zy_taps`) is
    packed here when not given; ``host`` (the float32 host copies of
    ``kz`` and ``ky``, for the two-pass route) is made here when not
    given. Every radius runs.
    """
    out = _convzy_cuda(v, kz, ky, out, "zero", "convzy_linear_cuda", taps, host)
    convzy_linear_cuda.launches += 1
    return out


# z+y steps since the last reset, on either route (chip_smoke.py reads and
# resets it).
convzy_linear_cuda.launches = 0


def convzy_circular_cuda(v: torch.Tensor, kz, ky, *, out: torch.Tensor | None = None,
                         taps: torch.Tensor | None = None, host=None) -> torch.Tensor:
    """The circular z+y step on the card (replaces ``conv3_pallas.py::
    _convzy_pallas_jit``): the zero-boundary step's routes with rows and
    planes taken at ``m mod N``, so radii past an axis (``r >= N``) wrap
    more than once. Operands as :func:`convzy_linear_cuda`; every radius
    runs, as in JAX's ``zy_pallas``."""
    out = _convzy_cuda(v, kz, ky, out, "circular", "convzy_circular_cuda", taps, host)
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


def _band_matrix(n: int, taps, wrap: bool, device) -> torch.Tensor:
    """n x n float64 matrix of the centred convolution by ``taps``, built on
    ``device`` tap after tap: circular (``wrap``) or zero-boundary."""
    taps = np.asarray(taps, np.float64)
    r = len(taps) // 2
    mat = torch.zeros((n, n), dtype=torch.float64, device=device)
    rows = torch.arange(n, device=device)
    for i, k in enumerate(taps):
        cols = rows - (i - r)
        if wrap:
            mat[rows, cols % n] += float(k)
        else:
            ok = (cols >= 0) & (cols < n)
            mat[rows[ok], cols[ok]] += float(k)
    return mat


def toeplitz_banded(n: int, taps, device=None) -> np.ndarray | torch.Tensor:
    """n x n banded Toeplitz of the centred zero-boundary convolution
    (``deconv.py::_toeplitz_banded``, in float64): a numpy array, or with
    ``device`` a tensor built there (a long row's matrix, 28.8 GB at 60,020
    columns, is then never made on the host)."""
    mat = _band_matrix(n, taps, False, device or "cpu")
    return mat if device is not None else mat.numpy()


def circulant(n: int, taps, device=None) -> np.ndarray | torch.Tensor:
    """n x n circulant of the centred circular convolution
    (``deconv.py::_circulant``, in float64): taps that wrap onto one
    column (more taps than ``n``) add up. A numpy array, or with ``device``
    a tensor built there."""
    mat = _band_matrix(n, taps, True, device or "cpu")
    return mat if device is not None else mat.numpy()


def x_toeplitz_plain(h: torch.Tensor, kx) -> torch.Tensor:
    """The zero-boundary x axis as the JAX package computes it: the dense
    product ``einsum("ab,zyb->zya", T, h)`` with ``T = toeplitz_banded(gx, kx)``."""
    return torch.matmul(h, toeplitz_banded(h.shape[2], kx, h.device).to(h.dtype).T)


def x_circulant_plain(h: torch.Tensor, kx) -> torch.Tensor:
    """The circular x axis as ``_rl_sep_zy`` computes it: the dense
    product ``einsum("ab,zyb->zya", C, h)`` with ``C = circulant(gx, kx)``."""
    return torch.matmul(h, circulant(h.shape[2], kx, h.device).to(h.dtype).T)


# Per boundary: the plain z+y step, the plain x axis, the z+y step on the
# card and whether the x pass wraps.
_BOUNDARY_OPS = {
    "zero": (convzy_linear_plain, x_toeplitz_plain, convzy_linear_cuda, False),
    "circular": (convzy_circular_plain, x_circulant_plain, convzy_circular_cuda, True),
}


def _ops_of(boundary: str, mode: str):
    _check_boundary(boundary)
    if mode not in _HALF_MODES:
        raise ValueError(f"mode {mode!r} not in {_HALF_MODES}")
    return _BOUNDARY_OPS[boundary]


def conv3_half_step_plain(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                          boundary: str) -> torch.Tensor:
    """One RL half-step of the ``linear_pallas`` (``boundary="zero"``) or
    ``zy_pallas`` (``"circular"``) route in plain PyTorch: per term the
    plain z+y step then the dense x product, summed, then the epilogue
    of ``mode`` (``ratio``, ``mult`` or ``plain``)."""
    zy_plain, x_plain, _, _ = _ops_of(boundary, mode)
    acc = None
    for wz, wy, wx in stencil.host:
        w = x_plain(zy_plain(inp, wz, wy), wx)
        acc = w if acc is None else acc.add_(w)
    return _epilogue(acc, aux, mode, eps)


def conv3_half_step_cuda(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                         boundary: str, out=None, scratch=None) -> torch.Tensor:
    """One RL half-step of either backend with the kernels: per term the
    z+y step (on :func:`convzy_route`'s route) into scratch, then
    ``conv_x`` (wrapped when circular) adds the earlier terms' sum and
    applies the epilogue. ``out`` may be ``aux`` (the in-place mult
    update) but not ``inp``; ``scratch`` (1 carry, 2 with more than one
    term) is allocated when not given, as is the two-pass route's carry
    for its z pass."""
    _, _, zy_cuda, wrap = _ops_of(boundary, mode)
    check_io_cuda(inp, aux, mode, "conv3_half_step_cuda")

    def zy(v, t, scratch):
        kz, ky, _ = stencil.dev[t]
        return zy_cuda(v, kz, ky, out=scratch[0], taps=stencil.packed()[t],
                       host=stencil.host32[t][:2])

    return run_terms_cuda(inp, aux, stencil, mode, eps, zy, 1, out=out, scratch=scratch,
                          wrap=wrap, name="conv3_half_step_cuda")


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


def conv3_circular_route(shape, radii, n_terms: int = 1) -> str:
    """Which kernels run :func:`conv3_circular_cuda` on a (gz, gy, gx)
    carry with PSF ``radii`` in ``n_terms`` terms: ``"one_launch"``
    (:func:`conv3_one_launch`) where the block of ``csrc/rl_half.cu``
    fits (:func:`~shrimpy_tpu_torch.ops.rl_fused.half_layout`: its ring of
    ``2 rz + 2`` slabs in 232,448 bytes, the launch grid), else
    ``"zy_then_x"`` (:func:`conv3_half_step_cuda` in mode ``plain``). Both
    give the same bits; the choice reads the shapes and nothing else."""
    return "one_launch" if half_layout(shape, radii, n_terms) is not None else "zy_then_x"


def conv3_one_launch(v: torch.Tensor, stencil: Stencil, *, out=None) -> torch.Tensor:
    """``sum_t X_t Y_t Z_t v``, circular on every axis, as one launch of
    ``csrc/rl_half.cu`` built with ``RL_HALF_WRAP=1`` for the stencil's
    lengths, its number of terms and ``half_layout``'s tile (kind
    ``rl_half_wrap`` of ``kernels/build.py``), in mode ``plain``.
    ``out`` must not alias ``v``. Raises :class:`ValueError` where the
    block does not fit."""
    shape = check_io_cuda(v, None, "plain", "conv3_one_launch")
    n_terms = len(stencil.host)
    layout = half_layout(shape, stencil.radii, n_terms)
    if layout is None:
        raise ValueError(f"conv3_one_launch: radii {stencil.radii} in {n_terms} terms on {shape} "
                         "fit no tile of the one-launch kernel's block")
    _check_stencil(stencil, v)
    if out is None:
        out = torch.empty_like(v)
    _check_cuda_operand("out", out, shape)
    _check_distinct(v=v, out=out)

    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = shape
    vec = gx % 4 == 0 and v.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    geometry = (n_terms, *(2 * r + 1 for r in stencil.radii), *layout["tile"], 1)
    check(load_geometry_library("rl_half_wrap", geometry).shrimpy_rl_half(
        v.data_ptr(), None, out.data_ptr(), None, None, None, None, stencil.packed().data_ptr(),
        *geometry[:4], gz, gy, gx, *geometry[4:6], 0, int(vec), 0.0,
        torch.cuda.current_stream(v.device).cuda_stream,
    ), "shrimpy_rl_half (circular)")
    conv3_one_launch.launches += 1
    return out


# Launches of the one-launch route since the last reset (the other route's
# z+y steps count in convzy_circular_cuda.launches).
conv3_one_launch.launches = 0


def conv3_circular_cuda(v: torch.Tensor, stencil: Stencil, *, out=None, scratch=None) -> torch.Tensor:
    """Circular separable conv3 on the card (replaces ``conv3_pallas.py::
    _conv3_pallas_jit``), on the route of :func:`conv3_circular_route`:
    one launch, or per term the z+y step then the x pass (``scratch`` is
    that route's, allocated when not given)."""
    if v.dim() != 3:
        raise ValueError(f"conv3_circular_cuda takes a 3-D carry, got {tuple(v.shape)}")
    route = conv3_circular_route(tuple(v.shape), stencil.radii, len(stencil.host))
    if route == "one_launch":
        out = conv3_one_launch(v, stencil, out=out)
    else:
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
