"""Whole-iteration Richardson-Lucy: one kernel launch per RL iteration
(counterpart of ``shrimpy_tpu/ops/rl_fused_iter.py``, backend
``separable_backend: fused_iter``).

Same semantics as the ``fused`` backend (:mod:`~shrimpy_tpu_torch.ops.rl_fused`):
zero-boundary RL on the G grid (the image padded by the PSF radii),

    est_new = est * conv^T(data / max(conv(est), eps)),

``conv = sum_t Z_t Y_t X_t`` over the separable terms, ``conv^T`` the
same with every tap list reversed; oracle
``richardson_lucy_reference_separable(boundary="zero")``. What differs is
what touches device memory: the ``fused`` route writes the ratio between
its two half-steps, this one reads ``est`` and ``data`` and writes
``est_new`` — the ratio and every intermediate stay on the chip
(``csrc/rl_iter.cu``).

The TPU kernel's layout is not ported: its 128-row y tiles, the
staggered x offset of the est carry, the 8/128 slab rounding, the y<->x
swap, the banded-y and staggered-x MXU stencils in bf16 hi/lo pieces and
the environment switches that size its blocks. The CUDA kernel works on
the exact G grid in float32 FMA, as the other kernels of the port do.

Two routes, chosen by :func:`rl_iter_route` from the shapes alone (the
same choice on every device, a launch counter each): ``one_launch``, the
kernel of ``csrc/rl_iter.cu``, where its block fits
(:func:`iter_layout`: the ring of the y pass's planes in shared memory,
the slab of a TMA box, the planes of the adjoint z pass in registers);
``half_steps`` past that, the ``fused`` backend's two half-steps
(:func:`~shrimpy_tpu_torch.ops.rl_fused.half_step_cuda` in ``ratio``
then ``mult`` mode, which choose their own kernels). So the backend
takes every geometry ``fused`` takes (:func:`iter_bound_error`), as the
JAX package's ``fused_iter`` falls back to ``rl_fused`` past its own
layout. The one-launch kernel applies each term's axes x, y, z, the
half-steps z, y, x: the two routes agree to float32 round-off, not bit
for bit (each is bit-equal to its own plain version).

Biggs acceleration runs through the generic loop
(:func:`~shrimpy_tpu_torch.ops.rl_outer.run_rl_outer`), as in JAX.
Neither route writes over its input: on the one-launch route a
neighbouring block still reads the halo of ``est`` while this one
stores, and the Biggs loop reads the previous output after the step
returns. :func:`rl_fused_iter` therefore keeps two carries and
alternates between them on both routes.

``auto`` never resolves to this backend. JAX's does only under the
environment switch ``SHRIMPY_RL_FUSE_ITER=1``, which the port does not
read: name the backend in the settings.
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
    _conv_axis_plain,
    _round4,
    crop_grid,
    fused_bound_error,
    half_step_cuda,
    half_step_route,
    start_on_grid,
    term_tap_floats,
    window_taps,  # noqa: F401  (the tap layout's other half, read by the tests)
)
from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer
from shrimpy_tpu_torch.utils.shapes import round_up
from shrimpy_tpu_torch.utils.timing import span

ROUTES = ("one_launch", "half_steps")
# (ty, tx) tiles of csrc/rl_iter.cu in order of preference: the first that
# fits runs (PERF.md has their times at the production carry). The kernel
# is compiled for the PSF's lengths, the number of terms and the tile.
TILES = ((32, 48), (48, 32), (40, 40), (24, 64), (32, 32), (24, 32), (16, 64), (16, 32),
         (8, 32), (8, 16), (4, 8))
# A block of csrc/rl_iter.cu: its threads; the rows and columns of a TMA
# box; the 16-byte chunks of a slab a thread moves by cp.async; the planes
# of the adjoint z pass (n_terms * 2 rz) a thread keeps in registers.
_THREADS = 512
_BOX = 256
_CHUNKS = 8
_KEPT = 16
_GUARD_ROWS, _TOP_ROWS = 4, 3


def iter_slab(tile, radii) -> tuple[int, int]:
    """(rows, columns) of the est slab a ``csrc/rl_iter.cu`` block loads
    of every plane: the (ty, tx) ``tile`` with twice the y halo, and
    ``round4(2 rx)`` columns on each side of it in x (an odd ``rx`` is
    walked one wider, with a zero tap at each end, so that the slab
    starts 16-byte-aligned, as a TMA box must, and every x window reads
    whole 16-byte pieces)."""
    (ty, tx), (_, ry, rx) = tile, radii
    return ty + 4 * ry, tx + 2 * _round4(2 * rx)


def iter_smem_bytes(tile, radii, n_terms: int) -> int:
    """Dynamic shared memory of one ``csrc/rl_iter.cu`` block on a (ty,
    tx) ``tile``: both directions' packed taps, the est slab, per term the
    x pass's plane (with guard rows of zeros that the y window reaches),
    the ring of ``2 rz + 2`` y-pass planes of the (ty + 2 ry) x (tx +
    round4(2 rx)) footprint and the adjoint x pass's plane, the ratio
    plane, and the mbarrier, each region a multiple of 128 bytes. The
    kernel's own sum is ``shrimpy_rl_iter_smem``."""
    (ty, tx), (rz, ry, rx) = tile, radii
    sr, sw = iter_slab(tile, radii)
    mr, xw = ty + 2 * ry, tx + _round4(2 * rx)
    taps = round_up(2 * n_terms * term_tap_floats((2 * rz + 1, 2 * ry + 1, 2 * rx + 1)), 32)
    xs = round_up((_GUARD_ROWS + sr + _TOP_ROWS) * xw, 32)
    slot = round_up(mr * xw, 32)
    bx = round_up((_GUARD_ROWS + mr) * tx, 32)
    floats = taps + round_up(sr * sw, 32) + n_terms * (xs + (2 * rz + 2) * slot + bx) + slot + 4
    return 4 * floats


def _tile_error(tile, radii, n_terms: int) -> str | None:
    """Why a block of ``csrc/rl_iter.cu`` cannot take ``tile`` with PSF
    ``radii`` in ``n_terms`` terms (the kernel's static_assert)."""
    ty, tx = tile
    rows, cols = iter_slab(tile, radii)
    smem = iter_smem_bytes(tile, radii, n_terms)
    if ty % 4 or tx % 4 or (ty // 4) * tx > _THREADS:
        return f"tile {tuple(tile)} is no block's: ty, tx multiples of 4, ty / 4 * tx <= {_THREADS}"
    if rows > _BOX or cols > _BOX:
        return f"its est slab of {rows} x {cols} exceeds a TMA box of {_BOX} x {_BOX}"
    if -(-rows * cols // 4) > _THREADS * _CHUNKS:
        return (f"its est slab of {rows} x {cols} exceeds the {_CHUNKS} 16-byte pieces a "
                "thread copies")
    if n_terms * 2 * radii[0] > _KEPT:
        return (f"the adjoint z pass keeps {n_terms} x {2 * radii[0]} planes a thread in "
                f"registers, more than {_KEPT}")
    if smem > _SMEM_BYTES:
        return f"its shared memory takes {smem} bytes of {_SMEM_BYTES}"
    return None


def iter_layout(g_shape, radii, n_terms: int = 1, *, tile=None) -> dict | None:
    """The tile the whole-iteration kernel runs a (gz, gy, gx) carry
    with, ``{"tile": (ty, tx), "threads": n, "smem_bytes": n, "blocks":
    n}``, or None when none of :data:`TILES` fits (:func:`iter_block_error`
    says why). ``tile`` forces one."""
    gz, gy, gx = g_shape
    if gy * gx > _MAX_INT:
        return None
    for cand in ((tuple(tile),) if tile is not None else TILES):
        if _tile_error(cand, radii, n_terms) is None and -(-gy // cand[0]) <= _MAX_GRID_YZ:
            return {"tile": cand, "threads": _THREADS,
                    "smem_bytes": iter_smem_bytes(cand, radii, n_terms),
                    "blocks": -(-gy // cand[0]) * -(-gx // cand[1])}
    return None


def iter_block_error(g_shape, radii, n_terms: int = 1) -> str | None:
    """Why the one-launch kernel (``csrc/rl_iter.cu``) cannot take a
    (gz, gy, gx) carry with PSF ``radii`` in ``n_terms`` terms, or None
    when it can. Geometry alone, the same on every device."""
    if iter_layout(g_shape, radii, n_terms) is not None:
        return None
    gz, gy, gx = g_shape
    smallest = TILES[-1]
    if gy * gx > _MAX_INT or -(-gy // smallest[0]) > _MAX_GRID_YZ:
        return (f"carry {tuple(g_shape)} exceeds the launch grid (a plane of {gy} x {gx} voxels "
                "is indexed in 32 bits)")
    return (f"radii {tuple(radii)} with {n_terms} term(s) exceed the one-launch kernel's block: "
            f"on its smallest tile {smallest}, {_tile_error(smallest, radii, n_terms)}")


def iter_bound_error(g_shape, radii, n_terms: int = 1) -> str | None:
    """Why ``fused_iter`` cannot take a (gz, gy, gx) carry with PSF
    ``radii`` in ``n_terms`` terms, or None when it can: what the
    ``fused`` backend refuses (:func:`~shrimpy_tpu_torch.ops.rl_fused.fused_bound_error`),
    since past the one-launch kernel's block the iteration runs as its
    half-steps (:func:`rl_iter_route`). That is the radii alone: a carry
    of any extent runs, a long x row in pieces and a carry deeper or
    taller than a launch's grid on the half-step route."""
    return fused_bound_error(g_shape, radii)


def rl_iter_route(shape, radii, n_terms: int = 1) -> str:
    """Which kernels run an iteration of ``fused_iter`` on a (gz, gy, gx)
    carry: ``"one_launch"`` (``csrc/rl_iter.cu``) where its block fits
    (:func:`iter_block_error`), else ``"half_steps"`` (two
    :func:`~shrimpy_tpu_torch.ops.rl_fused.half_step_cuda`). The choice
    reads the shapes and nothing else, so it is the same on every
    device. Raises :class:`ValueError` outside :func:`iter_bound_error`."""
    bound = iter_bound_error(shape, radii, n_terms)
    if bound is not None:
        raise ValueError(f"fused_iter: {bound}")
    return ROUTES[0] if iter_block_error(shape, radii, n_terms) is None else ROUTES[1]


def rl_iter_supported(image_shape, psf_shape, n_terms: int = 1) -> bool:
    """Whether ``separable_backend: fused_iter`` takes a (Z, Y, X) image
    with a PSF of ``psf_shape`` in ``n_terms`` terms (geometry only)."""
    radii = tuple(k // 2 for k in psf_shape)
    g_shape = tuple(n + 2 * r for n, r in zip(image_shape, radii))
    return iter_bound_error(g_shape, radii, n_terms) is None


def _conv3_xyz_plain(v: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Zero-boundary ``sum_t Z_t Y_t X_t v`` with the axes applied in the
    kernel's order: x, then y, then z."""
    acc = None
    for wz, wy, wx in stencil.host:
        w = _conv_axis_plain(v, wx, 2)
        w = _conv_axis_plain(w, wy, 1)
        w = _conv_axis_plain(w, wz, 0)
        acc = w if acc is None else acc.add_(w)
    return acc


def rl_iter_plain(est: torch.Tensor, data: torch.Tensor, conv: Stencil, adj: Stencil,
                  eps: float = 1e-6) -> torch.Tensor:
    """One whole RL iteration in plain PyTorch (any device, any float
    dtype): ``est * conv^T(data / max(conv(est), eps))`` on the G grid,
    zero outside. It is the ``ratio`` then ``mult`` half-steps of
    :func:`~shrimpy_tpu_torch.ops.rl_fused.half_step_plain` with each
    term's axes applied x, y, z as the kernel applies them (the
    half-steps go z, y, x; the two agree to float32 round-off)."""
    if est.is_cuda:
        rl_iter_plain.cuda_calls += 1
    ratio = data / torch.clamp_min(_conv3_xyz_plain(est, conv), eps)
    return est * _conv3_xyz_plain(ratio, adj)


# Calls of the plain version on a CUDA tensor since the last reset.
rl_iter_plain.cuda_calls = 0


def pack_taps(conv: Stencil, adj: Stencil, device) -> torch.Tensor:
    """Both directions' taps as the kernel reads them: a float32
    ``(2, n_terms, term_tap_floats)`` tensor on ``device``, ``[0]`` the
    convolution's and ``[1]`` the adjoint's, each as
    :meth:`~shrimpy_tpu_torch.ops.rl_fused.Stencil.packed_host` lays it out."""
    if conv.radii != adj.radii or len(conv.host) != len(adj.host):
        raise ValueError("the convolution and adjoint stencils differ in radii or terms")
    return torch.from_numpy(np.stack([conv.packed_host(), adj.packed_host()])).to(device)


def rl_iter_cuda(est: torch.Tensor, data: torch.Tensor, conv: Stencil, adj: Stencil,
                 eps: float = 1e-6, out: torch.Tensor | None = None, *,
                 taps: torch.Tensor | None = None, tile=None) -> torch.Tensor:
    """One whole RL iteration with the kernel of ``csrc/rl_iter.cu``: one
    launch, the ratio never in device memory. The kernel is compiled for
    the stencils' lengths, the number of terms and the tile at the first
    call with them (``kernels/build.py::load_geometry_library``).

    ``est`` and ``data`` are (gz, gy, gx) float32 CUDA tensors; ``out``
    (allocated when not given; the only carry-sized allocation) must
    alias neither. ``taps`` is :func:`pack_taps` of the two stencils,
    packed here when not given; ``tile`` forces a (ty, tx) tile. Raises
    on a geometry outside :func:`iter_block_error`.
    """
    if est.dim() != 3:
        raise ValueError(f"rl_iter_cuda takes a 3-D carry, got {tuple(est.shape)}")
    shape = tuple(est.shape)
    _check_cuda_operand("est", est, shape)
    _check_cuda_operand("data", data, shape)
    _check_stencil(conv, est)
    n_terms = len(conv.host)
    layout = iter_layout(shape, conv.radii, n_terms, tile=tile)
    if layout is None:
        raise ValueError("rl_iter_cuda: " + (
            iter_block_error(shape, conv.radii, n_terms)
            or f"tile {tuple(tile)} does not fit the one-launch kernel's block"))
    if taps is None:
        taps = pack_taps(conv, adj, est.device)
    n_taps = term_tap_floats(tuple(2 * r + 1 for r in conv.radii))
    _check_cuda_operand("taps", taps, (2, n_terms, n_taps))
    if taps.device != est.device:
        raise ValueError("rl_iter_cuda: taps must be on the carry's device")
    if out is None:
        out = torch.empty_like(est)
    _check_cuda_operand("out", out, shape)
    _check_distinct(est=est, out=out)
    _check_distinct(data=data, out=out)

    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = shape
    geometry = (n_terms, *(2 * r + 1 for r in conv.radii), *layout["tile"])
    vec = gx % 4 == 0 and est.data_ptr() % 16 == 0  # the slab by TMA, else cp.async
    check(load_geometry_library("rl_iter", geometry).shrimpy_rl_iter(
        est.data_ptr(), data.data_ptr(), out.data_ptr(), taps.data_ptr(), None, *geometry[:4],
        gz, gy, gx, *geometry[4:], int(vec), float(eps),
        torch.cuda.current_stream(est.device).cuda_stream,
    ), "shrimpy_rl_iter")
    rl_iter_cuda.launches += 1
    return out


def rl_iter_half_steps(est: torch.Tensor, data: torch.Tensor, conv: Stencil, adj: Stencil,
                       eps: float = 1e-6, out: torch.Tensor | None = None, *,
                       ratio: torch.Tensor | None = None, scratch=None) -> torch.Tensor:
    """One whole RL iteration as the ``fused`` backend's two half-steps,
    :func:`~shrimpy_tpu_torch.ops.rl_fused.half_step_cuda` in ``ratio``
    then ``mult`` mode: the route past the one-launch kernel's block.
    Operands as :func:`rl_iter_cuda`; ``ratio`` (a carry) and ``scratch``
    (the three-pass route's) are allocated when not given. ``est`` is
    never written."""
    _check_cuda_operand("est", est, tuple(est.shape))
    if out is None:
        out = torch.empty_like(est)
    if ratio is None:
        ratio = torch.empty_like(est)
    _check_distinct(est=est, data=data, out=out, ratio=ratio)
    half_step_cuda(est, data, conv, "ratio", eps, out=ratio, scratch=scratch)
    half_step_cuda(ratio, est, adj, "mult", eps, out=out, scratch=scratch)
    rl_iter_half_steps.launches += 1
    return out


# Iterations since the last reset, counted on each route where it runs
# (chip_smoke.py reads and resets them): a kernel launch each on the
# one-launch route, two half-steps each on the other.
rl_iter_cuda.launches = 0
rl_iter_half_steps.launches = 0


def rl_iter(est: torch.Tensor, data: torch.Tensor, conv: Stencil, adj: Stencil,
            eps: float = 1e-6, out: torch.Tensor | None = None, *, taps=None) -> torch.Tensor:
    """One whole RL iteration: on a CUDA tensor the route of
    :func:`rl_iter_route`, on a CPU tensor the plain version (``out`` and
    ``taps`` are unused there)."""
    if not est.is_cuda:
        return rl_iter_plain(est, data, conv, adj, eps)
    if rl_iter_route(tuple(est.shape), conv.radii, len(conv.host)) == ROUTES[0]:
        return rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps)
    return rl_iter_half_steps(est, data, conv, adj, eps, out)


def rl_fused_iter(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
                  plain: bool = False, dtype: torch.dtype = torch.float32,
                  donate: bool = False) -> torch.Tensor:
    """Zero-boundary separable RL of a (Z, Y, X) ``image`` on its device,
    one whole iteration at a time.

    Arguments as :func:`~shrimpy_tpu_torch.ops.rl_fused.rl_fused`;
    ``plain=True`` runs :func:`rl_iter_plain` on any device in ``dtype``
    (the reference path). ``settings.acceleration == "biggs"`` runs the
    generic Biggs loop around the same step. On the card each iteration
    takes :func:`rl_iter_route`'s route. Memory on the card: data and two
    est carries that the steps alternate between (on the half-step route
    also the ratio and, past the one-launch half-step's block, its 2-3
    scratch carries; with Biggs also the loop's extrapolated point and
    bf16 state). Raises :class:`ValueError` outside :func:`iter_bound_error`.
    """
    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    radii = tuple(k // 2 for k in psf_np.shape)
    bound = iter_bound_error(tuple(n + 2 * r for n, r in zip(shape, radii)), radii, len(terms))
    if bound is not None:
        raise ValueError(
            "geometry/PSF outside the fused_iter backend's constraints "
            f"(image {shape}, psf {tuple(psf_np.shape)}): {bound}; "
            "use separable_backend='matmul'")
    with span("shrimpy.rl.start"):
        conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype,
                                             donate=donate)
        del image
        if plain or not est.is_cuda:
            def step(v: torch.Tensor) -> torch.Tensor:
                return rl_iter_plain(v, data, conv, adj, eps)
        else:
            g_shape, n_terms = tuple(est.shape), len(terms)
            if rl_iter_route(g_shape, conv.radii, n_terms) == ROUTES[0]:
                taps = pack_taps(conv, adj, est.device)

                def one(v, out):
                    return rl_iter_cuda(v, data, conv, adj, eps, out, taps=taps)
            else:
                ratio = torch.empty_like(est)
                scratch = None
                if half_step_route(g_shape, conv.radii, n_terms) == "three_pass":
                    scratch = [torch.empty_like(est) for _ in range(2 if n_terms == 1 else 3)]

                def one(v, out):
                    return rl_iter_half_steps(v, data, conv, adj, eps, out, ratio=ratio,
                                              scratch=scratch)
            # The step writes bufs[turn] and flips: never its input (est, or
            # the last output) nor, in the Biggs loop, the output before.
            bufs, turn = [est, torch.empty_like(est)], 1

            def step(v: torch.Tensor) -> torch.Tensor:
                nonlocal turn
                out = one(v, bufs[turn])
                turn ^= 1
                return out

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    return crop_grid(est, shape, conv.radii)
