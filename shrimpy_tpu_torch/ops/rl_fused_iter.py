"""Whole-iteration Richardson-Lucy: one kernel launch per RL iteration
(counterpart of ``shrimpy_tpu/ops/rl_fused_iter.py``, backend
``separable_backend: fused_iter``).

Same semantics as the ``fused`` backend (:mod:`~shrimpy_tpu_torch.ops.rl_fused`):
zero-boundary RL on the G grid (the image padded by the PSF radii),

    est_new = est * conv^T(data / max(conv(est), eps)),

``conv = sum_t Z_t Y_t X_t`` over the separable terms, ``conv^T`` the
same with every tap list reversed; oracle
``richardson_lucy_reference_separable(boundary="zero")``. What differs is
what touches device memory: the ``fused`` route writes the ratio and two
per-axis intermediates per half-step, this one reads ``est`` and ``data``
and writes ``est_new`` — the ratio and every intermediate stay in shared
memory (``csrc/rl_iter.cu``).

The TPU kernel's layout is not ported: its 128-row y tiles, the
staggered x offset of the est carry, the 8/128 slab rounding, the y<->x
swap, the banded-y and staggered-x MXU stencils in bf16 hi/lo pieces and
the environment switches that size its blocks. The CUDA kernel works on
the exact G grid in float32 FMA, as the other kernels of the port do, and
:func:`iter_layout` only picks the (y, x) tile whose rings fit a block's
shared memory. That bound is geometry alone, the same on every device.

Biggs acceleration runs through the generic loop
(:func:`~shrimpy_tpu_torch.ops.rl_outer.run_rl_outer`), as in JAX. The
kernel never writes over its input: a neighbouring block still reads the
halo of ``est`` while this one stores, and the Biggs loop reads the
previous output after the step returns. :func:`rl_fused_iter` therefore
keeps two carries and alternates between them.

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
    crop_grid,
    start_on_grid,
    term_tap_floats,
    window_taps,  # noqa: F401  (the tap layout's other half, read by the tests)
)
from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer

# (ty, tx) tiles of csrc/rl_iter.cu in order of preference: the first
# whose shared memory fits runs. The order is that of their times at the
# production carry (PERF.md): the larger the tile, the less halo it
# recomputes; the small ones only take radii the large ones cannot.
TILES = ((32, 48), (32, 32), (16, 64), (16, 32), (8, 32), (8, 16), (4, 8))


def tile_threads(tile) -> int:
    """Threads of a block on ``tile``: 1024 where the tile has work for
    them, else 512 (two blocks an SM where the rings allow)."""
    return 1024 if tile[0] * tile[1] >= 1024 else 512


def iter_smem_bytes(tile, radii, n_terms: int) -> int:
    """Shared memory of one ``csrc/rl_iter.cu`` block with a (ty, tx)
    ``tile``: both directions' packed taps, the est slab (reused for the
    ratio plane) and the x-pass scratch (reused by the adjoint), both
    with their row strides made odd, and the two rings of ``2 rz + 1``
    planes per term. The kernel's own sum is ``shrimpy_rl_iter_smem``."""
    ty, tx = tile
    rz, ry, rx = radii
    ring = 2 * rz + 1
    taps = 2 * n_terms * term_tap_floats((ring, 2 * ry + 1, 2 * rx + 1))
    slab = (ty + 4 * ry) * ((tx + 4 * rx) | 1)
    scratch = (ty + 4 * ry) * ((tx + 2 * rx) | 1)
    ring_a = n_terms * ring * (ty + 2 * ry) * (tx + 2 * rx)
    ring_b = n_terms * ring * ty * tx
    return 4 * (taps + slab + scratch + ring_a + ring_b)


def iter_layout(g_shape, radii, n_terms: int = 1, *, tile=None) -> dict | None:
    """The tile the whole-iteration kernel runs a (gz, gy, gx) carry
    with, ``{"tile": (ty, tx), "threads": n, "smem_bytes": n}``, or None
    when no tile fits (:func:`iter_bound_error` says why). ``tile`` forces one."""
    if iter_grid_error(g_shape) is not None:
        return None
    for cand in ((tuple(tile),) if tile is not None else TILES):
        smem = iter_smem_bytes(cand, radii, n_terms)
        if smem <= _SMEM_BYTES and -(-g_shape[1] // cand[0]) <= _MAX_GRID_YZ:
            return {"tile": cand, "threads": tile_threads(cand), "smem_bytes": smem}
    return None


def iter_grid_error(g_shape) -> str | None:
    gz, gy, gx = g_shape
    if gy * gx > _MAX_INT or -(-gy // max(t[0] for t in TILES)) > _MAX_GRID_YZ:
        return (f"carry {tuple(g_shape)} exceeds the launch grid (a plane of "
                f"{gy} x {gx} voxels is indexed in 32 bits)")
    return None


def iter_bound_error(g_shape, radii, n_terms: int = 1) -> str | None:
    """Why the whole-iteration kernel cannot take a (gz, gy, gx) carry
    with PSF ``radii`` and ``n_terms`` separable terms, or None when it
    can."""
    if iter_layout(g_shape, radii, n_terms) is not None:
        return None
    grid = iter_grid_error(g_shape)
    if grid is not None:
        return grid
    smallest = TILES[-1]
    return (f"radii {tuple(radii)} with {n_terms} term(s) exceed the kernel's shared memory: "
            f"the rings of its smallest tile {smallest} take "
            f"{iter_smem_bytes(smallest, radii, n_terms)} bytes of {_SMEM_BYTES}")


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
    launch, the ratio never in device memory.

    ``est`` and ``data`` are (gz, gy, gx) float32 CUDA tensors; ``out``
    (allocated when not given; the only carry-sized allocation) must
    alias neither. ``taps`` is :func:`pack_taps` of the two stencils,
    packed here when not given; ``tile`` forces a (ty, tx) tile. Raises
    on a geometry outside :func:`iter_bound_error`.
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
        bound = iter_bound_error(shape, conv.radii, n_terms)
        raise ValueError(f"rl_iter_cuda: {bound or f'tile {tuple(tile)} does not fit'}")
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

    from shrimpy_tpu_torch.kernels.build import check, load_library

    rz, ry, rx = conv.radii
    ty, tx = layout["tile"]
    check(load_library().shrimpy_rl_iter(
        est.data_ptr(), data.data_ptr(), out.data_ptr(), taps.data_ptr(), n_terms,
        2 * rz + 1, 2 * ry + 1, 2 * rx + 1, *shape, ty, tx, layout["threads"], float(eps),
        torch.cuda.current_stream(est.device).cuda_stream,
    ), "shrimpy_rl_iter")
    rl_iter_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets it).
rl_iter_cuda.launches = 0


def rl_iter(est: torch.Tensor, data: torch.Tensor, conv: Stencil, adj: Stencil,
            eps: float = 1e-6, out: torch.Tensor | None = None, *, taps=None) -> torch.Tensor:
    """One whole RL iteration: the kernel for a CUDA tensor, the plain
    version for a CPU tensor (``out`` and ``taps`` are unused there)."""
    if est.is_cuda:
        return rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps)
    return rl_iter_plain(est, data, conv, adj, eps)


def rl_fused_iter(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
                  plain: bool = False, dtype: torch.dtype = torch.float32,
                  donate: bool = False) -> torch.Tensor:
    """Zero-boundary separable RL of a (Z, Y, X) ``image`` on its device,
    one :func:`rl_iter` per iteration.

    Arguments as :func:`~shrimpy_tpu_torch.ops.rl_fused.rl_fused`;
    ``plain=True`` runs :func:`rl_iter_plain` on any device in ``dtype``
    (the reference path). ``settings.acceleration == "biggs"`` runs the
    generic Biggs loop around the same step. Memory on the card: data
    and two est carries that the steps alternate between (with Biggs
    also the loop's extrapolated point and bf16 state). Raises
    :class:`ValueError` outside :func:`iter_bound_error`.
    """
    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    radii = tuple(k // 2 for k in psf_np.shape)
    bound = iter_bound_error(tuple(n + 2 * r for n, r in zip(shape, radii)), radii, len(terms))
    if bound is not None:
        raise ValueError(
            "geometry/PSF outside the fused_iter kernel's constraints "
            f"(image {shape}, psf {tuple(psf_np.shape)}): {bound}; "
            "use separable_backend='fused' or 'matmul'")
    conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype, donate=donate)
    del image
    if plain or not est.is_cuda:
        def step(v: torch.Tensor) -> torch.Tensor:
            return rl_iter_plain(v, data, conv, adj, eps)
    else:
        taps = pack_taps(conv, adj, est.device)
        # The step writes bufs[turn] and flips: never its input (est, or
        # the last output) nor, in the Biggs loop, the output before.
        bufs, turn = [est, torch.empty_like(est)], 1

        def step(v: torch.Tensor) -> torch.Tensor:
            nonlocal turn
            out = rl_iter_cuda(v, data, conv, adj, eps, bufs[turn], taps=taps)
            turn ^= 1
            return out

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    return crop_grid(est, shape, conv.radii)
