"""Separable Richardson-Lucy on the zero-boundary grid (counterpart of
``shrimpy_tpu/ops/rl_fused.py``), with the half-step as a CUDA kernel.

What the slice computes is the JAX ``fused`` backend's semantics, not
its TPU layout. The image is padded by the PSF radii with ``pad_mode``
(``reflect``, ``edge`` or zeros for ``constant``, as ``np.pad``) to the
G grid; ``data = max(g, 0)``, ``est = max(g, eps)``; each iteration

    ratio = data / max(conv(est), eps)        # half-step, mode "ratio"
    est   = est * conv^T(ratio)               # half-step, mode "mult"

where ``conv = sum_t X_t Y_t Z_t`` over the separable terms, zero
outside G, in the convention ``out[n] = sum_i k[i] in[n + r - i]``, and
``conv^T`` is the same operator with every tap list reversed. The pads
are cropped at the end. Oracle:
``richardson_lucy_reference_separable(..., pads=half-PSF, boundary="zero")``.

The TPU layout machinery — the y<->x swap (``fused_best_layout``), the
staggered est offset, 128-lane tile rounding, the bf16 hi/lo split — is
not ported: the CUDA kernels work on the exact G grid in float32 FMA, so
the JAX kernel's limits (``rz <= bz``, ``ry <= 120``, ``rx <= 128``) do
not apply; :func:`half_step_cuda` raises on what no kernel takes.

A half-step on the card is one launch of ``csrc/rl_half.cu``, as the
TPU kernel is one ``pallas_call``: a block marches through z with a
ring of input planes in shared memory (loaded by the TMA engine where
the x rows and the pointers allow 16-byte copies, else by ``cp.async``),
so the launch reads the input and ``aux`` once and writes ``out`` once,
whatever the number of terms. The kernel is compiled for the geometry
it runs (the PSF's lengths, the number of terms, the tile) at the first
half-step with it. Its shared memory and the 256 x 256 box of
a TMA copy bound the radii, and its grid the carry's height
(:func:`half_bound_error`); past that bound three launches a term run
(z pass, y pass, x pass with the epilogue, two or three scratch carries),
which take every geometry inside :func:`fused_bound_error`.
:func:`half_step_route` is that choice, made from the shapes alone and the
same on every device. Each of the three passes runs ``csrc/rl_pass.cu``,
compiled for the length of its tap list, where that list has at most
:data:`PASS_MAX_TAPS` taps (and, for the x pass, where its block fits:
:func:`x_pass_route`); a longer list runs ``csrc/rl_fused.cu``'s kernels
of run-time length (the first port's, which also take tap lists past a
column of shared memory in chunks). Both give the same bits.

``acceleration: biggs`` runs Biggs-Andrews RL inside the half-steps,
as the JAX ``fused`` backend does (``rl_fused.py:937-987``): mode
``ratio_accel`` convolves ``y = max(x + alpha*dx, 0)`` formed as x is
read, and mode ``mult_accel`` writes ``x_new = y * conv^T(ratio)``,
``dx = bf16(x_new - x)``, ``g = bf16(x_new - y)`` and the step-length
sums ``<g, g_prev>``, ``<g, g>``; ``alpha`` stays a device scalar (see
:mod:`shrimpy_tpu_torch.ops.rl_outer` for the algorithm). The state
``dx``/``g`` is bf16 in every dtype, so the float64 plain run is the
reference for the same algorithm.

:func:`half_step` dispatches on the device: :func:`half_step_plain`
(shifted-slice FMAs; any float dtype, so also the float64 reference) for
a CPU tensor, :func:`half_step_cuda` for a CUDA tensor. The plain version does not use ``F.conv1d``: cuDNN runs float32
convolutions as TF32 by default, and it must also run in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from shrimpy_tpu_torch.ops.rl_outer import biggs_state, next_alpha
from shrimpy_tpu_torch.utils.shapes import round_up
from shrimpy_tpu_torch.utils.timing import span

MODES = {"plain": 0, "ratio": 1, "mult": 2, "ratio_accel": 1, "mult_accel": 2}
ACCEL_MODES = ("ratio_accel", "mult_accel")
PAD_MODES = ("reflect", "edge", "constant")

# Shared-memory ceiling of one block (H100: 227 KB opt-in) and the tile
# constants of csrc/rl_fused.cu, which bound the radii its kernels take.
_SMEM_BYTES = 232448
_TILE_N = 32
_THREADS_INNER = 128
_THREADS_ROW = 128
_MAX_GRID_YZ = 65535
_MAX_INT = 2**31 - 1
# The x pass: the most columns of a row a block stages when the whole row
# does not fit, and conv_x_accel_kernel's static reduction buffer.
_X_PIECE = 16384
_X_STATIC_BYTES = 64
# csrc/rl_pass.cu, the passes compiled for their tap count: the longest tap
# list it takes (its axis pass keeps 2 x that many floats in registers), the
# outputs a thread of its x pass computes, and the axis pass's tiling: a
# thread takes a whole column where the columns alone give the launch
# _AXIS_THREADS threads, else tiles of at least _AXIS_MIN_TILE outputs.
PASS_MAX_TAPS = 63
PASS_ROUTES = ("compiled", "runtime")
_X_ROW_OUT = 4
_AXIS_THREADS = 1 << 20
_AXIS_MIN_TILE = 256

ROUTES = ("one_launch", "three_pass")
# (ty, tx) tiles of csrc/rl_half.cu in order of preference: the first
# whose shared memory fits runs (PERF.md has their times at the
# production carry). ty and tx are multiples of 4. The kernel is compiled
# for the PSF's lengths, the number of terms and the tile that are run.
HALF_TILES = ((32, 64), (24, 64), (16, 64), (16, 32), (8, 32))
# A block of csrc/rl_half.cu: its threads, and the 16-byte chunks of an
# input slab a thread moves. A thread has at most one 4-row x 2-column
# piece of the y pass and one 4-output piece of a row of the x pass.
_HALF_THREADS = 512
_HALF_CHUNKS = 3
_HALF_BOX = 256  # rows and columns of a slab: the most a TMA box takes


def _round4(n: int) -> int:
    return (n + 3) & ~3


def window_taps(k: int) -> int:
    """Floats a kernel reads of a ``k``-tap x or y list: 3 zeros, the
    taps, zeros to a multiple of 4, and one more group of 4 that its
    sliding window reads ahead (``csrc/stencil.cuh``)."""
    return _round4(k + 3) + 4


def term_tap_floats(lengths) -> int:
    """Floats of one term's packed taps: ``kz`` padded to a multiple of
    4, then the ``ky`` and ``kx`` windows."""
    nkz, nky, nkx = lengths
    return _round4(nkz) + window_taps(nky) + window_taps(nkx)


class Stencil:
    """The tap triples of one convolution direction.

    ``host`` holds float64 numpy taps (the plain version reads them as
    Python floats); ``host32`` the same as contiguous float32 numpy
    arrays (what ``csrc/rl_pass.cu`` takes by value at each launch);
    ``dev`` holds float32 CUDA tensors for the kernel (None on the CPU).
    ``flip=True`` reverses every tap list: the adjoint ``conv^T``.
    """

    def __init__(self, terms, *, flip: bool = False, device=None):
        self.host = [
            tuple(np.asarray(w, np.float64)[::-1] if flip else np.asarray(w, np.float64)
                  for w in term)
            for term in terms
        ]
        if not self.host:
            raise ValueError("a stencil needs at least one separable term")
        self.radii = tuple(len(w) // 2 for w in self.host[0])
        for term in self.host:
            if tuple(len(w) // 2 for w in term) != self.radii or any(
                len(w) % 2 == 0 for w in term
            ):
                raise ValueError(
                    "separable terms must share odd per-axis lengths "
                    f"(got {[tuple(len(w) for w in t) for t in self.host]})"
                )
        self.host32 = [tuple(np.array(w, np.float32) for w in term) for term in self.host]
        dev = torch.device(device) if device is not None else None
        self.dev = None
        self._packed = None
        if dev is not None and dev.type == "cuda":
            self.dev = [
                tuple(torch.tensor(w.copy(), dtype=torch.float32, device=dev)
                      for w in term)
                for term in self.host
            ]

    def packed_host(self) -> np.ndarray:
        """The taps as ``csrc/rl_half.cu`` and ``csrc/rl_iter.cu`` read
        them: float32 ``(n_terms, term_tap_floats)``, each term ``kz``
        (zeros to a multiple of 4), then ``ky`` and ``kx`` each as a
        :func:`window_taps` list: the taps from index 3, zeros around."""
        lengths = tuple(2 * r + 1 for r in self.radii)
        ky_at = _round4(lengths[0])
        kx_at = ky_at + window_taps(lengths[1])
        packed = np.zeros((len(self.host), term_tap_floats(lengths)), np.float32)
        for t, (wz, wy, wx) in enumerate(self.host):
            packed[t, :lengths[0]] = wz
            packed[t, ky_at + 3:ky_at + 3 + lengths[1]] = wy
            packed[t, kx_at + 3:kx_at + 3 + lengths[2]] = wx
        return packed

    def packed(self) -> torch.Tensor:
        """:meth:`packed_host` on the stencil's CUDA device, made once."""
        if self.dev is None:
            raise ValueError("the stencil has no taps on a CUDA device")
        if self._packed is None:
            self._packed = torch.from_numpy(self.packed_host()).to(self.dev[0][0].device)
        return self._packed


def _conv_axis_plain(v: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """``out[n] = sum_i k[i] v[n + r - i]`` along ``axis``, zero outside."""
    r = len(taps) // 2
    n = v.shape[axis]
    out = torch.zeros_like(v)
    for i, k in enumerate(taps):
        d = r - i  # out[m] += k * v[m + d]
        lo, hi = max(0, -d), min(n, n - d)
        if hi > lo:
            out.narrow(axis, lo, hi - lo).add_(v.narrow(axis, lo + d, hi - lo), alpha=float(k))
    return out


def _conv_axis_circular_plain(v: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """``out[n] = sum_i k[i] v[(n + r - i) mod N]`` along ``axis``: the
    wrap-pad semantics of ``conv3_pallas.py:119``/``:220``. ``r >= N``
    is allowed; taps that land on one offset add up, as in
    ``_circulant``. Each output gets one multiply-add per tap, in tap
    order (``torch.roll`` by ``i - r``, added in place)."""
    r = len(taps) // 2
    out = torch.zeros_like(v)
    for i, k in enumerate(taps):
        out.add_(torch.roll(v, i - r, dims=axis), alpha=float(k))
    return out


def conv3_plain(v: torch.Tensor, stencil: Stencil) -> torch.Tensor:
    """Zero-boundary separable conv3 ``sum_t X_t Y_t Z_t v`` (plain)."""
    acc = None
    for wz, wy, wx in stencil.host:
        w = _conv_axis_plain(v, wz, 0)
        w = _conv_axis_plain(w, wy, 1)
        w = _conv_axis_plain(w, wx, 2)
        acc = w if acc is None else acc.add_(w)
    return acc


def _epilogue(acc: torch.Tensor, aux: torch.Tensor | None, mode: str, eps: float):
    if mode == "ratio":
        return aux / torch.clamp_min(acc, eps)
    if mode == "mult":
        return aux * acc
    return acc


def extrapolate(x: torch.Tensor, dx: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Biggs' extrapolated point ``max(x + alpha * dx, 0)`` in ``x``'s
    dtype: a product and a sum, each rounded (the kernels round alike)."""
    return torch.clamp_min(x + alpha * dx.to(x.dtype), 0.0)


def half_step_plain(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                    dx=None, g_prev=None, alpha=None):
    """One RL half-step in plain PyTorch (any device, any float dtype).

    ``ratio_accel``: ``inp`` is x, ``aux`` data; returns
    ``aux / max(conv(extrapolate(x, dx, alpha)), eps)``.
    ``mult_accel``: ``inp`` is the ratio, ``aux`` is x; returns
    ``(x_new, dx_new, g_new, num, den)`` as new tensors (the kernel
    writes the first three over ``aux``, ``dx`` and ``g_prev``), with
    ``num``/``den`` 0-d sums in ``aux``'s dtype.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    if inp.is_cuda:
        half_step_plain.cuda_calls += 1
    if mode == "ratio_accel":
        return _epilogue(conv3_plain(extrapolate(inp, dx, alpha), stencil), aux, "ratio", eps)
    acc = conv3_plain(inp, stencil)
    if mode != "mult_accel":
        return _epilogue(acc, aux, mode, eps)
    y = extrapolate(aux, dx, alpha)
    x_new = y * acc
    g = (x_new - y).to(g_prev.dtype)
    gf = g.to(aux.dtype)
    num = torch.sum(gf * g_prev.to(aux.dtype))
    den = torch.sum(gf * gf)
    return x_new, (x_new - aux).to(dx.dtype), g, num, den


# Calls of the plain half-step on a CUDA tensor since the last reset:
# the reference path makes them, a kernel path never does.
half_step_plain.cuda_calls = 0


def _check_cuda_operand(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"kernel operand {name} must be a contiguous {dtype} CUDA tensor "
            f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel operand {name} shape {tuple(t.shape)} != {tuple(shape)}")


def _check_distinct(**tensors) -> None:
    ptrs = [t.data_ptr() for t in tensors.values()]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError(f"kernel operands {', '.join(tensors)} must not alias")


def _check_stencil(stencil: Stencil, inp: torch.Tensor) -> None:
    if stencil.dev is None or stencil.dev[0][0].device != inp.device:
        raise ValueError("the stencil has no taps on this CUDA device")


def x_piece(gx: int, rx: int) -> int:
    """Columns of an x row that a block of ``conv_x`` stages with its 2
    ``rx`` halo (``csrc/rl_fused.cu``): the whole row where it fits
    shared memory, else the largest multiple of the block's threads up
    to :data:`_X_PIECE` that fits; 0 when not even one such piece fits.
    A row that fits stays one piece, so its launches and bits do not
    change."""
    if (gx + 2 * rx) * 4 + _X_STATIC_BYTES <= _SMEM_BYTES:
        return gx
    piece = ((_SMEM_BYTES - _X_STATIC_BYTES) // 4 - 2 * rx) // _THREADS_ROW * _THREADS_ROW
    return min(piece, _X_PIECE) if piece >= _THREADS_ROW else 0


def x_blocks(shape, rx: int) -> int:
    """Blocks of the x pass over a (gz, gy, gx) carry: a piece of a row
    each. ``conv_x_accel`` writes one pair of partial sums a block."""
    gz, gy, gx = shape
    return gz * gy * -(-gx // x_piece(gx, rx))


def _x_radius_error(gx: int, rx: int) -> str | None:
    if x_piece(gx, rx) == 0:
        return (f"x radius {rx} exceeds the x pass's shared memory (a piece of "
                f"{_THREADS_ROW} columns and its halo of {2 * rx})")
    return None


def _check_x_radius(gx: int, rx: int) -> None:
    msg = _x_radius_error(gx, rx)
    if msg is not None:
        raise ValueError(msg)


def axis_pass_route(nk: int) -> str:
    """Which kernel runs a z or y pass of an ``nk``-tap list:
    ``"compiled"`` (``csrc/rl_pass.cu::axis_pass_kernel``, built for
    ``nk``) up to :data:`PASS_MAX_TAPS` taps, else ``"runtime"``
    (``csrc/rl_fused.cu::conv_axis_kernel``). The same bits either way."""
    return PASS_ROUTES[0] if nk <= PASS_MAX_TAPS else PASS_ROUTES[1]


def axis_tile(outer: int, n: int, inner: int) -> int:
    """Outputs a thread of the compiled axis pass takes along an axis of
    ``n`` in an (outer, n, inner) view: the whole column where the
    ``outer * inner`` columns give :data:`_AXIS_THREADS` threads (the z
    pass), else enough tiles for that many, of at least
    :data:`_AXIS_MIN_TILE` outputs (each tile reads its 2 r halo again)."""
    tiles = -(-_AXIS_THREADS // max(1, outer * inner))
    return min(n, max(-(-n // tiles), _AXIS_MIN_TILE))


def x_pass_smem_bytes(nk: int, length: int) -> int:
    """Dynamic shared memory of a block of the compiled x pass on a row
    piece of ``length`` columns with an ``nk``-tap list: the piece from
    ``round4(r)`` columns before it, in whole 16-byte chunks up to the last
    window a thread of 4 outputs reads (``shrimpy_rl_pass_smem``)."""
    r = nk // 2
    chunks = (3 + _round4(r) + r) // 4 + 1
    return 16 * (-(-length // _X_ROW_OUT) - 1 + chunks)


def x_pass_route(gx: int, nk: int) -> str:
    """Which kernel runs the x pass of an ``nk``-tap list over rows of
    ``gx``: ``"compiled"`` (``csrc/rl_pass.cu``) up to
    :data:`PASS_MAX_TAPS` taps where its block of :func:`x_piece`'s piece
    fits, else ``"runtime"`` (``csrc/rl_fused.cu::conv_x_kernel``). Both
    take the same pieces (so the same partial sums) and give the same
    bits."""
    piece = x_piece(gx, nk // 2)
    if nk > PASS_MAX_TAPS or piece == 0 \
            or x_pass_smem_bytes(nk, piece) + _X_STATIC_BYTES > _SMEM_BYTES:
        return PASS_ROUTES[1]
    return PASS_ROUTES[0]


def fused_bound_error(shape, radii) -> str | None:
    """Why the ``fused`` backend cannot take a ``shape`` (gz, gy, gx)
    carry with PSF ``radii``, or None when it can: the bound of the
    three-pass kernels (``csrc/rl_fused.cu``), which is the wider of the
    two routes' (the one-launch kernel runs only inside it, see
    :func:`half_step_route`). Radii alone: the z and y passes' column of
    shared memory, and the x pass's piece of a row; any extent runs (an
    entry point launches its grid chunk by chunk where an extent outgrows
    one, and the x pass takes a long row in pieces). One source for
    :func:`half_step_cuda`'s refusal and ``auto``'s choice of backend."""
    r_axis = max(radii[:2])
    if (_TILE_N + 2 * r_axis) * _THREADS_INNER * 4 > _SMEM_BYTES:
        return f"z/y radius {r_axis} exceeds the kernel's shared memory"
    return _x_radius_error(shape[2], radii[2])


def half_slab(tile, radii) -> tuple[int, int]:
    """(rows, columns) of the input slab a ``csrc/rl_half.cu`` block
    keeps of every plane in its ring: the (ty, tx) ``tile`` with its y
    halos, and in x from ``round4(rx)`` before the tile (so that a
    16-byte piece of the slab is one of the grid's) to ``rx`` past it,
    rounded up to whole pieces."""
    (ty, tx), (_, ry, rx) = tile, radii
    return ty + 2 * ry, _round4(_round4(rx) + tx + rx)


def half_smem_bytes(tile, radii, n_terms: int) -> int:
    """Dynamic shared memory of one ``csrc/rl_half.cu`` block on a (ty,
    tx) ``tile``: the packed taps, the ring of ``2 rz + 2`` input slabs
    (the last one in flight), the z pass's plane (one slab more, after
    four guard rows of zeros that the y pass's window may reach), the y
    pass's plane of ty rows of ``tx + round4(2 rx + 4) - 4`` columns
    (what the x pass's windows of whole 16-byte pieces read), and half
    a slab for the bf16 ``dx`` in flight (``ratio_accel``), and 16 bytes
    for the barrier of the bulk copies. The kernel's own sum is
    ``shrimpy_rl_half_smem``."""
    rows, cols = half_slab(tile, radii)
    slab = round_up(rows * cols, 32)  # a slot starts at a multiple of 128 bytes
    taps = round_up(n_terms * term_tap_floats(tuple(2 * r + 1 for r in radii)), 32)
    y_plane = tile[0] * (tile[1] + _round4(2 * radii[2] + 4) - 4)
    return 4 * (taps + (2 * radii[0] + 3) * slab + 4 * cols + y_plane + slab // 2 + 4)


def half_layout(shape, radii, n_terms: int = 1, *, tile=None) -> dict | None:
    """The tile the one-launch half-step kernel runs a (gz, gy, gx) carry
    with, ``{"tile": (ty, tx), "threads": n, "smem_bytes": n, "blocks":
    n}``, or None when none of :data:`HALF_TILES` fits
    (:func:`half_bound_error` says why). ``tile`` forces one."""
    gz, gy, gx = shape
    if gy * gx > _MAX_INT:
        return None
    for cand in ((tuple(tile),) if tile is not None else HALF_TILES):
        ty, tx = cand
        rows, cols = half_slab(cand, radii)
        smem = half_smem_bytes(cand, radii, n_terms)
        if (ty % 4 == 0 and tx % 4 == 0 and smem <= _SMEM_BYTES
                and round_up(rows * cols, 32) // 4 <= _HALF_THREADS * _HALF_CHUNKS
                and rows <= _HALF_BOX and cols <= _HALF_BOX
                and (ty // 4) * (cols // 2) <= _HALF_THREADS
                and ty * (tx // 4) <= _HALF_THREADS
                and -(-gy // ty) <= _MAX_GRID_YZ):
            return {"tile": cand, "threads": _HALF_THREADS, "smem_bytes": smem,
                    "blocks": -(-gy // ty) * -(-gx // tx)}
    return None


def half_bound_error(shape, radii, n_terms: int = 1) -> str | None:
    """Why the one-launch half-step kernel (``csrc/rl_half.cu``) cannot
    take a (gz, gy, gx) carry with PSF ``radii`` in ``n_terms`` terms, or
    None when it can. Geometry alone, the same on every device."""
    if half_layout(shape, radii, n_terms) is not None:
        return None
    gz, gy, gx = shape
    smallest = HALF_TILES[-1]
    if gy * gx > _MAX_INT or -(-gy // smallest[0]) > _MAX_GRID_YZ:
        return (f"carry {tuple(shape)} exceeds the launch grid (a plane of {gy} x {gx} voxels "
                "is indexed in 32 bits)")
    rows, cols = half_slab(smallest, radii)
    return (f"radii {tuple(radii)} exceed the one-launch kernel's block: the ring of its "
            f"smallest tile {smallest} takes {half_smem_bytes(smallest, radii, n_terms)} bytes "
            f"of {_SMEM_BYTES}, a slab {rows * cols // 4} 16-byte pieces of "
            f"{_HALF_THREADS * _HALF_CHUNKS}")


def half_step_route(shape, radii, n_terms: int = 1) -> str:
    """Which kernels run a half-step of the ``fused`` backend on a
    (gz, gy, gx) carry: ``"one_launch"`` (``csrc/rl_half.cu``) where its
    block fits (:func:`half_bound_error`), else ``"three_pass"``
    (``csrc/rl_fused.cu``). Both compute the same function with the same
    bits; the choice reads the shapes and nothing else, so it is the
    same on every device. Raises :class:`ValueError` outside
    :func:`fused_bound_error`, where ``auto`` resolves to ``matmul``."""
    bound = fused_bound_error(shape, radii)
    if bound is not None:
        raise ValueError(f"half_step_cuda: {bound}")
    return ROUTES[0] if half_bound_error(shape, radii, n_terms) is None else ROUTES[1]


def partial_rows(shape, radii, n_terms: int = 1) -> int:
    """Pairs of partial sums a ``mult_accel`` half-step writes: one a
    block on the one-launch route, one a block of the x pass (a piece of
    an x row, :func:`x_blocks`) on the three-pass one."""
    if half_step_route(shape, radii, n_terms) == ROUTES[0]:
        return half_layout(shape, radii, n_terms)["blocks"]
    return x_blocks(shape, radii[2])


def host_taps(taps) -> np.ndarray:
    """A tap list as the contiguous float32 numpy array the compiled
    passes take by value; a CUDA tensor is copied to the host (a
    synchronisation: the RL paths hand over :attr:`Stencil.host32`)."""
    if isinstance(taps, torch.Tensor):
        taps = taps.detach().cpu().numpy()
    return np.array(taps, np.float32)


def axis_pass_cuda(v, out, host, outer: int, n: int, inner: int, *, dx=None, alpha=None,
                   wrap: bool = False) -> None:
    """One z or y pass as a launch of ``csrc/rl_pass.cu::axis_pass_kernel``
    (compiled for the tap count at its first launch with it) over the
    (outer, n, inner) view of ``v`` into ``out``; ``host`` the float32
    taps. Operands are checked by the caller."""
    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    nk = host.size
    check(load_geometry_library("rl_pass", (nk,)).shrimpy_axis_pass(
        v.data_ptr(), out.data_ptr(), host.ctypes.data, nk, outer, n, inner,
        axis_tile(outer, n, inner), dx.data_ptr() if dx is not None else None,
        alpha.data_ptr() if alpha is not None else None, int(wrap),
        torch.cuda.current_stream(v.device).cuda_stream,
    ), "shrimpy_axis_pass")
    axis_pass_cuda.launches += 1


def conv_axis_cuda(v, out, taps: torch.Tensor, host, outer: int, n: int, inner: int, *,
                   dx=None, alpha=None, wrap: bool = False) -> None:
    """``out = A v`` along the middle axis of the (outer, n, inner) view
    (zero outside, or circular when ``wrap``; ``dx``/``alpha``: the
    extrapolated input of ``ratio_accel``), on the kernel of
    :func:`axis_pass_route`. ``taps`` is the list on the card, ``host``
    its float32 host copy (:func:`host_taps` when None). Operands are
    checked by the caller."""
    host = host_taps(taps) if host is None else host
    if axis_pass_route(host.size) == PASS_ROUTES[0]:
        axis_pass_cuda(v, out, host, outer, n, inner, dx=dx, alpha=alpha, wrap=wrap)
        return

    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_conv_axis(
        v.data_ptr(), out.data_ptr(), taps.data_ptr(), taps.numel(), outer, n, inner,
        dx.data_ptr() if dx is not None else None, alpha.data_ptr() if alpha is not None else None,
        int(wrap), torch.cuda.current_stream(v.device).cuda_stream,
    ), "shrimpy_conv_axis")


def x_pass_cuda(src, prev, aux, out, host, mode: str, eps: float, *, wrap: bool = False) -> None:
    """The x pass as a launch of ``csrc/rl_pass.cu::x_pass_kernel``
    (compiled for the tap count): ``out = epilogue(X src + prev)`` as
    :func:`conv_x_cuda`; ``host`` the float32 taps. Operands are checked
    by the caller."""
    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = src.shape
    nk = host.size
    piece = x_piece(gx, nk // 2)
    vec = gx % 4 == 0 and piece % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (prev, aux, out) if t is not None)
    check(load_geometry_library("rl_pass", (nk,)).shrimpy_x_pass(
        src.data_ptr(), prev.data_ptr() if prev is not None else None,
        aux.data_ptr() if aux is not None else None, out.data_ptr(), host.ctypes.data, nk,
        gz * gy, gx, piece, MODES[mode] if aux is not None else 0, float(eps), int(wrap),
        int(vec), torch.cuda.current_stream(src.device).cuda_stream,
    ), "shrimpy_x_pass")
    x_pass_cuda.launches += 1


def conv_x_cuda(src, prev, aux, out, kx: torch.Tensor, mode: str, eps: float, *,
                wrap: bool = False, host=None) -> None:
    """The x pass over the rows of ``src``: ``out = epilogue(X src +
    prev)``, with mode ``plain`` when ``aux`` is None; ``wrap`` makes X
    circular (the row is loaded at ``(x - r) mod gx``) instead of zero
    outside. A block takes a piece of a row (:func:`x_piece`). Runs
    :func:`x_pass_cuda` or ``csrc/rl_fused.cu::conv_x_kernel``, as
    :func:`x_pass_route` chooses; ``host`` is ``kx``'s float32 host copy
    (:func:`host_taps` when None). Operands, and the x radius
    (:func:`_x_radius_error`), are checked by the caller."""
    gz, gy, gx = src.shape
    host = host_taps(kx) if host is None else host
    if x_pass_route(gx, host.size) == PASS_ROUTES[0]:
        x_pass_cuda(src, prev, aux, out, host, mode, eps, wrap=wrap)
        return

    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_conv_x(
        src.data_ptr(), prev.data_ptr() if prev is not None else None,
        aux.data_ptr() if aux is not None else None, out.data_ptr(),
        kx.data_ptr(), kx.numel(), gz * gy, gx, x_piece(gx, kx.numel() // 2),
        MODES[mode] if aux is not None else 0, float(eps), int(wrap),
        torch.cuda.current_stream(src.device).cuda_stream,
    ), "shrimpy_conv_x")


def x_pass_accel_cuda(h, prev, x, dx, g, alpha, partials, host) -> None:
    """The x pass of mode ``mult_accel`` as a launch of
    ``csrc/rl_pass.cu::x_pass_accel_kernel`` (compiled for the tap count),
    as :func:`conv_x_accel_cuda`; ``host`` the float32 taps."""
    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = h.shape
    nk = host.size
    check(load_geometry_library("rl_pass", (nk,)).shrimpy_x_pass_accel(
        h.data_ptr(), prev.data_ptr() if prev is not None else None, x.data_ptr(),
        dx.data_ptr(), g.data_ptr(), alpha.data_ptr(), partials.data_ptr(), host.ctypes.data,
        nk, gz * gy, gx, x_piece(gx, nk // 2), torch.cuda.current_stream(h.device).cuda_stream,
    ), "shrimpy_x_pass_accel")
    x_pass_accel_cuda.launches += 1


def conv_x_accel_cuda(h, prev, x, dx, g, alpha, partials, kx: torch.Tensor, host) -> None:
    """The x pass of mode ``mult_accel`` (the last term's): ``x_new = y *
    (X h + prev)`` over ``x``, ``dx`` and ``g`` with a pair of partial
    sums a block (:func:`x_blocks`), on :func:`x_pass_accel_cuda` or
    ``csrc/rl_fused.cu::conv_x_accel_kernel`` (:func:`x_pass_route`).
    Operands are checked by the caller."""
    gz, gy, gx = h.shape
    if x_pass_route(gx, host.size) == PASS_ROUTES[0]:
        x_pass_accel_cuda(h, prev, x, dx, g, alpha, partials, host)
        return

    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_conv_x_accel(
        h.data_ptr(), prev.data_ptr() if prev is not None else None, x.data_ptr(),
        dx.data_ptr(), g.data_ptr(), alpha.data_ptr(), partials.data_ptr(), kx.data_ptr(),
        kx.numel(), gz * gy, gx, x_piece(gx, kx.numel() // 2),
        torch.cuda.current_stream(h.device).cuda_stream,
    ), "shrimpy_conv_x_accel")


# Launches of the compiled passes (csrc/rl_pass.cu) since the last reset,
# counted where each kernel is launched.
axis_pass_cuda.launches = 0
x_pass_cuda.launches = 0
x_pass_accel_cuda.launches = 0


def check_io_cuda(inp: torch.Tensor, aux: torch.Tensor | None, mode: str, name: str):
    """The carry operands of a CUDA half-step: ``inp`` a 3-D float32
    CUDA tensor, ``aux`` one of its shape unless ``mode`` is ``plain``.
    Returns the shape."""
    if inp.dim() != 3:
        raise ValueError(f"{name} takes a 3-D carry, got {tuple(inp.shape)}")
    shape = tuple(inp.shape)
    _check_cuda_operand("inp", inp, shape)
    if mode != "plain":
        if aux is None:
            raise ValueError(f"mode {mode!r} needs aux")
        _check_cuda_operand("aux", aux, shape)
    return shape


def run_terms_cuda(inp, aux, stencil: Stencil, mode: str, eps: float, zy, n_zy: int, *,
                   out=None, scratch=None, extra=None, x_last=None, wrap: bool = False,
                   count_on=None, name: str) -> torch.Tensor:
    """The term loop of a CUDA half-step, shared by the ``fused``,
    ``linear_pallas`` and ``zy_pallas`` routes (operands checked by
    :func:`check_io_cuda`).

    Per term ``t``, ``zy(inp, t, scratch)`` runs the term's z and y taps
    into its ``n_zy`` scratch carries and returns the last (the others are
    dead once it returns); the x pass (``conv_x``, circular when ``wrap``)
    adds the earlier terms' sum and, on the last term, applies the
    epilogue of ``mode`` into ``out``. With two z+y carries the sum moves
    into the first of them at each middle term (never updated in place).
    ``x_last(h, prev, t)`` replaces that last x pass when given. ``out``
    may be ``aux`` but alias no other operand, nor any of ``extra``
    (name -> tensor). ``scratch`` (``n_zy`` carries, one more with
    several terms) and ``out`` are allocated when not given. ``count_on``
    is a wrapper whose ``launches`` count goes up by one at each x pass
    launched here.
    """
    shape = tuple(inp.shape)
    _check_stencil(stencil, inp)
    _check_x_radius(shape[2], stencil.radii[2])
    n_terms = len(stencil.dev)
    need = n_zy + (n_terms > 1)
    if scratch is None:
        scratch = [torch.empty_like(inp) for _ in range(need)]
    if len(scratch) < need:
        raise ValueError(f"{name}: {n_terms} terms need {need} scratch carries")
    for i, s in enumerate(scratch[:need]):
        _check_cuda_operand(f"scratch[{i}]", s, shape)
    if out is None:
        out = torch.empty_like(inp)
    _check_cuda_operand("out", out, shape)
    _check_distinct(inp=inp, out=out, **{f"scratch[{i}]": s for i, s in enumerate(scratch[:need])},
                    **(extra or {}))
    carries = list(scratch[:need])  # the z+y step's, then the running sum
    for t, (_, _, kx) in enumerate(stencil.dev):
        h = zy(inp, t, carries[:n_zy])
        last = t == n_terms - 1
        prev = carries[n_zy] if t > 0 else None
        target = out if last else carries[n_zy]
        if not last and prev is not None and n_zy > 1:
            # The first z+y carry is dead once the step has returned: the
            # sum goes there, and the carry it leaves takes the next term's
            # z pass (adding in place ran the x pass ~15 % slower at config
            # 2's grid on an H100, profile_step.py --config2).
            target = carries[0]
            carries[0], carries[n_zy] = carries[n_zy], target
        if last and x_last is not None:
            x_last(h, prev, t)
        else:
            conv_x_cuda(h, prev, aux if last and mode != "plain" else None, target, kx, mode,
                        eps, wrap=wrap, host=stencil.host32[t][2])
            if count_on is not None:
                count_on.launches += 1
    return out


def _check_half_io(inp, aux, mode: str):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    return check_io_cuda(inp, aux, mode, "half_step_cuda")


def _check_accel(inp, aux, shape, mode: str, out, dx, g_prev, alpha, partials, n_partials: int):
    """The accelerated modes' operands, alike on both routes of a CUDA
    half-step. Returns ``(out, partials, extra)``: for ``mult_accel``
    ``out`` is ``aux`` and ``partials`` is allocated as (2,
    ``n_partials``) when not given; ``extra`` names the tensors that
    must alias no carry."""
    extra = {}
    if mode in ACCEL_MODES:
        if dx is None or alpha is None or (mode == "mult_accel" and g_prev is None):
            raise ValueError(f"mode {mode!r} needs dx, alpha" +
                             (" and g_prev" if mode == "mult_accel" else ""))
        _check_cuda_operand("dx", dx, shape, torch.bfloat16)
        if not alpha.is_cuda or alpha.dtype != torch.float32 or alpha.numel() != 1 \
                or alpha.device != inp.device:
            raise ValueError("half_step_cuda: alpha must be a float32 CUDA scalar on the carry's device")
        extra["dx"] = dx
    if mode == "mult_accel":
        _check_cuda_operand("g_prev", g_prev, shape, torch.bfloat16)
        if out is not None and out.data_ptr() != aux.data_ptr():
            raise ValueError("half_step_cuda: mult_accel writes x_new over aux (out must be aux)")
        out = aux
        if partials is None:
            partials = torch.empty((2, n_partials), dtype=torch.float32, device=inp.device)
        _check_cuda_operand("partials", partials, (2, n_partials))
        extra.update(g_prev=g_prev, partials=partials)
    return out, partials, extra


def _half_step_result(mode: str, out, aux, dx, g_prev, partials):
    if mode == "mult_accel":
        sums = partials.sum(dim=1)
        return aux, dx, g_prev, sums[0], sums[1]
    return out


def half_step_one_launch(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                         out=None, dx=None, g_prev=None, alpha=None, partials=None, tile=None):
    """One RL half-step as one launch of ``csrc/rl_half.cu``, which is
    compiled for the stencil's lengths and the tile at the first call
    with them (``kernels/build.py::load_geometry_library``). Operands and
    result as :func:`half_step_cuda`; ``partials`` holds one pair a
    block. ``tile`` takes a (ty, tx) other than :func:`half_layout`'s
    choice. Raises :class:`ValueError` past :func:`half_bound_error`."""
    shape = _check_half_io(inp, aux, mode)
    n_terms = len(stencil.host)
    layout = half_layout(shape, stencil.radii, n_terms, tile=tile)
    if layout is None:
        raise ValueError("half_step_cuda: " + (
            half_bound_error(shape, stencil.radii, n_terms)
            or f"tile {tuple(tile)} does not fit the one-launch kernel's block"))
    out, partials, extra = _check_accel(inp, aux, shape, mode, out, dx, g_prev, alpha, partials,
                                        layout["blocks"])
    _check_stencil(stencil, inp)
    if out is None:
        out = torch.empty_like(inp)
    _check_cuda_operand("out", out, shape)
    _check_distinct(inp=inp, out=out, **extra)

    from shrimpy_tpu_torch.kernels.build import check, load_geometry_library

    gz, gy, gx = shape
    carries = [t for t in (inp, aux, out, dx, g_prev) if t is not None]
    vec = gx % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in carries)
    geometry = (n_terms, *(2 * r + 1 for r in stencil.radii), *layout["tile"])
    kernel_mode = {"ratio_accel": 3, "mult_accel": 4}.get(mode, MODES[mode])

    def ptr(t):
        return t.data_ptr() if t is not None else None

    check(load_geometry_library("rl_half", geometry).shrimpy_rl_half(
        inp.data_ptr(), ptr(aux), out.data_ptr(), ptr(dx), ptr(g_prev), ptr(alpha),
        ptr(partials), stencil.packed().data_ptr(), *geometry[:4], gz, gy, gx, *geometry[4:],
        kernel_mode, int(vec), float(eps), torch.cuda.current_stream(inp.device).cuda_stream,
    ), "shrimpy_rl_half")
    half_step_one_launch.launches += 1
    return _half_step_result(mode, out, aux, dx, g_prev, partials)


def half_step_three_pass(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                         out=None, scratch=None, dx=None, g_prev=None, alpha=None,
                         partials=None):
    """One RL half-step as three launches a term: a z pass and a y pass
    into ``scratch`` (2 carries, 3 with more than one term; allocated
    when not given), then the x pass, which adds the earlier terms'
    partial sum and applies the epilogue; each pass on the kernel of
    :func:`axis_pass_route` / :func:`x_pass_route` (``csrc/rl_pass.cu``
    compiled for the term's tap lengths, or ``csrc/rl_fused.cu``).
    Operands and result as :func:`half_step_cuda`; ``partials`` holds one
    pair a block of the x pass (:func:`x_blocks`).
    Raises :class:`ValueError` past :func:`fused_bound_error`."""
    shape = _check_half_io(inp, aux, mode)
    gz, gy, gx = shape
    bound = fused_bound_error(shape, stencil.radii)
    if bound is not None:
        raise ValueError(f"half_step_cuda: {bound}")
    out, partials, extra = _check_accel(inp, aux, shape, mode, out, dx, g_prev, alpha, partials,
                                        x_blocks(shape, stencil.radii[2]))

    accel = {"dx": dx, "alpha": alpha} if mode == "ratio_accel" else {}

    def zy(v, t, scratch):
        (kz, ky, _), (hz, hy, _) = stencil.dev[t], stencil.host32[t]
        s1, s2 = scratch
        conv_axis_cuda(v, s1, kz, hz, 1, gz, gy * gx, **accel)
        half_step_three_pass.launches += 1
        conv_axis_cuda(s1, s2, ky, hy, gz, gy, gx)
        half_step_three_pass.launches += 1
        return s2

    def x_accel(h, prev, t):
        conv_x_accel_cuda(h, prev, aux, dx, g_prev, alpha, partials, stencil.dev[t][2],
                          stencil.host32[t][2])
        half_step_three_pass.launches += 1

    out = run_terms_cuda(inp, aux, stencil, mode, eps, zy, 2, out=out, scratch=scratch,
                         extra=extra, x_last=x_accel if mode == "mult_accel" else None,
                         count_on=half_step_three_pass, name="half_step_cuda")
    return _half_step_result(mode, out, aux, dx, g_prev, partials)


# Kernel launches of each route since the last reset, counted where the
# kernel is launched: one a half-step, three a term.
half_step_one_launch.launches = 0
half_step_three_pass.launches = 0


def half_step_cuda(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
                   out=None, scratch=None, dx=None, g_prev=None, alpha=None, partials=None):
    """One RL half-step on the card: :func:`half_step_one_launch` where
    the geometry allows, else :func:`half_step_three_pass`
    (:func:`half_step_route` chooses from the shapes alone). A kernel
    that cannot take the operands raises; nothing here reaches the plain
    version.

    ``inp`` and ``aux`` are (gz, gy, gx) float32 CUDA tensors; ``out``
    may be ``aux`` (the in-place mult update) but not ``inp``.
    ``scratch`` is the three-pass route's; the one-launch route needs
    none.

    Accelerated modes take ``dx`` (bf16 carry) and ``alpha`` (a float32
    CUDA scalar, read by the kernels, never by the host).
    ``ratio_accel`` returns ``out``. ``mult_accel`` also takes ``g_prev``
    (bf16) and ``partials`` (float32 (2, :func:`partial_rows`), allocated
    when not given), writes ``x_new`` over ``aux``, ``dx_new`` over
    ``dx`` and ``g`` over ``g_prev``, and returns ``(aux, dx, g_prev,
    num, den)`` with ``num``/``den`` 0-d float32 CUDA tensors summed
    from the partials (one pair a block of either route's last kernel)
    by ``torch.sum``.
    """
    shape = _check_half_io(inp, aux, mode)
    accel = {"dx": dx, "g_prev": g_prev, "alpha": alpha, "partials": partials}
    if half_step_route(shape, stencil.radii, len(stencil.host)) == ROUTES[0]:
        res = half_step_one_launch(inp, aux, stencil, mode, eps, out=out, **accel)
    else:
        res = half_step_three_pass(inp, aux, stencil, mode, eps, out=out, scratch=scratch,
                                   **accel)
    if mode in ACCEL_MODES:
        half_step_cuda.accel_launches += 1
    else:
        half_step_cuda.launches += 1
    return res


# Half-steps since the last reset (chip_smoke.py reads and resets them):
# in modes ratio/mult/plain (``launches``) and ratio_accel/mult_accel
# (``accel_launches``).
half_step_cuda.launches = 0
half_step_cuda.accel_launches = 0


def half_step(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
              out=None, scratch=None, partials=None, **accel):
    """RL half-step: the CUDA kernels for a CUDA tensor, the plain
    version for a CPU tensor (``out``/``scratch``/``partials`` belong to
    the kernels and are unused there). ``accel``: ``dx``, ``g_prev``,
    ``alpha`` of the accelerated modes."""
    if inp.is_cuda:
        return half_step_cuda(inp, aux, stencil, mode, eps, out=out, scratch=scratch,
                              partials=partials, **accel)
    return half_step_plain(inp, aux, stencil, mode, eps, **accel)


def pad_to_grid(image: torch.Tensor, pads, pad_mode: str) -> torch.Tensor:
    """The grid: ``image`` padded by ``pads``, one ``(lo, hi)`` pair per
    axis (asymmetric on the ``matmul`` backend's block-rounded axes),
    with ``pad_mode``.

    ``reflect`` and ``edge`` gather with the indices ``np.pad`` gives
    ``arange(n)``, so a pad longer than its axis reflects again as in
    numpy (``F.pad`` refuses it); ``constant`` pads zeros.
    """
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} not in {PAD_MODES}")
    if pad_mode == "constant":
        (zl, zh), (yl, yh), (xl, xh) = pads
        return F.pad(image, (xl, xh, yl, yh, zl, zh))
    out = image
    for axis, pad in enumerate(pads):
        if any(pad):
            idx = np.pad(np.arange(image.shape[axis]), pad, mode=pad_mode)
            out = out.index_select(axis, torch.from_numpy(idx).to(image.device))
    return out


def consume(image: torch.Tensor) -> None:
    """Take a donated tensor: it is left empty (shape ``(0,)``), and its
    memory returns to the allocator unless a view of the caller's still
    holds it."""
    image.set_(torch.empty(0, dtype=image.dtype, device=image.device))


def grid_start(image: torch.Tensor, pads, settings, dtype: torch.dtype, *,
               donate: bool = False):
    """``data = max(g, 0)`` and ``est = max(g, eps)`` in ``dtype`` on the
    grid ``g`` of ``image`` padded by ``pads`` (what every RL backend
    iterates from). ``donate`` consumes ``image`` once both exist (the
    ``donate_input`` setting: the image is dead from here on, and its
    volume is free for the iterations); read its shape before."""
    g = pad_to_grid(image.to(dtype), pads, settings.pad_mode)
    # Not in place: with zero pads g is the caller's image itself.
    data, est = torch.clamp_min(g, 0.0), torch.clamp_min(g, float(settings.epsilon))
    if donate:
        del g
        consume(image)
    return data, est


def start_on_grid(image: torch.Tensor, psf_np, terms, settings, dtype: torch.dtype, *,
                  donate: bool = False):
    """What the stencil backends start from: the stencils of ``terms``
    (conv and adjoint) on the image's device, and :func:`grid_start` on
    the G grid (the image padded by the PSF radii; ``donate`` as there)."""
    radii = tuple(k // 2 for k in psf_np.shape)
    conv = Stencil(terms, device=image.device)
    adj = Stencil(terms, flip=True, device=image.device)
    if conv.radii != radii:
        raise ValueError(f"term radii {conv.radii} do not match the PSF radii {radii}")
    return (conv, adj,
            *grid_start(image, tuple((r, r) for r in radii), settings, dtype, donate=donate))


def crop_grid(est: torch.Tensor, shape, lo) -> torch.Tensor:
    """The image's (Z, Y, X) ``shape`` cut from the grid, starting at the
    low pads ``lo`` (the radii on the G grid): the span ``shrimpy.rl.crop``."""
    with span("shrimpy.rl.crop"):
        return est[tuple(slice(a, a + n) for a, n in zip(lo, shape))].contiguous()


def rl_fused(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
             plain: bool = False, dtype: torch.dtype = torch.float32,
             donate: bool = False) -> torch.Tensor:
    """Zero-boundary separable RL of a (Z, Y, X) ``image`` on its device.

    ``terms`` are (wz, wy, wx) tap triples as ``plan_separable_terms``
    returns them; ``psf_np`` (already cropped and odd) fixes the radii.
    ``plain=True`` runs :func:`half_step_plain` on any device in
    ``dtype`` (the reference path); otherwise :func:`half_step`.
    ``settings.acceleration == "biggs"`` runs the in-kernel Biggs body.
    Memory: data, est and ratio carries (past the one-launch kernel's
    bound also the three-pass route's 2-3 scratch carries); the mult
    half-step updates est in place (with Biggs also dx and g_prev, two
    bf16 carries). ``donate`` consumes ``image`` once the carries exist
    (see :func:`grid_start`).
    """
    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    step = half_step_plain if plain else half_step
    biggs = settings.acceleration == "biggs"
    bufs, ratio_buf = {}, None  # the kernels' buffers, allocated once per run
    with span("shrimpy.rl.start"):
        conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype,
                                             donate=donate)
        del image
        kernel = not plain and est.is_cuda
        if kernel:
            ratio_buf = torch.empty_like(est)
            if half_step_route(est.shape, conv.radii, len(terms)) == "three_pass":
                bufs["scratch"] = [torch.empty_like(est)
                                   for _ in range(2 if len(terms) == 1 else 3)]
            if biggs:
                bufs["partials"] = torch.empty(
                    (2, partial_rows(est.shape, conv.radii, len(terms))),
                    dtype=torch.float32, device=est.device)
        if biggs:
            # Biggs-Andrews in the half-steps (rl_outer.py has the
            # algorithm): alpha, num and den never leave the device.
            dx, g_prev, den_prev, alpha = biggs_state(est)

    def hs(inp, aux, st, mode, out=None, **kw):
        if kernel:
            kw.update(bufs, out=out)
        return step(inp, aux, st, mode, eps, **kw)

    if biggs:
        for _ in range(iterations):
            with span("shrimpy.rl.iteration"):
                ratio = hs(est, data, conv, "ratio_accel", out=ratio_buf, dx=dx, alpha=alpha)
                est, dx, g_prev, num, den = hs(ratio, est, adj, "mult_accel",
                                               dx=dx, g_prev=g_prev, alpha=alpha)
                del ratio
                alpha = next_alpha(num, den_prev)
                den_prev = den.float()
        del dx, g_prev
    else:
        for _ in range(iterations):
            with span("shrimpy.rl.iteration"):
                ratio = hs(est, data, conv, "ratio", out=ratio_buf)
                est = hs(ratio, est, adj, "mult", out=est)
                del ratio
    del data, bufs, ratio_buf
    return crop_grid(est, shape, conv.radii)
