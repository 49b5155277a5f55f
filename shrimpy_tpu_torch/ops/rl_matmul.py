"""The circulant ``matmul`` RL backend (counterpart of the matmul part of
``shrimpy_tpu/ops/deconv.py``: ``_sep_pads``, ``_sep_matrices``,
``_apply_axis``, ``_rl_sep_jit``).

Circular separable RL on a grid padded by the half-PSF, where an axis
past ``_DENSE_MAX`` is rounded up to ``_BLOCK`` rows (the extra rows are
padded with ``pad_mode`` too, split around the image, and cropped at the
end). Each axis of each term is one matrix: a dense ``N x N`` circulant,
or on a block-rounded axis the ``(B, 3B)`` banded stencil applied block
by block (:func:`apply_axis`). The update is the JAX one,
``est * conv^T(data / max(conv(est), eps))``, with ``conv = sum_t
Z_t X_t Y_t`` applied y, then x, then z, iterated by
:func:`~shrimpy_tpu_torch.ops.rl_outer.run_rl_outer` (Biggs there when
``acceleration: biggs``). Oracle: ``richardson_lucy_reference_separable``
with its default pads.

The JAX package computes these products in XLA, outside any Pallas
kernel, so the port leaves them to ``torch.matmul`` too: this backend
launches no kernel of the repository. Precision: ``matmul_precision``
(``default``, ``high``, ``highest``) picks bf16 MXU passes on the TPU;
here all three mean one float32 product with TF32 off (float64 for the
reference). TF32 has not been measured against the 1e-3 budget, so
:func:`rl_matmul` raises while ``torch.backends.cuda.matmul.allow_tf32``
is on.

The host helpers are copies of the JAX ones (which import jax),
``tests/test_torch_matmul.py`` pins each to its original; they build in
float64, and the operators are cast to the run's dtype on its device,
cached per (terms, grid, radii, device, dtype) like JAX's
``_sep_matrices_device`` (LRU, 8 entries).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch

from shrimpy_tpu_torch.ops.conv3_cuda import circulant
from shrimpy_tpu_torch.ops.rl_fused import crop_grid, grid_start
from shrimpy_tpu_torch.ops.rl_outer import run_rl_outer
from shrimpy_tpu_torch.utils.timing import span

# Block size of the banded scheme and the axis length past which an axis
# is banded (deconv.py:895-896, measured on the TPU's MXU).
_BLOCK = 128
_DENSE_MAX = 1536
PRECISIONS = ("default", "high", "highest")


def _banded_stencil(taps, block: int | None = None) -> np.ndarray:
    """(B, 3B) stencil: out block = T @ [prev; cur; next] input blocks,
    the circulant's rows restricted to one block (taps <= 2B + 1)."""
    block = block or _BLOCK
    taps = np.asarray(taps, np.float64)
    r = len(taps) // 2
    if r > block:
        raise ValueError(f"PSF band {r} exceeds one block of {block}")
    t = np.zeros((block, 3 * block), np.float64)
    rows = np.arange(block)
    for i, k in enumerate(taps):
        t[rows, block + rows - (i - r)] += k
    return t


def _axis_is_banded(n: int, radius: int = 0) -> bool:
    """Banded past ``_DENSE_MAX`` when the band fits one block."""
    return n > _DENSE_MAX and radius <= _BLOCK


def _sep_pads(image_shape, psf_shape) -> tuple[tuple[int, int], ...]:
    """Half-PSF pads per axis; banded axes round the grid up to a block
    multiple, the extra split low/high (low gets the smaller half)."""
    pads = []
    for n, k in zip(image_shape, psf_shape):
        half = k // 2
        base = n + 2 * half
        if _axis_is_banded(base, half):
            extra = -(-base // _BLOCK) * _BLOCK - base
            pads.append((half + extra // 2, half + extra - extra // 2))
        else:
            pads.append((half, half))
    return tuple(pads)


def _sep_matrices(terms, grid, radii) -> tuple[np.ndarray, ...]:
    """Per-axis operator stacks ``(cz, cy, cx, tz, ty, tx)`` of conv and
    its adjoint, float64: (K, N, N) circulants on dense axes, (K, B, 3B)
    stencils on banded ones."""
    conv, corr = [], []
    for axis in range(3):
        n = grid[axis]
        taps = [np.asarray(t[axis]) for t in terms]
        if _axis_is_banded(n, radii[axis]):
            if n % _BLOCK:
                raise ValueError(f"banded axis {n} must be a multiple of {_BLOCK}")
            conv.append(np.stack([_banded_stencil(w) for w in taps]))
            corr.append(np.stack([_banded_stencil(w[::-1]) for w in taps]))
        else:
            conv.append(np.stack([circulant(n, w) for w in taps]))
            corr.append(np.stack([circulant(n, w[::-1]) for w in taps]))
    return (*conv, *corr)


def _contract(mat: torch.Tensor, t: torch.Tensor, dim: int) -> torch.Tensor:
    """``out[.., a, ..] = sum_b mat[a, b] t[.., b, ..]`` along ``dim``, as
    one (batched) matrix product over a view of ``t``."""
    shape = t.shape
    if dim == t.dim() - 1:
        return torch.matmul(t, mat.T)
    outer, inner = math.prod(shape[:dim]), math.prod(shape[dim + 1:])
    t3 = t.reshape(outer, shape[dim], inner)
    out = torch.bmm(mat.expand(outer, *mat.shape), t3)
    return out.reshape(*shape[:dim], mat.shape[0], *shape[dim + 1:])


def apply_axis(v: torch.Tensor, mat: torch.Tensor, axis: int, radius: int = 0) -> torch.Tensor:
    """Circular conv of ``v`` along ``axis`` by ``mat``: a dense ``N x N``
    circulant, or a ``(B, 3B)`` banded stencil (counterpart of
    ``_apply_axis``).

    Banded: the axis is split in place into (nb, B) blocks; the middle
    ``(B, B)`` piece is one batched product, and the neighbour pieces
    ``t_prev`` (previous block's last ``r`` rows) and ``t_next`` (next
    block's first ``r``) multiply the block tails and heads rolled by one
    block. ``r`` is ``radius`` (a full block when 0). Only the first /
    last ``r`` rows of ``t_prev`` / ``t_next`` can be non-zero, so only
    those output rows are computed: the other rows of JAX's product are
    exact zeros.
    """
    n = v.shape[axis]
    if mat.dim() == 2 and mat.shape[0] == mat.shape[1] == n:
        return _contract(mat, v, axis)
    block = mat.shape[0]
    r = radius or block
    blocks = v.reshape(*v.shape[:axis], n // block, block, *v.shape[axis + 1:])
    b_axis = axis + 1
    out = _contract(mat[:, block: 2 * block], blocks, b_axis)
    tails = torch.roll(blocks.narrow(b_axis, block - r, r), 1, dims=axis)
    out.narrow(b_axis, 0, r).add_(_contract(mat[:r, block - r: block], tails, b_axis))
    heads = torch.roll(blocks.narrow(b_axis, 0, r), -1, dims=axis)
    out.narrow(b_axis, block - r, r).add_(
        _contract(mat[block - r:, 2 * block: 2 * block + r], heads, b_axis))
    return out.reshape(v.shape)


def conv3_matmul(v: torch.Tensor, mats, radii) -> torch.Tensor:
    """``sum_t Z_t X_t Y_t v`` with ``mats = (az, ay, ax)`` stacks, each
    term y, then x, then z, as ``_rl_sep_jit``'s ``conv3``."""
    az, ay, ax = mats
    acc = None
    for i in range(az.shape[0]):
        w = apply_axis(v, ay[i], 1, radii[1])
        w = apply_axis(w, ax[i], 2, radii[2])
        w = apply_axis(w, az[i], 0, radii[0])
        acc = w if acc is None else acc.add_(w)
    return acc


_OPERATORS: OrderedDict = OrderedDict()
_OPERATORS_MAX = 8


def sep_operators(terms, grid, radii, device, dtype) -> tuple[torch.Tensor, ...]:
    """``_sep_matrices`` as ``dtype`` tensors on ``device``, cached per
    (terms, grid, radii, device, dtype), least recently used dropped
    past 8 entries."""
    key = (tuple(tuple(np.asarray(w, np.float64).tobytes() for w in t) for t in terms),
           tuple(grid), tuple(radii), str(torch.device(device)), dtype)
    if key in _OPERATORS:
        _OPERATORS.move_to_end(key)
    else:
        _OPERATORS[key] = tuple(torch.from_numpy(m).to(device, dtype)
                                for m in _sep_matrices(terms, grid, radii))
        if len(_OPERATORS) > _OPERATORS_MAX:
            _OPERATORS.popitem(last=False)
    return _OPERATORS[key]


def rl_matmul(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
              dtype: torch.dtype = torch.float32, donate: bool = False) -> torch.Tensor:
    """``matmul`` RL of a (Z, Y, X) ``image`` on its device, in ``dtype``
    (float32 on the card; float64 is the reference). Memory: data and
    est plus, inside a convolution, the input and two carries per axis
    product; the ratio overwrites the forward convolution and the update
    est in place. ``donate`` consumes ``image`` once data and est exist.
    """
    if settings.matmul_precision not in PRECISIONS:
        raise ValueError(f"matmul_precision {settings.matmul_precision!r} not in {PRECISIONS}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "separable_backend 'matmul' runs float32 products with TF32 off: TF32 is not "
            "measured against the 1e-3 budget; set torch.backends.cuda.matmul.allow_tf32 = False")
    shape = tuple(image.shape)
    pads = _sep_pads(shape, psf_np.shape)
    grid = tuple(n + lo + hi for n, (lo, hi) in zip(shape, pads))
    radii = tuple(k // 2 for k in psf_np.shape)
    eps = float(settings.epsilon)
    with span("shrimpy.rl.start"):
        mats = sep_operators(terms, grid, radii, image.device, dtype)
        fwd, adj = mats[:3], mats[3:]
        data, est = grid_start(image, pads, settings, dtype, donate=donate)
        del image

    def step(v: torch.Tensor) -> torch.Tensor:
        # Updates v in place: run_rl_outer never reads it again.
        conv = conv3_matmul(v, fwd, radii)
        ratio = torch.div(data, conv.clamp_min_(eps), out=conv)
        return v.mul_(conv3_matmul(ratio, adj, radii))

    est = run_rl_outer([(step, iterations)], est, settings.acceleration == "biggs")
    return crop_grid(est, shape, [lo for lo, _ in pads])
