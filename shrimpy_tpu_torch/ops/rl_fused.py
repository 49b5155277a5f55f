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
not ported: the CUDA kernel works on the exact G grid in float32 FMA, so
the JAX kernel's limits (``rz <= bz``, ``ry <= 120``, ``rx <= 128``) do
not apply; the kernel raises on what it cannot take (shared-memory
bounds in :func:`half_step_cuda`).

:func:`half_step` dispatches on the device: :func:`half_step_plain`
(shifted-slice FMAs; any float dtype, so also the float64 reference) for
a CPU tensor, :func:`half_step_cuda` (``csrc/rl_fused.cu``) for a CUDA
tensor. The plain version does not use ``F.conv1d``: cuDNN runs float32
convolutions as TF32 by default, and it must also run in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from shrimpy_tpu_torch.utils.shapes import round_up

MODES = {"plain": 0, "ratio": 1, "mult": 2}
PAD_MODES = ("reflect", "edge", "constant")

# Shared-memory ceiling of one block (H100: 227 KB opt-in) and the tile
# constants of csrc/rl_fused.cu, which bound the radii the kernel takes.
_SMEM_BYTES = 232448
_TILE_N = 32
_THREADS_INNER = 128
_MAX_GRID_YZ = 65535


class Stencil:
    """The tap triples of one convolution direction.

    ``host`` holds float64 numpy taps (the plain version reads them as
    Python floats); ``dev`` holds float32 CUDA tensors for the kernel
    (None on the CPU). ``flip=True`` reverses every tap list: the
    adjoint ``conv^T``.
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
        dev = torch.device(device) if device is not None else None
        self.dev = None
        if dev is not None and dev.type == "cuda":
            self.dev = [
                tuple(torch.tensor(w.copy(), dtype=torch.float32, device=dev)
                      for w in term)
                for term in self.host
            ]


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


def half_step_plain(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6):
    """One RL half-step in plain PyTorch (any device, any float dtype)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    return _epilogue(conv3_plain(inp, stencil), aux, mode, eps)


def _check_cuda_operand(name: str, t: torch.Tensor, shape) -> None:
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(
            f"half_step_cuda: {name} must be a contiguous float32 CUDA tensor "
            f"(got {t.dtype} on {t.device}, contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"half_step_cuda: {name} shape {tuple(t.shape)} != {tuple(shape)}")


def half_step_cuda(
    inp: torch.Tensor,
    aux: torch.Tensor | None,
    stencil: Stencil,
    mode: str,
    eps: float = 1e-6,
    *,
    out: torch.Tensor | None = None,
    scratch: list[torch.Tensor] | None = None,
) -> torch.Tensor:
    """One RL half-step with the CUDA kernels of ``csrc/rl_fused.cu``.

    ``inp`` and ``aux`` are (gz, gy, gx) float32 CUDA tensors; ``out``
    may be ``aux`` (the in-place mult update) but not ``inp``.
    ``scratch`` (2 carries, 3 with more than one term) is allocated when
    not given. Per term: z pass and y pass into scratch, then the x pass
    adds the earlier terms' partial sum and applies the epilogue.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    if inp.dim() != 3:
        raise ValueError(f"half_step_cuda takes a 3-D carry, got {tuple(inp.shape)}")
    shape = tuple(inp.shape)
    gz, gy, gx = shape
    _check_cuda_operand("inp", inp, shape)
    if mode != "plain":
        if aux is None:
            raise ValueError(f"mode {mode!r} needs aux")
        _check_cuda_operand("aux", aux, shape)
    if stencil.dev is None or stencil.dev[0][0].device != inp.device:
        raise ValueError("half_step_cuda: the stencil has no taps on this CUDA device")
    rz, ry, rx = stencil.radii
    r_axis = max(rz, ry)
    if (_TILE_N + 2 * r_axis) * _THREADS_INNER * 4 > _SMEM_BYTES:
        raise ValueError(f"half_step_cuda: z/y radius {r_axis} exceeds the kernel's shared memory")
    if (gx + 2 * rx) * 4 > _SMEM_BYTES:
        raise ValueError(f"half_step_cuda: x row {gx} + 2*{rx} exceeds the kernel's shared memory")
    if gz > _MAX_GRID_YZ or round_up(gy, _TILE_N) // _TILE_N > _MAX_GRID_YZ:
        raise ValueError(f"half_step_cuda: carry {shape} exceeds the launch grid")
    n_terms = len(stencil.dev)
    need = 2 if n_terms == 1 else 3
    if scratch is None:
        scratch = [torch.empty_like(inp) for _ in range(need)]
    if len(scratch) < need:
        raise ValueError(f"half_step_cuda: {n_terms} terms need {need} scratch carries")
    for i, s in enumerate(scratch[:need]):
        _check_cuda_operand(f"scratch[{i}]", s, shape)
    if out is None:
        out = torch.empty_like(inp)
    _check_cuda_operand("out", out, shape)
    busy = [inp.data_ptr()] + [s.data_ptr() for s in scratch[:need]]
    if out.data_ptr() in busy or len(set(busy)) != len(busy):
        raise ValueError("half_step_cuda: out, inp and scratch must not alias")

    from shrimpy_tpu_torch.kernels.build import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream(inp.device).cuda_stream
    s1, s2 = scratch[0], scratch[1]
    acc = scratch[2] if n_terms > 1 else None
    aux_ptr = aux.data_ptr() if aux is not None else None
    for t, (kz, ky, kx) in enumerate(stencil.dev):
        check(lib.shrimpy_conv_axis(inp.data_ptr(), s1.data_ptr(), kz.data_ptr(),
                                    kz.numel(), 1, gz, gy * gx, stream), "shrimpy_conv_axis(z)")
        check(lib.shrimpy_conv_axis(s1.data_ptr(), s2.data_ptr(), ky.data_ptr(),
                                    ky.numel(), gz, gy, gx, stream), "shrimpy_conv_axis(y)")
        last = t == n_terms - 1
        prev = acc.data_ptr() if t > 0 else None
        check(lib.shrimpy_conv_x(
            s2.data_ptr(), prev, aux_ptr if last else None,
            out.data_ptr() if last else acc.data_ptr(), kx.data_ptr(), kx.numel(),
            gz * gy, gx, MODES[mode] if last else 0, float(eps), stream,
        ), "shrimpy_conv_x")
    half_step_cuda.launches += 1
    return out


# Half-steps launched since the last reset (chip_smoke.py reads and
# resets it); each is 3 kernel launches per separable term.
half_step_cuda.launches = 0


def half_step(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
              out=None, scratch=None) -> torch.Tensor:
    """RL half-step: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (``out``/``scratch`` are kernel buffers
    and unused there)."""
    if inp.is_cuda:
        return half_step_cuda(inp, aux, stencil, mode, eps, out=out, scratch=scratch)
    return half_step_plain(inp, aux, stencil, mode, eps)


def pad_to_grid(image: torch.Tensor, radii, pad_mode: str) -> torch.Tensor:
    """The G grid: ``image`` padded by ``radii`` with ``pad_mode``.

    ``reflect`` and ``edge`` gather with the indices ``np.pad`` gives
    ``arange(n)``, so a pad longer than its axis reflects again as in
    numpy (``F.pad`` refuses it); ``constant`` pads zeros.
    """
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} not in {PAD_MODES}")
    if pad_mode == "constant":
        rz, ry, rx = radii
        return F.pad(image, (rx, rx, ry, ry, rz, rz))
    out = image
    for axis, r in enumerate(radii):
        if r:
            idx = np.pad(np.arange(image.shape[axis]), r, mode=pad_mode)
            out = out.index_select(axis, torch.from_numpy(idx).to(image.device))
    return out


def rl_fused(image: torch.Tensor, psf_np, terms, settings, iterations: int, *,
             plain: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Zero-boundary separable RL of a (Z, Y, X) ``image`` on its device.

    ``terms`` are (wz, wy, wx) tap triples as ``plan_separable_terms``
    returns them; ``psf_np`` (already cropped and odd) fixes the radii.
    ``plain=True`` runs :func:`half_step_plain` on any device in
    ``dtype`` (the reference path); otherwise :func:`half_step`.
    Memory: data, est and ratio carries plus the kernel's 2-3 scratch
    carries; the mult half-step updates est in place.
    """
    radii = tuple(k // 2 for k in psf_np.shape)
    eps = float(settings.epsilon)
    conv = Stencil(terms, device=image.device)
    adj = Stencil(terms, flip=True, device=image.device)
    if conv.radii != radii:
        raise ValueError(f"term radii {conv.radii} do not match the PSF radii {radii}")
    g = pad_to_grid(image.to(dtype), radii, settings.pad_mode)
    data = torch.clamp_min(g, 0.0)
    # Not in place: with zero radii g is the caller's image itself.
    est = torch.clamp_min(g, eps)
    del g
    if plain:
        for _ in range(iterations):
            ratio = half_step_plain(est, data, conv, "ratio", eps)
            est = half_step_plain(ratio, est, adj, "mult", eps)
            del ratio
    else:
        ratio = torch.empty_like(est) if est.is_cuda else None
        scratch = (
            [torch.empty_like(est) for _ in range(2 if len(terms) == 1 else 3)]
            if est.is_cuda else None
        )
        for _ in range(iterations):
            ratio = half_step(est, data, conv, "ratio", eps, out=ratio, scratch=scratch)
            est = half_step(ratio, est, adj, "mult", eps, out=est, scratch=scratch)
        del ratio, scratch
    del data
    rz, ry, rx = radii
    nz, ny, nx = image.shape
    return est[rz : rz + nz, ry : ry + ny, rx : rx + nx].contiguous()
