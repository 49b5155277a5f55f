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
a CPU tensor, :func:`half_step_cuda` (``csrc/rl_fused.cu``) for a CUDA
tensor. The plain version does not use ``F.conv1d``: cuDNN runs float32
convolutions as TF32 by default, and it must also run in float64.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from shrimpy_tpu_torch.ops.rl_outer import biggs_state, next_alpha
from shrimpy_tpu_torch.utils.shapes import round_up

MODES = {"plain": 0, "ratio": 1, "mult": 2, "ratio_accel": 1, "mult_accel": 2}
ACCEL_MODES = ("ratio_accel", "mult_accel")
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


def _x_row_error(gx: int, rx: int) -> str | None:
    # +64 bytes: conv_x_accel_kernel's static reduction buffer.
    if (gx + 2 * rx) * 4 + 64 > _SMEM_BYTES:
        return f"x row {gx} + 2*{rx} exceeds the x pass's shared memory"
    return None


def _check_x_row(gx: int, rx: int) -> None:
    msg = _x_row_error(gx, rx)
    if msg is not None:
        raise ValueError(msg)


def fused_bound_error(shape, radii) -> str | None:
    """Why the half-step kernels cannot take a ``shape`` (gz, gy, gx)
    carry with PSF ``radii``, or None when they can. One source for
    :func:`half_step_cuda`'s refusal and ``auto``'s choice of backend."""
    gz, gy, gx = shape
    r_axis = max(radii[:2])
    if (_TILE_N + 2 * r_axis) * _THREADS_INNER * 4 > _SMEM_BYTES:
        return f"z/y radius {r_axis} exceeds the kernel's shared memory"
    if gz > _MAX_GRID_YZ or round_up(gy, _TILE_N) // _TILE_N > _MAX_GRID_YZ:
        return f"carry {tuple(shape)} exceeds the launch grid"
    return _x_row_error(gx, radii[2])


def conv_x_cuda(src, prev, aux, out, kx: torch.Tensor, mode: str, eps: float, *,
                wrap: bool = False) -> None:
    """The x pass of ``csrc/rl_fused.cu`` (``conv_x_kernel``) over the
    rows of ``src``: ``out = epilogue(X src + prev)``, with mode
    ``plain`` when ``aux`` is None; ``wrap`` makes X circular (the row
    is loaded at ``(x - r) mod gx``) instead of zero outside. Operands
    are checked by the caller."""
    from shrimpy_tpu_torch.kernels.build import check, load_library

    gz, gy, gx = src.shape
    check(load_library().shrimpy_conv_x(
        src.data_ptr(), prev.data_ptr() if prev is not None else None,
        aux.data_ptr() if aux is not None else None, out.data_ptr(),
        kx.data_ptr(), kx.numel(), gz * gy, gx,
        MODES[mode] if aux is not None else 0, float(eps), int(wrap),
        torch.cuda.current_stream(src.device).cuda_stream,
    ), "shrimpy_conv_x")


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
                   name: str) -> torch.Tensor:
    """The term loop of a CUDA half-step, shared by the ``fused``,
    ``linear_pallas`` and ``zy_pallas`` routes (operands checked by
    :func:`check_io_cuda`).

    Per term, ``zy(inp, kz, ky, scratch)`` runs the z and y taps into its
    ``n_zy`` scratch carries and returns the result; the x pass
    (``conv_x``, circular when ``wrap``) adds the earlier terms' sum and,
    on the last term, applies the epilogue of ``mode`` into ``out``.
    ``x_last(h, prev, kx)`` replaces that last x pass when given. ``out``
    may be ``aux`` but alias no other operand, nor any of ``extra``
    (name -> tensor). ``scratch`` (``n_zy`` carries, one more with
    several terms) and ``out`` are allocated when not given.
    """
    shape = tuple(inp.shape)
    _check_stencil(stencil, inp)
    _check_x_row(shape[2], stencil.radii[2])
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
    acc = scratch[n_zy] if n_terms > 1 else None
    for t, (kz, ky, kx) in enumerate(stencil.dev):
        h = zy(inp, kz, ky, scratch[:n_zy])
        last = t == n_terms - 1
        prev = acc if t > 0 else None
        if last and x_last is not None:
            x_last(h, prev, kx)
        else:
            conv_x_cuda(h, prev, aux if last and mode != "plain" else None,
                        out if last else acc, kx, mode, eps, wrap=wrap)
    return out


def half_step_cuda(
    inp: torch.Tensor,
    aux: torch.Tensor | None,
    stencil: Stencil,
    mode: str,
    eps: float = 1e-6,
    *,
    out: torch.Tensor | None = None,
    scratch: list[torch.Tensor] | None = None,
    dx: torch.Tensor | None = None,
    g_prev: torch.Tensor | None = None,
    alpha: torch.Tensor | None = None,
    partials: torch.Tensor | None = None,
):
    """One RL half-step with the CUDA kernels of ``csrc/rl_fused.cu``.

    ``inp`` and ``aux`` are (gz, gy, gx) float32 CUDA tensors; ``out``
    may be ``aux`` (the in-place mult update) but not ``inp``.
    ``scratch`` (2 carries, 3 with more than one term) is allocated when
    not given. Per term: z pass and y pass into scratch, then the x pass
    adds the earlier terms' partial sum and applies the epilogue.

    Accelerated modes take ``dx`` (bf16 carry) and ``alpha`` (a float32
    CUDA scalar, read by the kernels, never by the host).
    ``ratio_accel`` returns ``out``. ``mult_accel`` also takes ``g_prev``
    (bf16) and ``partials`` (float32 (2, gz*gy), allocated when not
    given), writes ``x_new`` over ``aux``, ``dx_new`` over ``dx`` and
    ``g`` over ``g_prev``, and returns ``(aux, dx, g_prev, num, den)``
    with ``num``/``den`` 0-d float32 CUDA tensors summed from the
    per-row partials by ``torch.sum``.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(MODES)}")
    shape = check_io_cuda(inp, aux, mode, "half_step_cuda")
    gz, gy, gx = shape
    accel = mode in ACCEL_MODES
    extra = {}
    if accel:
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
            partials = torch.empty((2, gz * gy), dtype=torch.float32, device=inp.device)
        _check_cuda_operand("partials", partials, (2, gz * gy))
        extra.update(g_prev=g_prev, partials=partials)
    bound = fused_bound_error(shape, stencil.radii)
    if bound is not None:
        raise ValueError(f"half_step_cuda: {bound}")

    from shrimpy_tpu_torch.kernels.build import check, load_library

    stream = torch.cuda.current_stream(inp.device).cuda_stream
    z_extra = (dx.data_ptr(), alpha.data_ptr()) if mode == "ratio_accel" else (None, None)

    def zy(v, kz, ky, scratch):
        s1, s2 = scratch
        lib = load_library()
        check(lib.shrimpy_conv_axis(v.data_ptr(), s1.data_ptr(), kz.data_ptr(), kz.numel(),
                                    1, gz, gy * gx, *z_extra, stream), "shrimpy_conv_axis(z)")
        check(lib.shrimpy_conv_axis(s1.data_ptr(), s2.data_ptr(), ky.data_ptr(), ky.numel(),
                                    gz, gy, gx, None, None, stream), "shrimpy_conv_axis(y)")
        return s2

    def x_accel(h, prev, kx):
        check(load_library().shrimpy_conv_x_accel(
            h.data_ptr(), prev.data_ptr() if prev is not None else None, aux.data_ptr(),
            dx.data_ptr(), g_prev.data_ptr(), alpha.data_ptr(), partials.data_ptr(),
            kx.data_ptr(), kx.numel(), gz * gy, gx, stream,
        ), "shrimpy_conv_x_accel")

    out = run_terms_cuda(inp, aux, stencil, mode, eps, zy, 2, out=out, scratch=scratch,
                         extra=extra, x_last=x_accel if mode == "mult_accel" else None,
                         name="half_step_cuda")
    if accel:
        half_step_cuda.accel_launches += 1
    else:
        half_step_cuda.launches += 1
    if mode == "mult_accel":
        sums = partials.sum(dim=1)
        return aux, dx, g_prev, sums[0], sums[1]
    return out


# Half-steps launched since the last reset (chip_smoke.py reads and
# resets them): ``launches`` in modes ratio/mult/plain, ``accel_launches``
# in modes ratio_accel/mult_accel; each is 3 kernel launches per term.
half_step_cuda.launches = 0
half_step_cuda.accel_launches = 0


def half_step(inp, aux, stencil: Stencil, mode: str, eps: float = 1e-6, *,
              out=None, scratch=None, partials=None, **accel):
    """RL half-step: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor (``out``/``scratch``/``partials`` are
    kernel buffers and unused there). ``accel``: ``dx``, ``g_prev``,
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
    low pads ``lo`` (the radii on the G grid)."""
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
    Memory: data, est and ratio carries plus the kernel's 2-3 scratch
    carries; the mult half-step updates est in place (with Biggs also
    dx and g_prev, two bf16 carries). ``donate`` consumes ``image`` once
    the carries exist (see :func:`grid_start`).
    """
    eps = float(settings.epsilon)
    shape = tuple(image.shape)
    conv, adj, data, est = start_on_grid(image, psf_np, terms, settings, dtype, donate=donate)
    del image
    kernel = not plain and est.is_cuda
    step = half_step_plain if plain else half_step
    biggs = settings.acceleration == "biggs"
    bufs, ratio_buf = {}, None  # the kernels' buffers, allocated once per run
    if kernel:
        ratio_buf = torch.empty_like(est)
        bufs["scratch"] = [torch.empty_like(est) for _ in range(2 if len(terms) == 1 else 3)]
        if biggs:
            bufs["partials"] = torch.empty((2, est.shape[0] * est.shape[1]),
                                           dtype=torch.float32, device=est.device)

    def hs(inp, aux, st, mode, out=None, **kw):
        if kernel:
            kw.update(bufs, out=out)
        return step(inp, aux, st, mode, eps, **kw)

    if biggs:
        # Biggs-Andrews in the half-steps (rl_outer.py has the
        # algorithm): alpha, num and den never leave the device.
        dx, g_prev, den_prev, alpha = biggs_state(est)
        for _ in range(iterations):
            ratio = hs(est, data, conv, "ratio_accel", out=ratio_buf, dx=dx, alpha=alpha)
            est, dx, g_prev, num, den = hs(ratio, est, adj, "mult_accel",
                                           dx=dx, g_prev=g_prev, alpha=alpha)
            del ratio
            alpha = next_alpha(num, den_prev)
            den_prev = den.float()
        del dx, g_prev
    else:
        for _ in range(iterations):
            ratio = hs(est, data, conv, "ratio", out=ratio_buf)
            est = hs(ratio, est, adj, "mult", out=est)
            del ratio
    del data, bufs, ratio_buf
    return crop_grid(est, shape, conv.radii)
