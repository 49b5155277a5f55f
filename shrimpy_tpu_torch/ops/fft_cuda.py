"""The ``fft2z`` RL iteration between its band launches on the card:
wrappers of ``csrc/rl_fft.cu``.

No TPU kernel: the JAX package leaves these transforms and the update of
``shrimpy_tpu/ops/deconv.py::_rl_fft2z_jit`` (:340) to XLA. Four
operations, each on a chunk of whole planes that the loop owns:

* :func:`r2c` ``(x, out)``: ``out = rfft2(x)``, unscaled;
* :func:`c2r_` ``(spec, out)``: ``out = irfft2(spec, norm="forward")``,
  unscaled; on the card it destroys ``spec``;
* :func:`ratio_` ``(x, data, eps)``: ``x = data / max(x, eps)``;
* :func:`scale_` ``(v, x)``: ``v *= x``.

Each takes contiguous tensors on one device: the real arrays (planes, gy,
gx) in float32 or float64, the spectra (planes, gy, gx // 2 + 1) in the
matching complex type, no two of them overlapping. For a CUDA tensor each
runs cuFFT on a plan made once for its (planes, gy, gx, dtype, device),
or one launch of the kernel (``*_cuda``, counted in ``launches``); for a
CPU tensor its plain version, the torch call it replaces (``*_plain``,
counted in ``cuda_calls`` when a CUDA tensor reaches it, as the float64
reference path makes it do). There is no fallback between the two. A
plan's work area is a tensor of PyTorch's caching allocator, made for each
execution (cuFFT allocates none itself), and each execution runs on the
current stream.
"""

from __future__ import annotations

import ctypes
import threading

import torch

COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
R2C, C2R = 0, 1

# (kind, planes, gy, gx, dtype, device index) -> (cuFFT handle, work bytes).
# Plans live as long as the process.
_PLANS: dict[tuple, tuple[int, int]] = {}
_PLAN_LOCK = threading.Lock()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device or not _nbytes(a) or not _nbytes(b):
        return False
    pa, pb = a.data_ptr(), b.data_ptr()
    return pa < pb + _nbytes(b) and pb < pa + _nbytes(a)


def _check_apart(name: str, a_name: str, a: torch.Tensor, b_name: str, b: torch.Tensor) -> None:
    """Both contiguous, on one device, sharing no byte."""
    for arg, t in ((a_name, a), (b_name, b)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"{name}: {a_name} on {a.device}, {b_name} on {b.device}")
    if _overlap(a, b):
        raise ValueError(f"{name}: {a_name} and {b_name} overlap")


def _check_transform(name: str, real: torch.Tensor, spec: torch.Tensor) -> None:
    """``real`` (planes, gy, gx) float32/float64, ``spec`` (planes, gy,
    gx // 2 + 1) of the matching complex type."""
    if real.dtype not in COMPLEX:
        raise ValueError(f"{name}: the real array must be float32 or float64, got {real.dtype}")
    if spec.dtype != COMPLEX[real.dtype]:
        raise ValueError(f"{name}: the spectrum must be {COMPLEX[real.dtype]} for a "
                         f"{real.dtype} real array, got {spec.dtype}")
    if real.dim() != 3 or min(real.shape) < 1:
        raise ValueError(f"{name}: the real array must be (planes, gy, gx), got "
                         f"{tuple(real.shape)}")
    n, gy, gx = real.shape
    if tuple(spec.shape) != (n, gy, gx // 2 + 1):
        raise ValueError(f"{name}: the spectrum of a {tuple(real.shape)} array is "
                         f"{(n, gy, gx // 2 + 1)}, got {tuple(spec.shape)}")
    _check_apart(name, "the real array", real, "the spectrum", spec)


def _check_elementwise(name: str, a_name: str, a: torch.Tensor, b_name: str,
                       b: torch.Tensor) -> None:
    if a.dtype not in COMPLEX or b.dtype != a.dtype:
        raise ValueError(f"{name}: {a_name} and {b_name} must both be float32 or both float64, "
                         f"got {a.dtype} and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"{name}: {a_name} {tuple(a.shape)} and {b_name} {tuple(b.shape)} "
                         "differ in shape")
    _check_apart(name, a_name, a, b_name, b)


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: takes CUDA tensors, got one on {t.device}")


# --- The plain versions: the torch calls the kernels and plans replace.

def r2c_plain(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``torch.fft.rfft2(x, out=out)``."""
    _check_transform("r2c", x, out)
    if x.is_cuda:
        r2c_plain.cuda_calls += 1
    return torch.fft.rfft2(x, out=out)


def c2r_plain(spec: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``torch.fft.irfft2(spec, norm="forward", out=out)`` (``spec`` kept)."""
    _check_transform("c2r_", out, spec)
    if spec.is_cuda:
        c2r_plain.cuda_calls += 1
    return torch.fft.irfft2(spec, s=tuple(out.shape[1:]), norm="forward", out=out)


def ratio_plain(x: torch.Tensor, data: torch.Tensor, eps: float) -> torch.Tensor:
    """``torch.div(data, x.clamp_min_(eps), out=x)``."""
    _check_elementwise("ratio_", "x", x, "data", data)
    if x.is_cuda:
        ratio_plain.cuda_calls += 1
    return torch.div(data, x.clamp_min_(eps), out=x)


def scale_plain(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v.mul_(x)``."""
    _check_elementwise("scale_", "v", v, "x", x)
    if v.is_cuda:
        scale_plain.cuda_calls += 1
    return v.mul_(x)


# Calls of each plain version on a CUDA tensor since the last reset: the
# reference path makes them, the kernel path never does.
r2c_plain.cuda_calls = 0
c2r_plain.cuda_calls = 0
ratio_plain.cuda_calls = 0
scale_plain.cuda_calls = 0


# --- The card: cuFFT on the caller's buffers, the two kernels.

def plan(kind: int, real: torch.Tensor) -> tuple[int, int]:
    """The cached cuFFT plan of ``kind`` (:data:`R2C` or :data:`C2R`) for
    the real array ``real`` (planes, gy, gx) on its device: ``(handle,
    work bytes an execution needs)``, made on the first call with that
    shape, dtype and device."""
    key = (kind, *real.shape, real.dtype, real.device.index)
    got = _PLANS.get(key)
    if got is not None:
        return got
    from shrimpy_tpu_torch.kernels.build import check, load_library

    with _PLAN_LOCK:
        got = _PLANS.get(key)
        if got is None:
            handle, work = ctypes.c_int(), ctypes.c_longlong()
            with torch.cuda.device(real.device):
                check(load_library().shrimpy_fft_plan(
                    kind, int(real.dtype == torch.float64), *real.shape, ctypes.byref(handle),
                    ctypes.byref(work)), "shrimpy_fft_plan")
            got = _PLANS[key] = (handle.value, work.value)
    return got


def _execute(kind: int, real: torch.Tensor, spec: torch.Tensor) -> None:
    from shrimpy_tpu_torch.kernels.build import check, load_library

    handle, work_bytes = plan(kind, real)
    dev = real.device
    # Freed once the call returns: the allocator hands the block out again
    # only to work queued after this execution on the same stream.
    work = torch.empty(work_bytes, dtype=torch.uint8, device=dev)
    src, dst = (real, spec) if kind == R2C else (spec, real)
    with torch.cuda.device(dev):
        code = load_library().shrimpy_fft_exec(
            handle, kind, int(real.dtype == torch.float64), src.data_ptr(), dst.data_ptr(),
            work.data_ptr() if work_bytes else None, torch.cuda.current_stream(dev).cuda_stream)
    check(code, "shrimpy_fft_exec")


def r2c_cuda(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = rfft2(x)`` by cuFFT into ``out`` itself (``x`` kept)."""
    _check_transform("r2c_cuda", x, out)
    _require_cuda("r2c_cuda", x)
    _execute(R2C, x, out)
    r2c_cuda.launches += 1
    return out


def c2r_cuda(spec: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out = irfft2(spec, norm="forward")`` by cuFFT from ``spec``
    itself, which it overwrites."""
    _check_transform("c2r_cuda", out, spec)
    _require_cuda("c2r_cuda", spec)
    _execute(C2R, out, spec)
    c2r_cuda.launches += 1
    return out


def ratio_cuda(x: torch.Tensor, data: torch.Tensor, eps: float) -> torch.Tensor:
    """``x = data / max(x, eps)`` in one launch of ``rl_ratio_kernel``."""
    _check_elementwise("ratio_cuda", "x", x, "data", data)
    _require_cuda("ratio_cuda", x)
    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_rl_ratio(
        x.data_ptr(), data.data_ptr(), x.numel(), float(eps), int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream), "shrimpy_rl_ratio")
    ratio_cuda.launches += 1
    return x


def scale_cuda(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v *= x`` in one launch of ``rl_scale_kernel``."""
    _check_elementwise("scale_cuda", "v", v, "x", x)
    _require_cuda("scale_cuda", v)
    from shrimpy_tpu_torch.kernels.build import check, load_library

    check(load_library().shrimpy_rl_scale(
        v.data_ptr(), x.data_ptr(), v.numel(), int(v.dtype == torch.float64),
        torch.cuda.current_stream(v.device).cuda_stream), "shrimpy_rl_scale")
    scale_cuda.launches += 1
    return v


# Transforms and kernel launches since the last reset (chip_smoke.py reads
# and resets them).
r2c_cuda.launches = 0
c2r_cuda.launches = 0
ratio_cuda.launches = 0
scale_cuda.launches = 0


# --- The wrappers the loop calls: the card for a CUDA tensor, else plain.

def r2c(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return r2c_cuda(x, out) if x.is_cuda else r2c_plain(x, out)


def c2r_(spec: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    return c2r_cuda(spec, out) if spec.is_cuda else c2r_plain(spec, out)


def ratio_(x: torch.Tensor, data: torch.Tensor, eps: float) -> torch.Tensor:
    return ratio_cuda(x, data, eps) if x.is_cuda else ratio_plain(x, data, eps)


def scale_(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return scale_cuda(v, x) if v.is_cuda else scale_plain(v, x)


# The four operations in the order (r2c, c2r_, ratio_, scale_): dispatching
# by device, and the plain versions on any device.
WRAPPERS = (r2c, c2r_, ratio_, scale_)
PLAIN = (r2c_plain, c2r_plain, ratio_plain, scale_plain)
