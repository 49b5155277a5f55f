"""The banded z-sum of the ``fft2z`` RL on the card: wrapper of
``csrc/zband.cu``.

No TPU kernel: the JAX package writes this sum in XLA inside
``shrimpy_tpu/ops/deconv.py::_rl_fft2z_jit`` (:340, its ``band`` :445).
With a half spectrum ``spec`` (gz, gy, gxr) and per-plane OTFs ``taps``
(kz, gy, gxr), both complex, and ``rz = kz // 2``:

* ``conv``: ``out[z] = sum_t taps[kz-1-t] * spec[(z + t - rz) mod gz]``
  (half-step 1, ``body_b``);
* ``corr``: ``out[z] = sum_t conj(taps[t]) * spec[(z + t - rz) mod gz]``
  (half-step 2, ``body_c``);

summed in ascending ``t``. :func:`zband` launches the kernel for a CUDA
tensor (:func:`zband_cuda`, complex64 only) and runs the plain version
(:func:`zband_plain`, a chain of torch ops in the input's dtype) for a CPU
tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

MODES = ("conv", "corr")


def _check(spec: torch.Tensor, taps: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if spec.dim() != 3 or taps.dim() != 3 or spec.shape[1:] != taps.shape[1:]:
        raise ValueError(f"spec (gz, gy, gxr) and taps (kz, gy, gxr) must share their planes, "
                         f"got {tuple(spec.shape)} and {tuple(taps.shape)}")
    if taps.shape[0] < 1 or spec.shape[0] < 1:
        raise ValueError("spec and taps need at least one plane")


def zband_plain(spec: torch.Tensor, taps: torch.Tensor, mode: str) -> torch.Tensor:
    """The band in plain PyTorch on any device, in ``spec``'s dtype: for
    each tap, a product of the tap with the spectrum shifted by ``t - rz``
    planes, added into the sum, in pieces of contiguous planes (no rolled
    copy: the output is the one full-size buffer it makes)."""
    _check(spec, taps, mode)
    if spec.is_cuda:
        zband_plain.cuda_calls += 1
    gz, kz = spec.shape[0], taps.shape[0]
    rz = kz // 2
    acc = torch.empty_like(spec)
    for t in range(kz):
        h = taps[kz - 1 - t] if mode == "conv" else taps[t].conj()
        # acc[z] (+)= h * spec[(z + t - rz) mod gz], over runs of z whose
        # source planes are contiguous.
        z = 0
        while z < gz:
            src = (z + t - rz) % gz
            n = min(gz - z, gz - src)
            if t == 0:
                torch.mul(h, spec[src:src + n], out=acc[z:z + n])
            else:
                acc[z:z + n].addcmul_(h, spec[src:src + n])
            z += n
    return acc


# Calls of the plain version on a CUDA tensor since the last reset: the
# reference path makes them, a kernel path never does.
zband_plain.cuda_calls = 0


def zband_cuda(spec: torch.Tensor, taps: torch.Tensor, mode: str, *,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The band on the card: one launch of ``csrc/zband.cu``.

    ``spec``, ``taps`` and ``out`` (made when None) are contiguous
    complex64 CUDA tensors on one device; ``out`` must not share memory
    with ``spec``. Launches on the current stream; raises on a wrong
    input or a launch error.
    """
    _check(spec, taps, mode)
    for name, t in (("spec", spec), ("taps", taps)):
        if not t.is_cuda or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"zband_cuda: {name} must be a contiguous complex64 CUDA tensor, "
                             f"got {t.dtype} on {t.device} contiguous={t.is_contiguous()}")
    if taps.device != spec.device:
        raise ValueError("zband_cuda: spec and taps on different devices")
    if out is None:
        out = torch.empty_like(spec)
    elif (out.shape != spec.shape or out.dtype != spec.dtype or out.device != spec.device
          or not out.is_contiguous() or out.data_ptr() == spec.data_ptr()):
        raise ValueError("zband_cuda: out must be a contiguous tensor like spec, apart from it")
    from shrimpy_tpu_torch.kernels.build import check, load_library

    gz, gy, gxr = spec.shape
    code = load_library().shrimpy_zband(
        spec.data_ptr(), taps.data_ptr(), out.data_ptr(), gz, taps.shape[0], gy * gxr,
        int(mode == "corr"), torch.cuda.current_stream(spec.device).cuda_stream)
    check(code, "shrimpy_zband")
    zband_cuda.launches += 1
    return out


# Kernel launches since the last reset (chip_smoke.py reads and resets them).
zband_cuda.launches = 0


def zband(spec: torch.Tensor, taps: torch.Tensor, mode: str, *,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """The band: the kernel for a CUDA tensor, the plain version for a
    CPU one (``out`` is then ignored)."""
    if spec.is_cuda:
        return zband_cuda(spec, taps, mode, out=out)
    return zband_plain(spec, taps, mode)

