"""3-D phase reconstruction: the weak-object transfer function and its
Tikhonov inverse (counterpart of ``shrimpy_tpu/ops/phase.py``).

The transfer function (TF) is computed on the host in float64 numpy and
cached per (shape, settings): :func:`compute_transfer_function`, with
``_settings_key``, ``_compute_tf_cached`` and :func:`tf_as_real`, copies
of the JAX module's (:58-157), and :func:`simulate_defocus_stack` (the
float64 forward model the tests recover a phase object through). The
per-volume inverse runs on the card in ``torch.fft``::

    phi = Re IFFT[ conj(H) F(I - mean I) / (|H|^2 + reg) ]

on the stack padded by ``z_padding`` planes with ``reflect``, cropped
back. No kernel of the repository runs here: JAX's ``_apply_inverse_jit``
(:161) is XLA transforms and elementwise work too.

The TF reaches the card as a complex64 tensor; the stacked (2, Z, Y, X)
real form of :func:`tf_as_real` (what the JAX step takes) is recombined
only where a caller hands it over.

How ``apply_inverse.transform`` maps:

===========  ======================================  =======================================
Setting      JAX off the TPU                         Port
===========  ======================================  =======================================
``auto``     ``xla`` (``ops/dft.py:68-77``)          ``xla``
``xla``      full ``fftn`` / ``ifftn``                the same on ``torch.fft``
``matmul``   half spectrum, ``tf[..., :gx//2+1]``    ``rfftn`` / ``irfftn`` with the half TF
===========  ======================================  =======================================
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from shrimpy_tpu_torch.config import PHASE_INVERSE_DEFAULTS
from shrimpy_tpu_torch.utils.device import as_tensor

TRANSFORMS = ("auto", "xla", "matmul")


def _settings_key(s) -> tuple:
    return (
        s.wavelength_illumination,
        s.index_of_refraction_media,
        s.numerical_aperture_detection,
        s.numerical_aperture_illumination,
        s.z_padding,
        s.invert_phase_contrast,
        s.yx_pixel_size,
        s.z_pixel_size,
    )


@lru_cache(maxsize=8)
def _compute_tf_cached(zyx_shape: tuple[int, int, int], key: tuple) -> np.ndarray:
    (wavelength, n_media, na_det, na_ill, z_padding, invert, yx_px, z_px) = key
    if yx_px is None or z_px is None:
        raise ValueError(
            "phase transfer function requires yx_pixel_size and z_pixel_size "
            "(normally injected from dataset metadata — see "
            "inject_derived_parameters)"
        )
    nz, ny, nx = zyx_shape
    nzp = nz + 2 * z_padding

    # Transverse frequency grid (cycles / um).
    fy = np.fft.fftfreq(ny, d=yx_px)
    fx = np.fft.fftfreq(nx, d=yx_px)
    f2 = fy[:, None] ** 2 + fx[None, :] ** 2
    f = np.sqrt(f2)

    k_media = n_media / wavelength
    source = (f <= na_ill / wavelength).astype(np.float64)
    pupil = (f <= na_det / wavelength).astype(np.float64)
    # Angular-spectrum axial frequency; evanescent components excluded.
    eta = np.sqrt(np.maximum(k_media**2 - f2, 0.0))
    propagating = (f2 < k_media**2).astype(np.float64)
    pupil = pupil * propagating

    # Defocus coordinates in FFT (origin-at-0) order: no linear phase ramp.
    z = np.fft.fftfreq(nzp, d=1.0 / (nzp * z_px))

    # Per-defocus pupil correlations via FFT (each slice two 2-D FFTs).
    g = np.exp(2j * np.pi * eta[None, :, :] * z[:, None, None])
    a = source[None] * pupil[None] * g
    b = pupil[None] * g
    fa = np.fft.fft2(a, axes=(-2, -1))
    fb = np.fft.fft2(b, axes=(-2, -1))
    corr = np.fft.ifft2(fa * np.conj(fb), axes=(-2, -1))

    c3 = np.fft.fft(corr, axis=0)
    # conj(C(-nu)) on the periodic grid: reverse each axis about index 0.
    c3_mirror = np.conj(np.roll(c3[::-1, ::-1, ::-1], shift=(1, 1, 1), axis=(0, 1, 2)))
    h_im = 1j * (c3 - c3_mirror)

    denom = source.sum()
    if denom == 0:
        raise ValueError("empty illumination source: check NA / pixel size")
    h_im = h_im / denom
    if invert:
        h_im = -h_im
    return h_im.astype(np.complex64)


def compute_transfer_function(zyx_shape: tuple[int, int, int], settings) -> np.ndarray:
    """Phase WOTF ``H_im`` for a (Z, Y, X) stack, padded by ``z_padding``:
    ``(nz + 2 * z_padding, ny, nx)`` complex64 numpy, origin-at-0 order on
    every axis. Host float64, cached per (shape, settings)."""
    return _compute_tf_cached(tuple(int(n) for n in zyx_shape), _settings_key(settings))


def tf_as_real(tf: np.ndarray) -> np.ndarray:
    """Complex TF -> stacked (2, Z, Y, X) float32 (re, im)."""
    tf = np.asarray(tf)
    return np.stack([tf.real, tf.imag]).astype(np.float32)


def tf_tensor(tf, device=None) -> torch.Tensor:
    """The TF as a complex tensor on ``device``: a complex (Z, Y, X)
    array or tensor as it is, the (2, Z, Y, X) real pair of
    :func:`tf_as_real` recombined (``device`` None: the card, or a
    tensor's own device)."""
    t = as_tensor(tf, device)
    if not t.is_complex():
        if t.dim() != 4 or t.shape[0] != 2:
            raise ValueError(f"a real TF must be the (2, Z, Y, X) pair, got {tuple(t.shape)}")
        t = torch.complex(t[0].float(), t[1].float())
    return t


def resolve_transform(settings) -> str:
    """``auto`` -> ``xla``, as the JAX package resolves it off the TPU."""
    t = settings.transform
    if t not in TRANSFORMS:
        raise ValueError(f"unknown phase transform {t!r}")
    return "xla" if t == "auto" else t


def apply_inverse_transfer_function(stack_zyx, tf, settings=None, *, z_padding: int = 0,
                                    device=None, dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """Tikhonov phase reconstruction of a brightfield defocus stack
    (``_apply_inverse_jit``): ``tf`` is :func:`compute_transfer_function`
    of the stack's shape (complex, or its real pair). ``stack_zyx`` and
    ``device`` as in :func:`~shrimpy_tpu_torch.ops.deconv.richardson_lucy`;
    the TF follows the stack. ``dtype`` float64 (TF in complex128) is the
    reference path. Returns a ``dtype`` tensor of the stack's shape."""
    settings = settings or SimpleNamespace(**PHASE_INVERSE_DEFAULTS)
    transform = resolve_transform(settings)
    reg = float(settings.regularization_strength)
    stack = as_tensor(stack_zyx, device).to(dtype)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    h = tf_tensor(tf, stack.device).to(cdtype)
    if z_padding:
        stack = _reflect_z(stack, z_padding)
    if tuple(h.shape) != tuple(stack.shape):
        raise ValueError(f"TF {tuple(h.shape)} does not match the padded stack "
                         f"{tuple(stack.shape)}")
    # Remove the DC background (the delta term of the weak-object model).
    stack = stack - stack.mean()
    if transform == "matmul":
        # The WOTF is Hermitian, so the half spectrum with the half TF
        # gives real(ifftn(...)) of the full one.
        gx = stack.shape[-1]
        h = h[..., : gx // 2 + 1]
        spectrum = torch.fft.rfftn(stack)
        phi = torch.fft.irfftn(h.conj() * spectrum / (h.abs() ** 2 + reg), s=tuple(stack.shape))
    else:
        spectrum = torch.fft.fftn(stack)
        phi = torch.fft.ifftn(h.conj() * spectrum / (h.abs() ** 2 + reg)).real
    if z_padding:
        phi = phi[z_padding:-z_padding]
    return phi.contiguous()


def _reflect_z(stack: torch.Tensor, n: int) -> torch.Tensor:
    """``np.pad(stack, ((n, n), (0, 0), (0, 0)), mode="reflect")``."""
    idx = np.pad(np.arange(stack.shape[0]), (n, n), mode="reflect")
    return stack.index_select(0, torch.from_numpy(idx).to(stack.device))


def reconstruct_phase(stack_zyx, settings, *, device=None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One call: the (cached) TF of the stack's shape, then the inverse."""
    tfs = settings.transfer_function
    tf = compute_transfer_function(tuple(stack_zyx.shape), tfs)
    return apply_inverse_transfer_function(stack_zyx, tf, settings.apply_inverse,
                                           z_padding=tfs.z_padding, device=device, dtype=dtype)


def simulate_defocus_stack(phi_zyx: np.ndarray, tf: np.ndarray, *, background: float = 1.0,
                           z_padding: int = 0) -> np.ndarray:
    """Forward model, float64 on the host: ``I = background + Re IFFT[
    H * FFT(phi)]`` of the phase object zero-padded by ``z_padding``."""
    phi = np.asarray(phi_zyx, dtype=np.float64)
    if z_padding:
        phi = np.pad(phi, ((z_padding, z_padding), (0, 0), (0, 0)), mode="constant")
    spectrum = np.fft.fftn(phi)
    intensity = background + np.real(np.fft.ifftn(tf.astype(np.complex128) * spectrum))
    if z_padding:
        intensity = intensity[z_padding:-z_padding]
    return intensity.astype(np.float32)
