"""Oblique-plane light-sheet deskew (counterpart of
``shrimpy_tpu/ops/deskew.py``).

Raw volumes are indexed ``raw[s, t, x]`` — (SCAN, TILT, COVERSLIP). In
units of the camera pixel, raw pixel ``(s, t, x)`` sits at lab
coordinates ``z = t sin(theta)``, ``y = s / r + t cos(theta)``, ``x``;
the deskewed volume samples the lab frame on a unit grid, so
``out[zo, yo, xo]`` is the trilinear sample of the raw volume at
``t = zo / sin(theta)``, ``s = r ((yo + y_offset) - zo / tan(theta))``
(see the JAX module's docstring for the full geometry, ``keep_overhang``
and ``average_n_slices``).

The host numpy helpers (:func:`_geometry`, :func:`get_deskewed_shape`,
:func:`deskew_affine_matrix`, :func:`deskew_reference_scipy`) are copies
of the JAX module's: that module imports jax at the top, and a GPU host
running the port need not have jax. ``tests/test_torch_deskew.py`` pins
each copy to its
original.

:func:`deskew_volume` dispatches on the tensor's device: a CPU tensor
runs :func:`deskew_plain` (a gather + lerp twin of ``_deskew_xla``), a
CUDA tensor runs the hand-written kernel
(:func:`shrimpy_tpu_torch.ops.deskew_cuda.deskew_cuda`). The settings
values ``backend: auto | pallas | xla`` all mean this one function here:
on the TPU they chose between two implementations of the same
semantics, a choice the card does not have.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shrimpy_tpu_torch.config import require_ratio
from shrimpy_tpu_torch.utils.device import as_tensor

DESKEW_BACKENDS = ("auto", "pallas", "xla")


def _geometry(raw_shape_szx: tuple[int, int, int], settings) -> dict:
    """Static deskew geometry: output extents and the y crop offset."""
    theta = math.radians(settings.ls_angle_deg)
    r = require_ratio(settings)
    ns, nt, nx = raw_shape_szx
    sin_t, cos_t = math.sin(theta), math.cos(theta)

    if settings.keep_overhang:
        # Full parallelogram footprint; the rim blends toward cval=0
        # exactly as scipy's order-1 'constant' boundary does.
        nz_full = int(math.ceil((nt - 1) * sin_t)) + 1
        y_offset = 0.0
        ny = int(math.ceil((ns - 1) / r + (nt - 1) * cos_t)) + 1
    else:
        # Fully-sampled band only: every output voxel is a valid
        # interpolation of in-range raw samples (floor, not ceil).
        nz_full = int(math.floor((nt - 1) * sin_t)) + 1
        y_offset = (nt - 1) * cos_t
        ny = int(math.floor((ns - 1) / r - (nt - 1) * cos_t)) + 1
        if ny < 1:
            raise ValueError(
                "deskew: the fully-sampled band is empty for raw shape "
                f"{raw_shape_szx} at ls_angle_deg={settings.ls_angle_deg}, "
                f"px_to_scan_ratio={r}; use keep_overhang=True"
            )
    return {
        "theta": theta,
        "r": r,
        "sin_t": sin_t,
        "cos_t": cos_t,
        "nz_full": nz_full,
        "ny": ny,
        "nx": nx,
        "y_offset": y_offset,
    }


def get_deskewed_shape(
    raw_shape_szx: tuple[int, int, int],
    settings,
    pixel_size_um: float | None = None,
) -> tuple[tuple[int, int, int], tuple[float, float, float]]:
    """Output ``(Z, Y, X)`` shape and voxel size (um) of the deskew.

    Voxel size is ``(n_avg * px, px, px)`` with ``px`` the camera pixel
    size: the output z grid is one camera pixel per slice (the resample
    takes ``t = zo / sin(theta)``, so ``z_lab(zo) = zo * px``).
    """
    g = _geometry(raw_shape_szx, settings)
    n = settings.average_n_slices
    nz = -(-g["nz_full"] // n)
    px = pixel_size_um if pixel_size_um is not None else (settings.pixel_size_um or 1.0)
    voxel = (n * px, px, px)
    return (nz, g["ny"], g["nx"]), voxel


def deskew_affine_matrix(
    raw_shape_szx: tuple[int, int, int], settings
) -> tuple[np.ndarray, np.ndarray, tuple[int, int, int]]:
    """``(matrix, offset, output_shape)`` of the inverse map for scipy."""
    g = _geometry(raw_shape_szx, settings)
    m = np.array(
        [
            [-g["r"] / math.tan(g["theta"]), g["r"], 0.0],
            [1.0 / g["sin_t"], 0.0, 0.0],
            [0.0, 0.0, 1.0],
        ]
    )
    offset = np.array([g["r"] * g["y_offset"], 0.0, 0.0])
    return m, offset, (g["nz_full"], g["ny"], g["nx"])


def deskew_reference_scipy(raw_szx: np.ndarray, settings) -> np.ndarray:
    """Trusted CPU oracle: scipy.ndimage.affine_transform at order=1."""
    from scipy import ndimage

    m, offset, out_shape = deskew_affine_matrix(raw_szx.shape, settings)
    # 'grid-constant': rim samples blend linearly toward cval=0, matching
    # the masked-weight blending of the kernels.
    out = ndimage.affine_transform(
        raw_szx.astype(np.float64),
        m,
        offset=offset,
        output_shape=out_shape,
        order=1,
        mode="grid-constant",
        cval=0.0,
    )
    if settings.average_n_slices > 1:
        n = settings.average_n_slices
        nz = out.shape[0]
        groups = [
            out[i : min(i + n, nz)].mean(axis=0) for i in range(0, nz, n)
        ]
        out = np.stack(groups)
    return out.astype(np.float32)


def _average_z_groups(vol: torch.Tensor, n: int) -> torch.Tensor:
    """Mean over groups of ``n`` z-slices; partial tail averaged over its size."""
    if n <= 1:
        return vol
    nz = vol.shape[0]
    n_groups = -(-nz // n)
    pad = n_groups * n - nz
    padded = torch.nn.functional.pad(vol, (0, 0, 0, 0, 0, pad))
    sums = padded.reshape(n_groups, n, *vol.shape[1:]).sum(dim=1)
    starts = torch.arange(n_groups, device=vol.device) * n
    counts = torch.clamp(starts + n, max=nz) - starts
    return sums / counts[:, None, None].to(vol.dtype)


def deskew_plain(
    raw: torch.Tensor, settings, *, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch deskew on ``raw``'s device: row gathers + lerp.

    The twin of ``_deskew_xla``: per output z, the two tilt planes
    (``t = zo / sin(theta)``) each give two scan-row gathers
    (``s = r ((yo + y_offset) - zo / tan(theta))``) blended by the
    order-1 weights; with ``keep_overhang`` taps outside the raw extent
    carry weight 0. Coordinates are float64 (the JAX twin's are float32);
    samples are in ``dtype`` (float64 for the reference run on the card).
    """
    g = _geometry(tuple(raw.shape), settings)
    ns, nt, nx = raw.shape
    nz, ny = g["nz_full"], g["ny"]
    dev = raw.device
    raw = raw.to(dtype)
    f64 = torch.float64

    # Tilt coordinate: depends only on output z.
    zo = torch.arange(nz, dtype=f64, device=dev)
    t = zo / g["sin_t"]
    t0i = torch.floor(t).long()
    frac_t = t - t0i
    t1i = t0i + 1
    wt0 = torch.where((t0i >= 0) & (t0i <= nt - 1), 1.0 - frac_t, 0.0).to(dtype)
    wt1 = torch.where((t1i >= 0) & (t1i <= nt - 1), frac_t, 0.0).to(dtype)
    t0 = t0i.clamp(0, nt - 1)
    t1 = t1i.clamp(0, nt - 1)

    # Scan coordinate: affine in output y with a per-z offset.
    yo = torch.arange(ny, dtype=f64, device=dev)
    s = g["r"] * ((yo[None, :] + g["y_offset"]) - zo[:, None] / math.tan(g["theta"]))
    s0f = torch.floor(s)
    ws = s - s0f
    s0 = s0f.long()
    s1 = s0 + 1
    if settings.keep_overhang:
        w00 = torch.where((s0 >= 0) & (s0 <= ns - 1), 1.0 - ws, 0.0)
        w01 = torch.where((s1 >= 0) & (s1 <= ns - 1), ws, 0.0)
    else:
        # In range by construction (up to round-off at the rim).
        w00, w01 = 1.0 - ws, ws
    w00 = w00.to(dtype)[:, :, None]
    w01 = w01.to(dtype)[:, :, None]
    s0c = s0.clamp(0, ns - 1)
    s1c = s1.clamp(0, ns - 1)

    def sample(z: int, t_idx: torch.Tensor) -> torch.Tensor:
        # Two contiguous x-row gathers from one tilt plane -> (ny, nx).
        plane = raw.index_select(1, t_idx[z : z + 1])[:, 0]  # (ns, nx)
        row0 = plane.index_select(0, s0c[z])
        row1 = plane.index_select(0, s1c[z])
        return w00[z] * row0 + w01[z] * row1

    out = torch.empty((nz, ny, nx), dtype=dtype, device=dev)
    for z in range(nz):
        out[z] = wt0[z] * sample(z, t0) + wt1[z] * sample(z, t1)
    return _average_z_groups(out, settings.average_n_slices)


def deskew_volume(raw_szx, settings, *, device=None) -> torch.Tensor:
    """Deskew a raw (scan, tilt, x) volume -> float32 (Z, Y, X) volume.

    ``raw_szx`` is a tensor, which stays on its device unless ``device``
    moves it, or a numpy array, which goes to ``device`` (the card when
    None; ``"cpu"`` asks for the CPU). A CPU tensor runs
    :func:`deskew_plain`; a CUDA tensor runs the CUDA kernel and raises
    if it cannot (no fallback). ``settings.backend`` must be one of
    ``auto``, ``pallas``, ``xla``, which all mean this function.
    """
    if settings.backend not in DESKEW_BACKENDS:
        raise ValueError(
            f"deskew backend {settings.backend!r} not in {DESKEW_BACKENDS}"
        )
    raw = as_tensor(raw_szx, device)
    if raw.is_cuda:
        from shrimpy_tpu_torch.ops.deskew_cuda import deskew_cuda

        return deskew_cuda(raw.to(torch.float32).contiguous(), settings)
    return deskew_plain(raw, settings)
