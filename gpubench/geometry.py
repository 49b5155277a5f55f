"""The benchmark's own arithmetic, frozen here: the deskew's geometry,
the RL grids, the working PSF and its separable rank, the device's
peaks, and the least bytes and operations of each kernel a metric holds
to its roofline.

Nothing here imports the package under test. The formulas follow the
algorithms' published definitions (the oblique-plane deskew by
trilinear interpolation, Richardson-Lucy on a padded grid), written out
again so that a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import math

import numpy as np

# Published peaks of one NVIDIA H100 SXM (data sheet, dense rates):
# device memory bandwidth and float32 outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12

F32 = 4  # bytes of a float32
C64 = 8  # bytes of a complex64


def deskew_geometry(raw_shape, deskew: dict) -> dict:
    """Geometry of the deskew of a raw ``(scan, tilt, x)`` stack.

    Raw pixel ``(s, t, x)`` sits at lab ``z = t sin(theta)``,
    ``y = s / r + t cos(theta)``; output voxel ``(zo, yo, xo)`` samples
    the raw at ``t = zo / sin(theta)``, ``s = r ((yo + y_offset) - zo /
    tan(theta))``. Without the overhang only the fully sampled band is
    kept. Returns the output extents before z averaging and the
    constants of that map."""
    ns, nt, nx = (int(v) for v in raw_shape)
    theta = math.radians(float(deskew["ls_angle_deg"]))
    r = float(deskew["px_to_scan_ratio"])
    sin_t, cos_t = math.sin(theta), math.cos(theta)
    if deskew["keep_overhang"]:
        nz = int(math.ceil((nt - 1) * sin_t)) + 1
        ny = int(math.ceil((ns - 1) / r + (nt - 1) * cos_t)) + 1
        y_offset = 0.0
    else:
        nz = int(math.floor((nt - 1) * sin_t)) + 1
        ny = int(math.floor((ns - 1) / r - (nt - 1) * cos_t)) + 1
        y_offset = (nt - 1) * cos_t
    if ny < 1:
        raise ValueError(f"deskew: empty output for raw {raw_shape}")
    return {"theta": theta, "r": r, "sin_t": sin_t, "tan_t": math.tan(theta), "nz": nz,
            "ny": ny, "nx": nx, "y_offset": y_offset, "ns": ns, "nt": nt}


def deskewed_shape(raw_shape, deskew: dict) -> tuple[int, int, int]:
    """``(Z, Y, X)`` of the deskewed volume (z averaged over groups of
    ``average_n_slices``, a partial last group kept)."""
    g = deskew_geometry(raw_shape, deskew)
    n = int(deskew["average_n_slices"])
    return (-(-g["nz"] // n), g["ny"], g["nx"])


def deskew_rows_read(raw_shape, deskew: dict) -> int:
    """Raw rows ``(s, t)`` (each ``x`` long) that the deskew's output
    needs: the two scan rows of each output row, on each tilt plane
    that carries weight."""
    g = deskew_geometry(raw_shape, deskew)
    ns, nt = g["ns"], g["nt"]
    yo = np.arange(g["ny"], dtype=np.float64)
    seen = np.zeros((ns, nt), dtype=bool)
    for zo in range(g["nz"]):
        t = zo / g["sin_t"]
        t0 = math.floor(t)
        ft = t - t0
        s = g["r"] * ((yo + g["y_offset"]) - zo / g["tan_t"])
        s0 = np.floor(s).astype(np.int64)
        rows = np.unique(np.concatenate([s0, s0 + 1]))
        rows = rows[(rows >= 0) & (rows < ns)]
        for tt, w in ((t0, 1.0 - ft), (t0 + 1, ft)):
            if 0 <= tt < nt and w != 0.0:
                seen[rows, tt] = True
    return int(seen.sum())


def smooth_len(n: int, multiple: int = 1) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n`` and has no prime
    factor but 2, 3 and 5 (``multiple`` itself 5-smooth)."""
    m = max(multiple, -(-int(n) // multiple) * multiple)
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += multiple


def g_grid(image_shape, psf_shape) -> tuple[int, ...]:
    """The separable RL's grid: the image padded by the PSF's radius on
    each side of each axis."""
    return tuple(int(n) + 2 * (int(k) // 2) for n, k in zip(image_shape, psf_shape))


def fft_grid(image_shape, psf_shape) -> tuple[tuple[int, ...], tuple[tuple[int, int], ...]]:
    """The FFT RL's grid and per-axis ``(lo, hi)`` pads: the image padded
    by the PSF's radius on each side, then up to a 5-smooth length, the
    last axis to a 5-smooth multiple of 128; the extra split evenly,
    the odd one high."""
    grid, pads = [], []
    last = len(image_shape) - 1
    for ax, (n, k) in enumerate(zip(image_shape, psf_shape)):
        half = int(k) // 2
        target = int(n) + 2 * half
        fast = smooth_len(target, 128) if ax == last else smooth_len(target)
        extra = fast - target
        grid.append(fast)
        pads.append((half + extra // 2, half + extra - extra // 2))
    return tuple(grid), tuple(pads)


def working_psf(psf, crop_tol: float) -> np.ndarray:
    """The PSF RL runs with: float64, border planes whose every value is
    at most ``crop_tol`` of the peak cut away symmetrically (so the
    centre ``k // 2`` stays), a zero plane added to each even axis,
    scaled to unit sum."""
    p = np.asarray(psf, dtype=np.float64)
    if crop_tol > 0:
        mask = np.abs(p) > crop_tol * float(np.abs(p).max())
        cut = []
        for ax in range(p.ndim):
            other = tuple(a for a in range(p.ndim) if a != ax)
            hit = np.flatnonzero(mask.any(axis=other))
            if hit.size == 0:
                cut = None
                break
            margin = min(int(hit.min()), p.shape[ax] - 1 - int(hit.max()))
            cut.append(slice(margin, p.shape[ax] - margin))
        if cut is not None:
            p = p[tuple(cut)]
    p = np.pad(p, [(0, 1 - n % 2) for n in p.shape])
    return p / p.sum()


def separable_residuals(psf: np.ndarray, n_terms: int) -> list[float]:
    """Relative Frobenius residual of ``psf`` after its 1, 2, ...
    strongest rank-1 terms, the terms taken from an SVD of the (z, yx)
    unfolding and of each (y, x) mode (mutually orthogonal, so the
    residual falls with every term)."""
    nz, ny, nx = psf.shape
    u, s, vt = np.linalg.svd(psf.reshape(nz, ny * nx), full_matrices=False)
    weights = []
    for r in range(len(s)):
        if s[r] <= 0:
            break
        ps = np.linalg.svd(vt[r].reshape(ny, nx), compute_uv=False)
        weights.extend(float(s[r] * q) for q in ps if q > 0)
    weights.sort(reverse=True)
    total = float(np.sum(psf.astype(np.float64) ** 2))
    out, kept = [], 0.0
    for w in weights[:n_terms]:
        kept += w * w
        out.append(math.sqrt(max(total - kept, 0.0) / total))
    return out


def rl_route(psf_unit: np.ndarray, deconvolve: dict) -> str:
    """The RL the configuration's settings call for with this working
    PSF: ``"separable"`` (zero boundary on the G grid) where a few
    rank-1 terms reproduce it within ``separable_tol``, ``"fft"``
    (circular on the FFT grid) where ``algorithm`` says so or no
    separable tier takes it. Raises for the tiers in between (extended
    rank, denoised truncation), which no configuration here uses."""
    algorithm = deconvolve["algorithm"]
    if algorithm == "fft":
        return "fft"
    if algorithm not in ("auto", "separable"):
        raise ValueError(f"the reference runs algorithm auto, separable or fft, not {algorithm!r}")
    strict = separable_residuals(psf_unit, int(deconvolve["max_separable_terms"]))
    if any(res <= deconvolve["separable_tol"] for res in strict):
        return "separable"
    extended = max(int(deconvolve["max_extended_terms"]), int(deconvolve["max_separable_terms"]))
    last = separable_residuals(psf_unit, extended)[-1]
    denoise_off = deconvolve["psf_denoise"] == "off"
    if algorithm == "auto" and last > deconvolve["separable_tol"] and (
            denoise_off or last > deconvolve["psf_denoise_max_residual"]):
        return "fft"
    raise ValueError("the PSF falls in a separable tier past the strict one "
                     f"(rank-{extended} residual {last:.3e}); the reference does not model it")


def bound_s(bytes_moved: float, flops: float = 0.0) -> float:
    """The least time the card could take: bytes at the memory rate or
    float32 operations at their peak, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_S, flops / FP32_FLOPS_S)


def deskew_bytes(raw_shape, deskew: dict) -> int:
    """The raw rows the output needs, read once, and the output written
    once, in float32."""
    nz, ny, nx = deskewed_shape(raw_shape, deskew)
    return (deskew_rows_read(raw_shape, deskew) * int(raw_shape[2]) + nz * ny * nx) * F32


def half_step_bytes(grid) -> int:
    """One separable RL half-step on the G grid: two carries read (the
    estimate and the data, or the ratio and the estimate) and one
    written, in float32."""
    return 3 * math.prod(grid) * F32


def half_step_flops(grid, psf_shape) -> int:
    """A rank-1 separable convolution: one multiply-add a tap of each
    axis a voxel, and the epilogue's divide or multiply."""
    return math.prod(grid) * (2 * sum(int(k) for k in psf_shape) + 1)


def zband_bytes(grid, kz: int) -> int:
    """One banded z-sum of the FFT RL: the half spectrum read and written
    once, and the ``kz`` planes of per-plane OTFs read, in complex64."""
    gz, gy, gx = grid
    plane = gy * (gx // 2 + 1)
    return (2 * gz * plane + int(kz) * plane) * C64


def zband_flops(grid, kz: int) -> int:
    """A complex multiply-add (8 float operations) a tap a spectrum value."""
    gz, gy, gx = grid
    return 8 * int(kz) * gz * gy * (gx // 2 + 1)
