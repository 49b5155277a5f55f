"""The benchmark's inputs, made from ``--seed``: the PSF of a
configuration and the camera-like raw stacks of a traffic mix.

Both sides of the check get the same arrays: the program the raws and
the PSF as they are, the reference the same tensors and the same numpy
array. Nothing here imports the package under test; a measured PSF is
a file under this folder, made once and checked by its hash.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.spec import HERE


def gaussian_psf(shape_zyx, sigma_zyx) -> np.ndarray:
    """Axis-aligned Gaussian, unit sum, centred at ``shape // 2``; exactly
    rank 1 (the outer product of its three axes), float32."""
    axes = []
    for n, sigma in zip(shape_zyx, sigma_zyx):
        u = np.arange(n, dtype=np.float64) - n // 2
        axes.append(np.exp(-0.5 * (u / sigma) ** 2))
    psf = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return (psf / psf.sum()).astype(np.float32)


def tilted_gaussian_psf(shape_zyx, shears, sigma_zyx) -> np.ndarray:
    """Anisotropic Gaussian whose axes are sheared out of the grid's (z by
    ``shears[0]`` y, y by ``shears[1]`` x), as an oblique light sheet
    tilts its PSF: not a product of 1-D factors. Float32, unit sum."""
    kz, ky, kx = shape_zyx
    zz, yy, xx = np.meshgrid(np.arange(kz) - kz // 2.0, np.arange(ky) - ky // 2.0,
                             np.arange(kx) - kx // 2.0, indexing="ij")
    zr = zz + shears[0] * yy
    yr = yy + shears[1] * xx
    psf = np.exp(-0.5 * ((zr / sigma_zyx[0]) ** 2 + (yr / sigma_zyx[1]) ** 2
                         + (xx / sigma_zyx[2]) ** 2)).astype(np.float32)
    return psf / psf.sum()


def npy_psf(root, path: str, sha256: str) -> np.ndarray:
    """A PSF frozen as a ``.npy`` file at ``path`` under the benchmark's
    folder ``root`` (a measurement made once and committed, never the
    program's output at run time), float32. Refuses a path that leads out
    of ``root`` and a file whose sha256 is not ``sha256``."""
    base = root.resolve()
    file = (base / path).resolve()
    if base not in file.parents:
        raise ValueError(f"PSF file {path!r} is not inside {base}")
    digest = hashlib.sha256(file.read_bytes()).hexdigest()
    if digest != sha256:
        raise ValueError(f"PSF file {path!r} has sha256 {digest}, the configuration {sha256}")
    return np.load(file, allow_pickle=False).astype(np.float32)


PSF_KINDS = {
    "gaussian": lambda p, root: gaussian_psf(p["shape_zyx"], p["sigma_zyx"]),
    "tilted_gaussian": lambda p, root: tilted_gaussian_psf(p["shape_zyx"], p["shears"],
                                                           p["sigma_zyx"]),
    "npy": lambda p, root: npy_psf(root, p["path"], p["sha256"]),
}


def make_psf(spec: dict, root=None) -> np.ndarray:
    """The PSF a configuration's ``psf`` entry names; a file's path is
    under ``root`` (default: this folder)."""
    if spec.get("kind") not in PSF_KINDS:
        raise ValueError(f"unknown PSF {spec!r}")
    return PSF_KINDS[spec["kind"]](spec, HERE if root is None else root)


def stream_seed(seed: int, index: int) -> int:
    """A 63-bit seed for raw ``index`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"gpubench:{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def camera_raw(shape, params: dict, seed: int, device) -> torch.Tensor:
    """One raw ``(scan, tilt, x)`` stack as an sCMOS camera counts it,
    float32 holding whole numbers in ``[0, max_count]``: a fixed number
    of point-like structures (log-uniform brightness) blurred into
    small blobs over a flat background, the dark offset, and shot noise
    (in its Gaussian limit: every rate is at least the background's)
    with read noise, rounded. Made on ``device`` in a few large calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = int(np.prod(shape))
    k, passes = int(params["blob_kernel"]), int(params["blob_passes"])
    line = np.ones(1)
    for _ in range(passes):
        line = np.convolve(line, np.full(k, 1.0 / k))
    gain = 1.0 / float(line.max()) ** 3  # a point's value over its blob's peak
    signal = torch.zeros(n, dtype=torch.float32, device=device)
    where = torch.rand(int(params["structures"]), generator=gen, device=device, dtype=torch.float64)
    idx = (where * n).long().clamp_(max=n - 1)
    lo, hi = (float(v) for v in params["peak_counts"])
    amp = lo * (hi / lo) ** torch.rand(idx.shape, generator=gen, device=device)
    signal.index_put_((idx,), amp * gain, accumulate=True)
    signal = signal.view(1, 1, *shape)
    for _ in range(passes):
        signal = F.avg_pool3d(signal, k, stride=1, padding=k // 2)
    rate = signal.view(*shape).add_(float(params["background"]))
    del signal
    noise = torch.randn(shape, generator=gen, device=device)
    noise.mul_(rate.add(float(params["read_noise"]) ** 2).sqrt_())
    counts = rate.add_(noise).add_(float(params["dark_offset"]))
    del noise
    return counts.round_().clamp_(0.0, float(params["max_count"]))


def make_raws(shape, params: dict, seed: int, count: int, device) -> list[torch.Tensor]:
    """The ``count`` distinct raws of a run, each from its own stream of
    the run's seed: the same seed gives the same raws."""
    return [camera_raw(shape, params, stream_seed(seed, i), device) for i in range(count)]
