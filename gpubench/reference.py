"""The plain reference the benchmark holds the program's outputs to:
deskew, then Richardson-Lucy as the configuration's settings call for
it, in float64 PyTorch on whatever device holds the raw.

It imports nothing of the program and takes nothing the program made:
it works out the working PSF, the RL route and its grid from the PSF
and the settings itself (``geometry.py``), and convolves with a whole
3-D PSF by FFTs on a grid of its own, never with separable terms or
OTFs the program planned: the working PSF itself, or on the extended
and truncated tiers (a measured PSF's) the sum of the tier's terms
(``geometry.separable_terms``, worked out again in float64), the
operator those tiers define.

* Deskew: each output voxel the trilinear sample of the raw at its lab
  position (``geometry.deskew_geometry``), z averaged over groups of
  ``average_n_slices``.
* Separable routes: RL on the G grid (the image padded by the PSF's
  radii with ``pad_mode``), ``data = max(g, 0)``, ``est = max(g,
  eps)``, ``est <- est * corr(data / max(conv(est), eps))`` with zero
  outside the grid; each convolution a circular one on a grid at least
  a radius larger, so nothing wraps into the G grid.
* FFT route: the same update, circular on the 5-smooth FFT grid.

``store`` rounds every array the algorithm keeps between its steps (the
deskewed volume, the data, the estimate, the ratio) to a lower
precision: the benchmark's control, a reference in bfloat16, which a
sound comparison has to tell from the program.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench import geometry


def _keep(x: torch.Tensor, store) -> torch.Tensor:
    """``x`` as an array kept in ``store`` precision (and computed on in
    its own); ``x`` itself when ``store`` is None."""
    return x if store is None else x.to(store).to(x.dtype)


def deskew(raw: torch.Tensor, settings: dict, compute=torch.float64, store=None) -> torch.Tensor:
    """Deskew of a raw ``(scan, tilt, x)`` stack, ``(Z, Y, X)`` in
    ``compute``, one output plane at a time."""
    g = geometry.deskew_geometry(tuple(raw.shape), settings)
    ns, nt, nx, nz, ny = g["ns"], g["nt"], g["nx"], g["nz"], g["ny"]
    dev = raw.device
    yo = torch.arange(ny, dtype=torch.float64, device=dev)
    out = torch.empty((nz, ny, nx), dtype=compute, device=dev)
    for zo in range(nz):
        t = zo / g["sin_t"]
        t0 = int(np.floor(t))
        ft = t - t0
        s = g["r"] * ((yo + g["y_offset"]) - zo / g["tan_t"])
        s0 = torch.floor(s)
        fs = s - s0
        s0 = s0.long()
        s1 = s0 + 1
        w0, w1 = 1.0 - fs, fs
        if settings["keep_overhang"]:
            w0 = torch.where((s0 >= 0) & (s0 < ns), w0, 0.0)
            w1 = torch.where((s1 >= 0) & (s1 < ns), w1, 0.0)
        w0, w1 = w0.to(compute)[:, None], w1.to(compute)[:, None]
        s0, s1 = s0.clamp(0, ns - 1), s1.clamp(0, ns - 1)
        acc = torch.zeros((ny, nx), dtype=compute, device=dev)
        for tt, wt in ((t0, 1.0 - ft), (t0 + 1, ft)):
            if 0 <= tt < nt and wt != 0.0:
                plane = raw[:, tt, :]
                rows = w0 * plane.index_select(0, s0).to(compute)
                rows += w1 * plane.index_select(0, s1).to(compute)
                acc += wt * rows
        out[zo] = acc
    n = int(settings["average_n_slices"])
    if n > 1:
        out = torch.stack([out[i:i + n].mean(dim=0) for i in range(0, nz, n)])
    return _keep(out, store)


def pad(x: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """``numpy.pad(x, pads, mode)`` for ``constant`` (zeros) and the index
    modes (``reflect``, ``edge``, ``symmetric``, ``wrap``)."""
    if mode == "constant":
        out = x.new_zeros(tuple(n + lo + hi for n, (lo, hi) in zip(x.shape, pads)))
        out[tuple(slice(lo, lo + n) for n, (lo, _) in zip(x.shape, pads))] = x
        return out
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[axis]), (lo, hi), mode=mode)
            x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
    return x


def irfftn(spec: torch.Tensor, shape) -> torch.Tensor:
    """The inverse real transform over every axis to ``shape``: cuFFT on
    the card; numpy's on the CPU, where PyTorch's double-precision one
    (2.13 with MKL) writes past its buffers."""
    if spec.is_cuda:
        return torch.fft.irfftn(spec, s=shape)
    real = torch.float64 if spec.dtype == torch.complex128 else torch.float32
    return torch.from_numpy(np.fft.irfftn(spec.numpy(), s=shape, axes=range(len(shape)))).to(real)


def embed_psf(psf_unit: np.ndarray, grid, dtype, device) -> torch.Tensor:
    """The PSF on ``grid`` with its centre voxel (``shape // 2``) at index
    0, so that its transform carries no phase."""
    out = torch.zeros(tuple(grid), dtype=dtype, device=device)
    out[tuple(slice(0, k) for k in psf_unit.shape)] = torch.from_numpy(psf_unit).to(device, dtype)
    return torch.roll(out, [-(k // 2) for k in psf_unit.shape], dims=(0, 1, 2))


def _rl_separable(image, psf_unit, d, store):
    """Zero-boundary RL on the G grid (see the module's docstring)."""
    eps, dtype, dev = float(d["epsilon"]), image.dtype, image.device
    radii = [k // 2 for k in psf_unit.shape]
    shape = tuple(image.shape)
    g = pad(image, [(r, r) for r in radii], d["pad_mode"])
    grid = tuple(g.shape)
    big = tuple(geometry.smooth_len(n + r) for n, r in zip(grid, radii))
    inner = tuple(slice(0, n) for n in grid)
    data = _keep(torch.clamp_min(g, 0.0), store)
    est = _keep(torch.clamp_min(g, eps), store)
    del g
    otf = torch.fft.rfftn(embed_psf(psf_unit, big, dtype, dev))
    buf = torch.zeros(big, dtype=dtype, device=dev)  # zero outside the G grid

    def conv(adjoint: bool) -> torch.Tensor:
        spec = torch.fft.rfftn(buf)
        spec.mul_(otf.conj() if adjoint else otf)
        return irfftn(spec, big)

    for _ in range(int(d["iterations"])):
        buf[inner].copy_(est)
        full = conv(False)
        c = full[inner].clamp_min_(eps)
        buf[inner].copy_(_keep(torch.div(data, c, out=c), store))
        del c, full
        full = conv(True)
        est = _keep(est.mul_(full[inner]), store)
        del full
    del buf, otf, data
    return est[tuple(slice(r, r + n) for r, n in zip(radii, shape))]


def _rl_fft(image, psf_unit, d, store):
    """Circular RL on the FFT grid (see the module's docstring)."""
    eps, dtype, dev = float(d["epsilon"]), image.dtype, image.device
    shape = tuple(image.shape)
    grid, pads = geometry.fft_grid(shape, psf_unit.shape)
    g = pad(image, pads, d["pad_mode"])
    data = _keep(torch.clamp_min(g, 0.0), store)
    est = _keep(torch.clamp_min(g, eps), store)
    del g
    otf = torch.fft.rfftn(embed_psf(psf_unit, grid, dtype, dev))
    for _ in range(int(d["iterations"])):
        spec = torch.fft.rfftn(est)
        c = irfftn(spec.mul_(otf), grid)
        del spec
        c.clamp_min_(eps)
        ratio = _keep(torch.div(data, c, out=c), store)
        del c
        spec = torch.fft.rfftn(ratio)
        del ratio
        a = irfftn(spec.mul_(otf.conj()), grid)
        del spec
        est = _keep(est.mul_(a), store)
        del a
    del otf, data
    return est[tuple(slice(lo, lo + n) for (lo, _), n in zip(pads, shape))]


def richardson_lucy(image: torch.Tensor, psf, deconvolve: dict, store=None) -> torch.Tensor:
    """RL of ``image`` (in its own dtype) by ``psf`` under the settings
    ``deconvolve``, on the route they call for (``geometry.rl_route``)."""
    if deconvolve["acceleration"] != "none":
        raise ValueError("the reference runs plain RL (acceleration none)")
    psf_unit = geometry.working_psf(psf, float(deconvolve["psf_crop_tol"]))
    route = geometry.rl_route(psf_unit, deconvolve)
    if route == "fft":
        return _rl_fft(image, psf_unit, deconvolve, store)
    if route in geometry.TERM_ROUTES:
        psf_unit = geometry.terms_psf(geometry.separable_terms(psf_unit, deconvolve)[1])
    return _rl_separable(image, psf_unit, deconvolve, store)


def reconstruct(raw: torch.Tensor, psf, config: dict, compute=torch.float64,
                store=None) -> torch.Tensor:
    """The step's output for one raw ``(scan, tilt, x)`` stack: ``(Z, Y,
    X)`` in ``compute`` on the raw's device."""
    vol = deskew(raw, config["deskew"], compute, store)
    if config.get("deconvolve") is None:
        return vol
    return richardson_lucy(vol, psf, config["deconvolve"], store)


def max_rel_err(out: torch.Tensor, ref: torch.Tensor, chunk: int = 1 << 26) -> float:
    """``max|out - ref| / max|ref|`` in float64, a chunk at a time; inf
    where the shapes differ or ``out`` is not finite."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    a, b = out.reshape(-1), ref.reshape(-1)
    diff = top = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        d = (x - y).abs_().max()
        if not bool(torch.isfinite(d)):
            return float("inf")
        diff = max(diff, float(d))
        top = max(top, float(y.abs().max()))
    return diff / max(top, 1e-300)


def median_abs(ref: torch.Tensor, sample: int = 1 << 20) -> float:
    """The median of ``|ref|`` over an even stride of about ``sample`` of
    its voxels."""
    flat = ref.reshape(-1)
    return float(flat[::max(1, flat.numel() // sample)].abs().median())


def voxel_rel_err(out: torch.Tensor, ref: torch.Tensor, chunk: int = 1 << 26) -> float:
    """The worst voxel's error against its own value: ``max |out - ref| /
    max(|ref|, median|ref|)`` in float64, a chunk at a time; inf where the
    shapes differ or ``out`` is not finite. Where ``max_rel_err`` scales
    every error by the brightest voxel, this holds a dim or background
    voxel to itself (and one below the median to the median)."""
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    floor = max(median_abs(ref), 1e-300)
    a, b = out.reshape(-1), ref.reshape(-1)
    worst = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        e = ((x - y).abs_() / y.abs().clamp_min_(floor)).max()
        if not bool(torch.isfinite(e)):
            return float("inf")
        worst = max(worst, float(e))
    return worst


# The numbers a cell's ``check`` may name (beside ``outputs``), each
# ``f(output, reference) -> float`` compared with the limit given there.
COMPARISONS = {"max_rel_err": max_rel_err, "voxel_rel_err": voxel_rel_err}
