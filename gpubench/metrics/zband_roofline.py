"""The FFT RL's band kernel's share of its roofline, in %: each launch's
least time on the FFT grid (the half spectrum read and written once,
the PSF's per-plane OTFs read, at the memory rate, or its complex
multiply-adds at the float32 peak) times the launches, over the band
events' device time. Nothing where no band event ran."""

from gpubench import geometry, trace


def read(ctx):
    d = ctx.config.get("deconvolve")
    if ctx.trace is None or d is None:
        return None
    band = [(s, e) for name, s, e in ctx.trace.device if trace.kind(name) == "band"]
    if not band:
        return None
    psf = geometry.working_psf(ctx.psf, float(d["psf_crop_tol"]))
    grid, _ = geometry.fft_grid(ctx.out_shape, psf.shape)
    kz = psf.shape[0]
    bound = geometry.bound_s(geometry.zband_bytes(grid, kz), geometry.zband_flops(grid, kz))
    return 100.0 * len(band) * bound / (sum(e - s for s, e in band) / 1e6)
