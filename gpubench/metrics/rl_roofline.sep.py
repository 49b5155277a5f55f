"""Separable RL's share of its roofline, in %: RL's least time on the G
grid (two half-steps an iteration, each two carries read and one
written at the memory rate, or its multiply-adds at the float32 peak)
over the device time a volume outside the deskew, whatever kernels do
the work. Nothing on another route or without a trace."""

from gpubench import geometry, trace


def read(ctx):
    d = ctx.config.get("deconvolve")
    if ctx.trace is None or d is None:
        return None
    psf = geometry.working_psf(ctx.psf, float(d["psf_crop_tol"]))
    if geometry.rl_route(psf, d) != "separable":
        return None
    grid = geometry.g_grid(ctx.out_shape, psf.shape)
    half = geometry.bound_s(geometry.half_step_bytes(grid), geometry.half_step_flops(grid, psf.shape))
    deskew = trace.seconds_by(ctx.trace, trace.kind).get("deskew", 0.0)
    spent = (trace.busy_s(ctx.trace) - deskew) / len(ctx.volumes)
    return 100.0 * 2 * int(d["iterations"]) * half / spent if spent > 0 else None
