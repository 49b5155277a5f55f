"""RL's share of its roofline on a measured PSF's route (the extended or
the truncated separable tier), in %: the same least time as
``rl_roofline.sep``'s, two half-steps an iteration on the G grid, each
two carries read and one written at the memory rate, over the device
time a volume outside the deskew. No count of terms, passes or kernels
enters it, so it reads the same work whatever algorithm does it.
Nothing on another route or without a trace."""

from gpubench import geometry


def read(ctx):
    return geometry.rl_roofline(ctx, geometry.TERM_ROUTES)
