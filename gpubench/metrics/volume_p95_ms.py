"""The 95th percentile (nearest rank) over all the window's volumes of
the host time from the step's call to the end of the synchronize after
it, in milliseconds."""

from gpubench import window


def read(ctx):
    return window.percentile([v.latency_s for v in ctx.volumes], 95) * 1e3
