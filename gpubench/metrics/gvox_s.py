"""Output voxels of all the window's volumes over the window's seconds,
in billions (host clock)."""

from gpubench import window


def read(ctx):
    return window.rate(ctx.volumes, ctx.voxels) / 1e9
