"""Host time inside the step's call, before the synchronize after it:
the mean over the window's volumes, in milliseconds."""


def read(ctx):
    return 1e3 * sum(v.ret - v.call for v in ctx.volumes) / len(ctx.volumes)
