"""The deskew kernel's share of its roofline, in %: the least time of
its work (the raw rows the output needs read once, the output written
once, at the memory rate) over the deskew events' device time a volume.
Nothing where no deskew event ran."""

from gpubench import geometry, trace


def read(ctx):
    if ctx.trace is None:
        return None
    spent = trace.seconds_by(ctx.trace, trace.kind).get("deskew", 0.0) / len(ctx.volumes)
    if spent <= 0:
        return None
    bound = geometry.bound_s(geometry.deskew_bytes(ctx.raw_shape, ctx.config["deskew"]))
    return 100.0 * bound / spent
