"""cuFFT's kernels' device time a volume, in milliseconds. Nothing
where no transform ran."""

from gpubench import trace


def read(ctx):
    if ctx.trace is None:
        return None
    spent = trace.seconds_by(ctx.trace, trace.kind).get("transforms", 0.0)
    return 1e3 * spent / len(ctx.volumes) if spent > 0 else None
