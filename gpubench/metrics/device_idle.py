"""Share of the traced window in which no device event ran, in %."""

from gpubench import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s(ctx.trace) / ctx.trace.window_s)
