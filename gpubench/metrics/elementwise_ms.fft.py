"""Device time a volume launched inside the span ``shrimpy.rl.iteration``
by kernels that are neither cuFFT's nor the band's: the FFT RL loop's
elementwise passes and copies, in milliseconds, over the volumes
``spans.link`` links whole. Nothing where the program records no span,
or off the card."""

from gpubench import spans, trace


def read(ctx):
    return spans.per_volume_ms(ctx.trace, (spans.ITERATION,),
                               lambda name: trace.kind(name) not in ("transforms", "band"))
