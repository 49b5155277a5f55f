"""Device time a volume launched inside the spans ``shrimpy.rl.start``
and ``shrimpy.rl.crop``: RL's edges (the grid's pads and clamps, the
stencil or OTF builds, the buffers, the crop back to the image, their
copies), in milliseconds, over the volumes ``spans.link`` links whole.
Nothing where the program records no span, or off the card."""

from gpubench import spans


def read(ctx):
    return spans.per_volume_ms(ctx.trace, (spans.START, spans.CROP))
