"""Host time a volume, inside the step's call, in the CUDA runtime calls
that can hold the host until the device catches up (the synchronizes,
and copies, which block on a pageable buffer), in milliseconds. Nothing
off the card."""

from gpubench import spans


def read(ctx):
    if not spans.on_device(ctx.trace):
        return None
    held = sum(e - s for _, s, e in spans.in_calls(ctx.trace, spans.BLOCKING))
    return held / 1e3 / len(ctx.volumes)
