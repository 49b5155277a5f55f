"""How many CUDA runtime calls that can hold the host (the synchronizes
and copies of ``step_sync_ms``) the step's call makes a volume. Nothing
off the card."""

from gpubench import spans


def read(ctx):
    if not spans.on_device(ctx.trace):
        return None
    return len(spans.in_calls(ctx.trace, spans.BLOCKING)) / len(ctx.volumes)
