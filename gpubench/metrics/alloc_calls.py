"""``cudaMalloc`` and ``cudaFree`` calls a volume inside the step's call:
the caching allocator missing (cuFFT's work areas included). Above 0 in
a steady window, the step asks CUDA for memory every volume.
Nothing off the card."""

from gpubench import spans


def read(ctx):
    if not spans.on_device(ctx.trace):
        return None
    return len(spans.in_calls(ctx.trace, spans.ALLOCS)) / len(ctx.volumes)
