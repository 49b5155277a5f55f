"""The allocator's peak during a volume, less what the harness held
besides that volume's raw (the ring's other raws, the outputs kept for
the check): what a caller holding one raw needs. The largest over the
window, in GiB; nothing off the card."""


def read(ctx):
    peaks = [v.peak_bytes for v in ctx.volumes if v.peak_bytes is not None]
    return max(peaks) / 2**30 if peaks else None
