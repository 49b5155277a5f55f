"""Separable RL's share of its roofline, in %: RL's least time on the G
grid (two half-steps an iteration, each two carries read and one
written at the memory rate, or its multiply-adds at the float32 peak)
over the device time a volume outside the deskew, whatever kernels do
the work. Nothing on another route or without a trace."""

from gpubench import geometry


def read(ctx):
    return geometry.rl_roofline(ctx, ("separable",), flops=True)
