"""Seconds from the run's start to the first timed volume's call:
imports, the CUDA context, the raws and the PSF, the step's build (and,
in a fresh checkout, the kernels' compilation), the warm volumes."""


def read(ctx):
    return ctx.setup_s
