"""Device-mesh reconstruction: the step on one device or over a
``(batch, space)`` mesh of ranks (``mesh``, ``fft``, ``pipeline``,
``launch``)."""

from shrimpy_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from shrimpy_tpu_torch.parallel.pipeline import (  # noqa: F401
    build_reconstruct_step,
    reconstruct_batch,
)
