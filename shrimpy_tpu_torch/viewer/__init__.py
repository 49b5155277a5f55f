"""Live visualization of the port: shared-memory frame ring, feeder,
headless monitor and browser GUI (copies of the JAX package's viewer, the
monitor's geometry read without pydantic; see :mod:`.live`)."""

from shrimpy_tpu_torch.viewer.feeder import ViewerFeeder  # noqa: F401
from shrimpy_tpu_torch.viewer.ring import FrameRing  # noqa: F401
