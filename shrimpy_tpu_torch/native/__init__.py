"""First-party native (C) runtime helpers of the port.

The compute path is PyTorch and the CUDA kernels of ``csrc/``; this
package holds the host pieces where the reference relies on native code
and Python cannot give the required semantics: the seqlock
shared-memory frame ring (``ring.c``, the Micro-Manager circular
buffer's role). ``ring.c`` is byte for byte the JAX package's, and
``build.py`` a copy of its loader that caches under the port's own
name. Sources compile lazily with the host's ``cc`` via :mod:`.build`;
without a compiler everything degrades to the pure-Python paths.
"""

from shrimpy_tpu_torch.native.build import load_ring

__all__ = ["load_ring"]
