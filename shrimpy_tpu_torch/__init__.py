"""shrimpy-tpu-torch — the PyTorch + CUDA port of ``shrimpy_tpu``.

A second package beside the JAX one (which stays the reference the
port is tested against). It mirrors the JAX package's module paths so
each counterpart is easy to find, imports ``torch`` and never ``jax``,
and runs every TPU kernel of the ported paths as a kernel written by
hand for Hopper (``csrc/*.cu``, built by :mod:`shrimpy_tpu_torch.kernels.build`).

Ported so far: the main reconstruction path, deskew followed by
separable Richardson-Lucy on the zero-boundary grid:

  L2  shrimpy_tpu_torch.ops       deskew (+ CUDA kernel), separable RL
                                  (+ CUDA half-step kernel), host plans
  L4  shrimpy_tpu_torch.parallel  single-device reconstruct step
  L5  shrimpy_tpu_torch.runtime   streaming store reconstruction
  L6  shrimpy_tpu_torch.cli       ``shrimpy-tpu-torch`` command group

The compute path (ops, kernels, parallel, utils) imports nothing of
``shrimpy_tpu``, so it runs on a GPU host without jax, pydantic or
tensorstore. Only the store/CLI layer reuses ``shrimpy_tpu.config`` and
``shrimpy_tpu.io``, which import no jax.

On a CPU tensor every kernel wrapper runs its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
