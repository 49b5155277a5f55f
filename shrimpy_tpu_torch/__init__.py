"""shrimpy-tpu-torch — the PyTorch + CUDA port of ``shrimpy_tpu``.

A second package beside the JAX one (which stays the reference the
port is tested against). It mirrors the JAX package's module paths so
each counterpart is easy to find, imports ``torch`` and never ``jax``,
and runs every TPU kernel of the ported paths as a kernel written by
hand for Hopper (``csrc/*.cu``, built by :mod:`shrimpy_tpu_torch.kernels.build`).

Ported so far: the main reconstruction path, deskew followed by
separable Richardson-Lucy on every separable backend:

  L1  shrimpy_tpu_torch.config    settings (namespaces; pydantic schemas)
      shrimpy_tpu_torch.io        OME-Zarr stores, synthetic fixtures
  L2  shrimpy_tpu_torch.ops       deskew (+ CUDA kernel), separable RL
                                  (+ CUDA half-step, z+y and
                                  whole-iteration kernels), host plans
      shrimpy_tpu_torch.kernels   the kernel build; the on-chip probes
  L4  shrimpy_tpu_torch.parallel  single-device reconstruct step
  L5  shrimpy_tpu_torch.runtime   streaming store reconstruction
  L6  shrimpy_tpu_torch.cli       ``shrimpy-tpu-torch`` command group

No module of the port imports anything of ``shrimpy_tpu``: the store and
CLI layer has its own copies of the config schemas and the store code
(pydantic, yaml; the stores on the port's own zarr chunk engine,
``io/chunkstore.py``, no tensorstore), and the compute path (ops, kernels,
parallel, utils) runs on a GPU host that has none of those.

On a CPU tensor every kernel wrapper runs its plain PyTorch twin; on a
CUDA tensor it launches the kernel or raises. A host array (numpy) given
to an entry point with no ``device`` goes to the card, and raises where
there is none; pass ``device="cpu"`` to run the plain versions.
"""

__version__ = "0.1.0"
