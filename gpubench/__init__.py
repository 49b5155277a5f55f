"""Benchmark of the PyTorch and CUDA reconstruction package
(``shrimpy_tpu_torch``) on NVIDIA GPUs.

Run one cell from the repository root::

    python3 gpubench/run.py --workload ls-sep.rl20 --seed 7 --seconds 45 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics; each lives in a file of its own here, found by its
name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py`` (a measured PSF
is a file under ``psfs/``, named and hashed in its configuration). A cell, a
configuration, a traffic mix or a metric is added by adding files and
entries, never by editing one that is here.

Nothing in this folder imports ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``shrimpy_tpu``; ``reference.py``, ``geometry.py`` and
``inputs.py`` import nothing of ``shrimpy_tpu_torch`` either.
"""
