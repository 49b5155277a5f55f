"""Ported ops: deskew and separable Richardson-Lucy, each with a plain
PyTorch version and a hand-written CUDA kernel."""
