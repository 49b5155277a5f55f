"""Build and bind the hand-written CUDA kernels (``csrc/``)."""
