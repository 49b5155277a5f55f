"""Streaming store reconstruction (stores through shrimpy_tpu_torch.io's chunk engine)."""
