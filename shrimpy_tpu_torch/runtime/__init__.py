"""Streaming store reconstruction (imports tensorstore via shrimpy_tpu_torch.io)."""
