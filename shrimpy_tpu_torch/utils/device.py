"""Device resolution: an explicit ``device`` argument, checked."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None) -> torch.device | None:
    """``torch.device`` for ``device``; raises when CUDA is asked for on
    a machine where ``torch.cuda.is_available()`` is False (never a
    silent CPU run in its place)."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False (no CUDA build of torch or no visible GPU)"
        )
    return dev


def as_tensor(x, device: str | torch.device | None = None) -> torch.Tensor:
    """Tensor view of ``x`` (numpy or tensor), moved to ``device`` when
    one is given (else left where it is; numpy lands on the CPU)."""
    dev = resolve_device(device)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t if dev is None else t.to(dev)
