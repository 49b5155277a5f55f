"""Device resolution: the card unless the caller says otherwise."""

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
    """Tensor of ``x`` on ``device``. With ``device=None`` a tensor stays
    on the device its caller put it on, and a host array (numpy) goes to
    ``cuda`` — :func:`resolve_device` raises where there is no card, so
    the plain versions never run on the CPU unasked (``device="cpu"``
    asks)."""
    if isinstance(x, torch.Tensor):
        dev = resolve_device(device)
        return x if dev is None else x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device or "cuda"))
