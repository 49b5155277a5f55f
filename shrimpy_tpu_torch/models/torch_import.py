"""Torch (cytoland) VSUNet checkpoints: the loader (counterpart of
``shrimpy_tpu/models/torch_import.py``).

The JAX package converts a cytoland UNeXt2 state dict to flax params
through a table of names and layout transforms. The port's
:class:`~shrimpy_tpu_torch.models.vsunet.VSUNeXt2` carries cytoland's
names and layouts, so what is left is the file: Lightning's
``state_dict`` unwrapped, the ``model.`` prefix stripped, bfloat16
tensors taken to float32, then a strict load whose error lists the
missing, unexpected and mis-shaped keys as the JAX package's does.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A torch ``.ckpt``/``.pt``/``.pth`` file's weights as float32 CPU
    tensors: Lightning's ``state_dict`` unwrapped and its ``model.`` prefix
    stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.removeprefix("model."): v.detach().float() for k, v in obj.items()}


def load_state(model: nn.Module, state: dict[str, torch.Tensor], architecture: str) -> None:
    """``model.load_state_dict(state, strict=True, assign=True)`` after the
    JAX package's checks: every key present, none unexpected, every shape
    equal, each failure listed."""
    want = model.state_dict()
    missing = [k for k in want if k not in state]
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        raise ValueError(
            f"torch state dict does not match the {architecture} architecture: "
            f"missing keys {missing[:8]}{'...' if len(missing) > 8 else ''}; "
            f"unexpected keys {unexpected[:8]}{'...' if len(unexpected) > 8 else ''} "
            f"({len(missing)} missing / {len(unexpected)} unexpected of {len(want)} expected)")
    for k, v in want.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint {tuple(state[k].shape)} vs "
                             f"model {tuple(v.shape)}")
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True, assign=True)
    logger.info("loaded %d tensors into the %s net", len(want), architecture)
