"""Virtual-staining checkpoint sidecar contract (jax-free).

The port's own copy of ``shrimpy_tpu/config/vs_sidecar.py`` (read by the
schema's ``DynaTrackConfig`` validator).

The single source of truth for the ``vs_model.json`` sidecar written
next to orbax VS checkpoints (see
:meth:`shrimpy_tpu.models.vsunet.VirtualStainer.save_ckpt`) and for the
default target-channel names — shared by the heavy model layer and the
light config layer (which must stay importable without flax/jax).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

logger = logging.getLogger(__name__)

CKPT_SIDECAR = "vs_model.json"
DEFAULT_OUT_CHANNELS = ["vs_nuclei", "vs_membrane"]


def read_vs_sidecar(ckpt_path: str | Path) -> dict | None:
    """The checkpoint's architecture sidecar, or None if absent/bad."""
    path = Path(ckpt_path) / CKPT_SIDECAR
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        logger.warning("unreadable VS sidecar %s (ignored)", path)
        return None
