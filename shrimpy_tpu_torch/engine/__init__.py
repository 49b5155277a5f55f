"""Acquisition engine (counterpart of ``shrimpy_tpu/engine``): the event
loop, run control, acquisition plans, replay sources, autoexposure,
autofocus and the dual-arm session.

The event loop (``engine.py``) and run control (``control.py``) load with
torch, numpy and the standard library, and are imported here. The plan
(``plan.py``: pydantic and yaml), the replay source (``replay.py``:
``io/ngff.py`` and its chunk engine) and the dual-arm session (``dual.py``:
pydantic) are served at first access, as ``shrimpy_tpu_torch.config`` serves
its pydantic models, so ``import shrimpy_tpu_torch.engine`` on a host with
torch alone loads none of them.
"""

from shrimpy_tpu_torch.engine.control import AbortRun, RunControl  # noqa: F401
from shrimpy_tpu_torch.engine.engine import (  # noqa: F401
    AcquisitionEngine,
    SkipEvent,
    resolve_acquisition_name,
)

# Names served lazily, by module: they need pydantic and yaml (plan, dual)
# or the store and its chunk codec (replay).
_LAZY = {
    "AcquisitionPlan": "plan",
    "AcqEvent": "replay",
    "DualArmAcquisition": "dual",
    "DualReplayConfig": "dual",
    "ReplayCamera": "replay",
    "ReplaySource": "replay",
    "SequencedBurst": "replay",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
