"""Acquisition engine (counterpart of ``shrimpy_tpu/engine``): run control,
acquisition plans, replay sources, autoexposure and autofocus.

Run control (``control.py``) loads with the standard library alone and is
imported here. The plan (``plan.py``: pydantic and yaml) and the replay
source (``replay.py``: tensorstore through ``io/ngff.py``) are served at
first access, as ``shrimpy_tpu_torch.config`` serves its pydantic models, so
``import shrimpy_tpu_torch.engine.autofocus`` on a host with torch alone
loads neither. The event loop (``engine.py``) and the dual-arm session
(``dual.py``) are ROADMAP queue 1 item 12c.
"""

from shrimpy_tpu_torch.engine.control import AbortRun, RunControl  # noqa: F401

# Names served lazily, by module: they need pydantic and yaml (plan) or
# tensorstore (replay).
_LAZY = {
    "AcquisitionPlan": "plan",
    "AcqEvent": "replay",
    "ReplayCamera": "replay",
    "ReplaySource": "replay",
    "SequencedBurst": "replay",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
