"""Mechanical shutter state management.

The reference brackets every acquisition with a shutter save / open /
restore cycle through MMCore (reference
``shrimpy/mantis/archive/pycromanager/microscope_operations.py:536-593``
used at ``acq_engine.py:932-934,1023-1024``): save ``(auto_shutter,
open)``, disable auto-shutter and hold the shutter open for the run,
then restore the saved pair. Getting the RESTORE order right matters on
hardware — re-enabling auto-shutter before restoring the open state
would let the core immediately re-close a shutter the operator had
left open.

No MMCore exists here; :class:`Shutter` is the device model (with an
optional blackout journal for tests) and the module-level trio mirrors
the reference helpers so engine code reads the same.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


class Shutter:
    """One mechanical shutter with MMCore-style auto-shutter."""

    def __init__(self, name: str = "shutter"):
        self.name = name
        self.auto_shutter = True
        self.is_open = False
        self.journal: list[tuple[str, bool]] = []

    def set_auto_shutter(self, value: bool) -> None:
        self.auto_shutter = bool(value)
        self.journal.append(("auto", self.auto_shutter))

    def set_open(self, value: bool) -> None:
        self.is_open = bool(value)
        self.journal.append(("open", self.is_open))


def get_shutter_state(shutter: Shutter) -> tuple[bool, bool]:
    """-> (auto_shutter_state, shutter_state), the save half of the
    bracket (``microscope_operations.py:536-553``)."""
    return shutter.auto_shutter, shutter.is_open


def open_shutter(shutter: Shutter | None) -> None:
    """Disable auto-shutter and hold open for the acquisition
    (``microscope_operations.py:556-569``). No-op without a shutter
    device, like the reference's ``if shutter_device`` guard."""
    if shutter is None:
        return
    logger.debug("Opening shutter %s", shutter.name)
    shutter.set_auto_shutter(False)
    shutter.set_open(True)


def reset_shutter(shutter: Shutter | None, auto_shutter_state: bool,
                  shutter_state: bool) -> None:
    """Restore the saved pair — open state FIRST, then auto-shutter
    (``microscope_operations.py:571-593``)."""
    if shutter is None:
        return
    logger.debug(
        "Resetting shutter %s to Open:%s, Autoshutter:%s",
        shutter.name, shutter_state, auto_shutter_state,
    )
    shutter.set_open(shutter_state)
    shutter.set_auto_shutter(auto_shutter_state)
