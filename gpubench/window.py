"""The measured window: a closed loop with one volume in flight, and the
arithmetic its metrics share.

Each volume is timed on the host's clock from the step's call to the
end of the ``synchronize`` after it; the window opens at the first
call and closes at the first completion at or after ``seconds``, so a
rate counts whole volumes over the time they took.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

# The one loop ``drive`` runs, as a traffic mix names it: ``loop`` and
# ``in_flight``. A mix that asks for another is refused, not run as this.
LOOP = ("closed", 1)


@dataclass
class Volume:
    """One volume of the window: host seconds at the step's call, at its
    return, at the end of the synchronize after it; the ring slot of its
    raw; the allocator's peak during it less what the harness held
    besides its raw (None off the card)."""

    call: float
    ret: float
    done: float
    slot: int
    peak_bytes: int | None = None

    @property
    def latency_s(self) -> float:
        return self.done - self.call


def span_s(volumes: list[Volume]) -> float:
    """From the first call to the last completion."""
    return volumes[-1].done - volumes[0].call


def rate(volumes: list[Volume], units_per_volume: float) -> float:
    """Units of all the window's volumes over the window's seconds."""
    return len(volumes) * units_per_volume / span_s(volumes)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of ``values`` at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def drive(call: Callable[[int], object], sync: Callable[[], None], slots: list[int],
          seconds: float, on_done: Callable[[int, int, object], int | None],
          around: Callable[[str], object] | None = None) -> list[Volume]:
    """Run the closed loop: call ``call(slot)`` on the slots in turn
    (``slots`` cycled), ``sync()`` after each, hand each output to
    ``on_done(index, slot, output)``, which returns the volume's
    ``peak_bytes``; stop at the first completion at or
    after ``seconds``. ``around(name)``, where given, is a context
    manager entered around each call (``"call"``) and each synchronize
    (``"sync"``)."""
    volumes: list[Volume] = []
    start = None
    i = 0
    while True:
        slot = slots[i % len(slots)]
        t_call = time.perf_counter()
        if start is None:
            start = t_call
        if around is None:
            out = call(slot)
            t_ret = time.perf_counter()
            sync()
        else:
            with around("call"):
                out = call(slot)
            t_ret = time.perf_counter()
            with around("sync"):
                sync()
        t_done = time.perf_counter()
        volumes.append(Volume(t_call, t_ret, t_done, slot, on_done(i, slot, out)))
        del out
        i += 1
        if t_done - start >= seconds:
            return volumes
