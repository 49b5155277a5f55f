"""What the benchmark reads from ``torch.profiler``: the device's
events (kernels, copies, memsets), their union (the time the device was
busy), their kinds, and the breakdown a traced run prints (the device
operations that took most time, the longest idle gaps by what the host
was doing).

Times are in the profiler's microseconds; the device's and the host's
events share its clock.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# The harness's own host ranges in a traced window (``record_function``).
WINDOW, CALL, SYNC = "gpubench.window", "gpubench.call", "gpubench.sync"
NAME_CHARS = 120  # a templated kernel's name is cut to this in the breakdown


@dataclass
class Trace:
    """The device's events ``(name, start_us, end_us)`` of one traced
    window, the host's ``(name, start_us, end_us)``, and the window's own
    interval."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    start_us: float = 0.0
    end_us: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6


def _kineto_events(prof):
    """``(name, is_device, is_annotation, start_us, end_us)`` of every
    event the profiler kept, read from its raw results (building
    ``prof.events()``'s tree takes minutes for a window of some hundred
    thousand launches)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, e.is_user_annotation(), start,
                    start + e.duration_ns() / 1e3))
    return out


def from_profiler(prof) -> Trace:
    """The window's events. A host range drawn again on the device's
    timeline (``record_function``'s, the optimizer's) is no device
    event; the window is the harness's own ``gpubench.window`` range."""
    trace = Trace()
    for name, on_device, annotation, start, end in _kineto_events(prof):
        if on_device:
            if not (annotation or name.startswith(("Optimizer.", "gpubench."))):
                trace.device.append((name, start, end))
        elif name == WINDOW:
            trace.start_us, trace.end_us = start, end
        else:
            trace.host.append((name, start, end))
    if trace.end_us <= trace.start_us:
        raise RuntimeError(f"the profiler kept no {WINDOW} range")
    trace.device = sorted((e for e in trace.device if e[2] > trace.start_us and e[1] < trace.end_us),
                          key=lambda e: e[1])
    return trace


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def busy_s(trace: Trace) -> float:
    """Seconds in which some device event ran, inside the window."""
    lo, hi = trace.start_us, trace.end_us
    return union_us([(max(s, lo), min(e, hi)) for _, s, e in trace.device if e > lo and s < hi]) / 1e6


def kind(name: str) -> str:
    """The kind of a device event: the deskew kernel, the separable RL
    kernels, cuFFT's transforms, the FFT RL's band, or the elementwise
    rest (pads, clamps, crops, copies, products)."""
    low = name.lower()
    if "deskew" in low:
        return "deskew"
    if "zband" in low:
        return "band"
    if "fft" in low:
        return "transforms"
    if any(k in low for k in ("rl_half", "rl_iter", "axis_pass", "x_pass", "conv_axis", "conv_x",
                              "convzy", "gemm")):
        return "separable"
    return "elementwise"


def seconds_by(trace: Trace, key) -> dict:
    """Device seconds summed by ``key(name)``."""
    out = defaultdict(float)
    for name, s, e in trace.device:
        out[key(name)] += (e - s) / 1e6
    return dict(out)


def idle_gaps(trace: Trace) -> list:
    """``(start_us, end_us)`` of each stretch of the window in which no
    device event ran."""
    gaps, cursor = [], trace.start_us
    for _, s, e in trace.device:
        if s > cursor:
            gaps.append((cursor, min(s, trace.end_us)))
        cursor = max(cursor, e)
        if cursor >= trace.end_us:
            break
    if cursor < trace.end_us:
        gaps.append((cursor, trace.end_us))
    return [(a, b) for a, b in gaps if b > a]


def host_at(trace: Trace, t_us: float) -> str:
    """What the host was doing at ``t_us``: the harness's range and the
    innermost host event around that instant."""
    outer, inner, inner_len = "between volumes", None, float("inf")
    for name, s, e in trace.host:
        if s <= t_us < e:
            if name in (CALL, SYNC):
                outer = name
            elif e - s < inner_len:
                inner, inner_len = name, e - s
    return outer if inner is None else f"{outer}: {inner}"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``top`` device operations by total seconds and the ``top``
    longest idle gaps, each named by what the host was doing as it
    began."""
    ops = sorted(seconds_by(trace, lambda n: n[:NAME_CHARS]).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[host_at(trace, a), (b - a) / 1e6] for a, b in gaps]}
