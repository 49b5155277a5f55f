"""The program's spans in a traced window, and the CUDA runtime calls its
host makes: the ``shrimpy.*`` host ranges the port records around its
stages (``shrimpy_tpu_torch/utils/timing.py::span``), which device events
were launched inside each, and what the host waited on.

:class:`~gpubench.trace.Trace` keeps no correlation ids, so a device
event is linked to the host call that issued it by order: on one stream
the device runs operations in the order the host issued them, so the
k-th issue call (a kernel launch, a copy, a memset) is the k-th device
event. A volume where that pairing breaks (an operation a library issued
through a call the profiler does not record, or a jump of the profiler's
device clock) is left unlinked, and :func:`unlinked_share` says how much
of the device's time that left out.

Times are the trace's microseconds.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from gpubench import trace

PREFIX = "shrimpy."
START, ITERATION, CROP = "shrimpy.rl.start", "shrimpy.rl.iteration", "shrimpy.rl.crop"
OUTSIDE = ""  # linked, but issued outside every span

# Host calls that can hold the host until the device catches up: the
# synchronizes, and copies (a pageable source or destination blocks).
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaMemcpyAsync")
# The caching allocator missing: memory asked of, or handed back to, CUDA.
ALLOCS = ("cudaMalloc", "cudaFree")

_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
             "cuLaunchCooperativeKernel")
SHIFT = 8  # a volume is looked for at least this many events either side of its place
OVERLAP_US = 1.0  # two events of one stream that overlap by more were timed wrong


def issue_kind(name: str) -> str | None:
    """``kernel``, ``memcpy`` or ``memset`` for a host call that puts one
    operation on a stream, else None."""
    if name.startswith(_LAUNCHES):
        return "kernel"
    if name.startswith(("cudaMemcpy", "cuMemcpy")):
        return "memcpy"
    if name.startswith(("cudaMemset", "cuMemset")):
        return "memset"
    return None


def device_kind(name: str) -> str:
    """``memcpy``, ``memset`` or ``kernel`` for a device event."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def span_ranges(tr: trace.Trace) -> list:
    """The ``shrimpy.*`` host ranges ``(name, start, end)``, by start."""
    return sorted((h for h in tr.host if h[0].startswith(PREFIX)), key=lambda h: (h[1], -h[2]))


def innermost(ranges: list, times: list) -> list:
    """For each of ``times`` (ascending), the name of the innermost of the
    nested ``ranges`` (by start, outer first at a tie) around it, or
    None."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ranges) and ranges[j][1] <= t:
            while stack and stack[-1][2] <= ranges[j][1]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


class Links(NamedTuple):
    """What :func:`link` found: for each event of ``Trace.device`` the
    innermost span around the call that issued it (:data:`OUTSIDE` where
    that call ran outside every span, None where the event was not
    linked), and how many of the window's volumes were linked whole."""

    where: list
    volumes: int


def link(tr: trace.Trace) -> Links:
    """The device events of ``tr`` linked to the spans they were launched in.

    The device's timestamps can sit milliseconds off the host's in a
    trace, so no host time is compared with a device time. The issue
    calls from one ``gpubench.call`` to the next (a volume, and the
    harness's copies after it) are paired in order with as many device
    events where their kinds agree call for call. A volume is left
    unlinked where they do not (an event or a call without a partner: the
    profiler can drop records in a long window), and where two of its
    events overlap: one stream runs one operation at a time, so an overlap
    means the profiler's device clock jumped there and the events' order
    by start may not be the order they ran in. After a volume whose kinds
    did not agree, the next is found again by its sequence of kinds: the
    nearest match to where it should start, never among events already
    passed, and within half a volume, since every volume issues the same
    sequence and the one after a broken volume must not pass for it."""
    lo, hi = tr.start_us, tr.end_us
    issues = sorted((s, issue_kind(n)) for n, s, _ in tr.host
                    if lo <= s < hi and issue_kind(n) is not None)
    calls = sorted(s for n, s, _ in tr.host if n == trace.CALL)
    volume = [bisect.bisect_right(calls, s) for s, _ in issues]
    first = [bisect.bisect_left(volume, v) for v in range(len(calls) + 2)]
    kinds = [device_kind(n) for n, _, _ in tr.device]
    # overlaps[k]: the events among the first k that start before the one
    # ahead of them ends.
    overlaps = [0]
    for k in range(len(tr.device)):
        overlaps.append(overlaps[-1] + (k > 0 and tr.device[k][1] < tr.device[k - 1][2] - OVERLAP_US))
    pairs = []  # (issue index, device index)
    b = done = whole = 0  # where the volume should start; the events passed so far
    for v in range(len(calls) + 1):
        mine = range(first[v], first[v + 1])
        want = [issues[a][1] for a in mine]
        reach = max(SHIFT, len(want) // 2)
        at = next((x for x in sorted(range(max(done, b - reach), b + reach + 1),
                                     key=lambda x: abs(x - b))
                   if kinds[x:x + len(want)] == want), None)
        if at is None:
            b += len(want)
            continue
        b = done = at + len(want)
        if overlaps[min(b + 1, len(kinds))] == overlaps[at]:
            pairs += zip(mine, range(at, b))
            whole += v > 0
    names = innermost(span_ranges(tr), [issues[a][0] for a, _ in pairs])
    where = [None] * len(tr.device)
    for (_, b), name in zip(pairs, names):
        where[b] = OUTSIDE if name is None else name
    return Links(where, whole)


def device_s(tr: trace.Trace, links: Links, spans=None, keep=None) -> float:
    """Device seconds of the events linked to a span in ``spans`` (any
    span where None) whose name passes ``keep`` (all where None)."""
    return sum(e - s for (name, s, e), where in zip(tr.device, links.where)
               if where and (spans is None or where in spans)
               and (keep is None or keep(name))) / 1e6


def per_volume_ms(tr: trace.Trace, spans, keep=None) -> float | None:
    """:func:`device_s` in milliseconds over the volumes linked whole;
    None where the program records no span or no volume was linked."""
    if not on_device(tr) or not span_ranges(tr):
        return None
    links = link(tr)
    return 1e3 * device_s(tr, links, spans, keep) / links.volumes if links.volumes else None


def unlinked_share(tr: trace.Trace, links: Links) -> float:
    """Share of the device events' time not linked to any span, in %."""
    total = sum(e - s for _, s, e in tr.device)
    inside = device_s(tr, links) * 1e6
    return 100.0 * (1.0 - inside / total) if total > 0 else 0.0


def in_calls(tr: trace.Trace, names) -> list:
    """The host events named in ``names`` that begin inside one of the
    harness's ``gpubench.call`` ranges: the program's own calls."""
    calls = sorted((s, e) for n, s, e in tr.host if n == trace.CALL)
    starts = [s for s, _ in calls]
    out = []
    for n, s, e in tr.host:
        if n in names:
            k = bisect.bisect_right(starts, s) - 1
            if k >= 0 and s < calls[k][1]:
                out.append((n, s, e))
    return out


def on_device(tr: trace.Trace | None) -> bool:
    """Whether ``tr`` is a traced window in which the device ran (not a
    run on the CPU)."""
    return tr is not None and bool(tr.device)


def gap_label(tr: trace.Trace, t_us: float) -> str:
    """:func:`~gpubench.trace.host_at` with the innermost span at ``t_us``
    between the harness's range and the host event: ``gpubench.call:
    shrimpy.rl.start: cudaStreamSynchronize``. The same as ``host_at``
    where no span is open."""
    label = trace.host_at(trace.Trace(host=[h for h in tr.host if not h[0].startswith(PREFIX)]),
                          t_us)
    (name,) = innermost(span_ranges(tr), [t_us])
    if name is None:
        return label
    outer, _, inner = label.partition(": ")
    return f"{outer}: {name}" + (f": {inner}" if inner else "")
