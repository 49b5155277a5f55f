"""Per-stage wall-clock + memory telemetry (counterpart of
``shrimpy_tpu/utils/timing.py``), and the spans a profiler trace shows.

PyTorch launches CUDA work asynchronously, so a host clock around a
stage measures the enqueue unless the work is drained first:
:class:`StageTimer` synchronizes the current CUDA stream at both edges
of a stage whenever CUDA is initialised. It waits on that stream only,
not the whole device (``torch.cuda.synchronize()``), so a copy that the
streaming runtime runs on a side stream keeps overlapping the next
stage instead of being drained at every edge. Device memory comes from
the caching allocator (``max_memory_allocated``) and the CUDA runtime
(``mem_get_info``); the trace hook is ``torch.profiler``.

:func:`span` names a stretch of the program on a profiler's timeline
(``shrimpy.volume``, ``shrimpy.rl.iteration``, ...) and costs one flag
check when no profiler records: it never synchronizes.
"""

from __future__ import annotations

import contextlib
import logging
import os
import resource
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger(__name__)


def rss_gb() -> float:
    """Host resident-set size in GiB (``/proc``; peak RSS elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024**3)
    except (OSError, ValueError, IndexError):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1024**2)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` on the profiler's timeline:
    a ``torch.profiler.record_function`` range while a profiler records,
    else one shared no-op context (no op recorded, nothing allocated,
    launched or synchronized). A span nests in the span around it; its
    name carries no index or shape, so spans add up by name."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def _cuda_active() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_stats() -> dict[str, float]:
    """Per-GPU allocator peak and device memory in use, in GiB."""
    stats: dict[str, float] = {}
    if not _cuda_active():
        return stats
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}.peak_allocated"] = torch.cuda.max_memory_allocated(i) / (
            1024**3
        )
        stats[f"cuda:{i}.in_use"] = (total - free) / (1024**3)
    return stats


def _sync() -> None:
    if _cuda_active():
        torch.cuda.current_stream().synchronize()


@dataclass
class StageRecord:
    name: str
    seconds: float
    rss_gb: float


@dataclass
class StageTimer:
    """Accumulates named stage timings for a pipeline run.

    Each stage is also the span ``shrimpy.stage.<name>``.

    Usage::

        timer = StageTimer()
        with timer.stage("deskew"):
            out = deskew(...)
        seconds_by_stage = timer.as_dict()
    """

    records: list[StageRecord] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, log: bool = True):
        _sync()
        t0 = time.monotonic()
        try:
            with span(f"shrimpy.stage.{name}"):
                yield
        finally:
            _sync()
            dt = time.monotonic() - t0
            rec = StageRecord(name, dt, rss_gb())
            self.records.append(rec)
            if log:
                logger.info("stage %-20s %8.3fs  rss=%.2fGiB", name, dt, rec.rss_gb)

    def as_dict(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.seconds
        return out


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace when ``log_dir`` is
    set; the Chrome trace lands in ``log_dir/trace.json``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
