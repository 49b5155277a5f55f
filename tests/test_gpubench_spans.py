"""The benchmark's reading of the port's spans (``gpubench/spans.py`` and
the readers of ``rl_edges_ms``, ``elementwise_ms.fft``, ``step_sync_ms``,
``step_syncs``, ``alloc_calls``) on hand-made traces: device events
linked to their launches by order between synchronizes, to the innermost
span; what cannot be linked; the host calls inside the step's call; the
idle gaps' labels."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import spans, spec, trace
from gpubench.trace import Trace

torch.set_num_threads(1)

CALL, SYNC = trace.CALL, trace.SYNC
DESKEW, RL, VOLUME = "shrimpy.deskew", "shrimpy.rl", "shrimpy.volume"
START, ITER, CROP = spans.START, spans.ITERATION, spans.CROP


def _volume_trace(extra_device=()) -> Trace:
    """One volume: the deskew, RL's start (a pageable copy, the stream
    synchronize it forces, a pad, an allocator miss), two iterations (a
    transform and an elementwise pass each), the crop; then the
    harness's synchronize and its copy of the output."""
    t = Trace(start_us=0.0, end_us=1000.0)
    t.host = [
        (CALL, 0, 500), (VOLUME, 1, 480), (DESKEW, 2, 50), ("cudaLaunchKernel", 5, 8),
        (RL, 60, 470), (START, 61, 150), ("cudaMemcpyAsync", 70, 80),
        ("cudaStreamSynchronize", 80, 100), ("aten::index_select", 105, 115),
        ("cudaLaunchKernel", 110, 112), ("cudaMalloc", 120, 130),
        (ITER, 160, 300), ("cuLaunchKernel", 170, 172), ("cudaLaunchKernel", 180, 182),
        (ITER, 300, 440), ("cuLaunchKernel", 310, 312), ("cudaLaunchKernel", 320, 322),
        (CROP, 445, 470), ("cudaMemcpyAsync", 450, 452),
        (SYNC, 500, 900), ("cudaDeviceSynchronize", 501, 890),
        ("cudaMemcpyAsync", 905, 906), ("cudaFree", 920, 925),
    ]
    t.device = sorted([
        ("void deskew_kernel<true>", 10, 60), ("Memcpy HtoD (Pageable -> Device)", 81, 82),
        ("void scatter_gather_elementwise_kernel", 115, 125), ("regular_fft_r2c<1920u>", 175, 200),
        ("vectorized_elementwise_kernel<4, clamp>", 200, 230), ("regular_fft_c2r<1920u>", 315, 340),
        ("vectorized_elementwise_kernel<4, mul>", 340, 370), ("Memcpy DtoD (Device -> Device)", 455, 480),
        ("Memcpy DtoD (Device -> Device)", 910, 915), *extra_device], key=lambda e: e[1])
    return t


def _ctx(tr, volumes=1):
    return SimpleNamespace(trace=tr, volumes=[None] * volumes)


def test_device_events_link_to_the_innermost_span_of_their_launch():
    t = _volume_trace()
    assert spans.link(t).where == [DESKEW, START, START, ITER, ITER, ITER, ITER, CROP, spans.OUTSIDE]
    assert spans.link(t).volumes == 1
    assert spans.unlinked_share(t, spans.link(t)) == pytest.approx(100 * 5 / 201)


def _second_volume(t: Trace) -> None:
    """A second call after the first: the deskew alone."""
    t.host += [(CALL, 1000, 1100), (VOLUME, 1001, 1090), (DESKEW, 1002, 1050),
               ("cudaLaunchKernel", 1005, 1008)]
    t.device.append(("void deskew_kernel<true>", 1010, 1060))
    t.end_us = 1200.0


def test_an_event_with_no_recorded_launch_leaves_its_volume_unlinked():
    """A copy a library issued through a call the profiler keeps no record
    of: its volume is unlinked, the next volume is found again by its
    kinds, the unlinked share says how much was left out, and the span
    readers read the volumes linked whole."""
    t = _volume_trace(extra_device=[("Memcpy HtoD (Pageable -> Device)", 232, 233)])
    _second_volume(t)
    links = spans.link(t)
    assert links.where == [None] * 10 + [DESKEW] and links.volumes == 1
    total = sum(e - s for _, s, e in t.device)
    assert spans.unlinked_share(t, links) == pytest.approx(100 * (1 - 50 / total))
    assert spec.load_reader("rl_edges_ms")(_ctx(t, volumes=2)) == 0.0


def _volumes(n: int, drop: int | None = None) -> Trace:
    """``n`` volumes that issue the same sequence (a deskew, a pageable
    copy and a pad in RL's start); the device record of the copy of volume
    ``drop`` is lost."""
    t = Trace(start_us=0.0, end_us=1000.0 * n)
    for v in range(n):
        o = 1000.0 * v
        t.host += [(CALL, o, o + 500), (VOLUME, o + 1, o + 480), (DESKEW, o + 2, o + 50),
                   ("cudaLaunchKernel", o + 5, o + 8), (START, o + 60, o + 150),
                   ("cudaMemcpyAsync", o + 70, o + 80), ("cudaStreamSynchronize", o + 80, o + 100),
                   ("cudaLaunchKernel", o + 110, o + 112)]
        t.device += [("void deskew_kernel<true>", o + 10, o + 60)]
        if v != drop:
            t.device += [("Memcpy HtoD (Pageable -> Device)", o + 81, o + 82)]
        t.device += [("void pad_kernel", o + 115, o + 125)]
    return t


def test_a_volume_with_a_lost_record_does_not_take_the_next_volumes_events():
    """Every volume issues the same kinds, so the events of the volume
    after a broken one would match its calls: the search stays within half
    a volume, the broken volume is left unlinked, and the rest link."""
    links = spans.link(_volumes(4, drop=1))
    assert links.volumes == 3
    assert links.where == [DESKEW, START, START] + [None, None] + [DESKEW, START, START] * 2
    assert spans.link(_volumes(4)).volumes == 4


@pytest.mark.parametrize("moved,to", [(81, 116), (175, 203)])
def test_a_device_clock_jump_leaves_its_volume_unlinked(moved, to):
    """A device timestamp that jumps puts an event inside another of the
    same stream, which runs one at a time: its order by start is not to be
    trusted (a copy after a kernel, or two kernels swapped, their kinds
    alike), so that volume is left unlinked and the next one links."""
    t = _volume_trace()
    t.device = [(n, to, to + e - s) if s == moved else (n, s, e) for n, s, e in t.device]
    t.device.sort(key=lambda e: e[1])
    _second_volume(t)
    links = spans.link(t)
    assert links.where == [None] * 9 + [DESKEW] and links.volumes == 1


def test_a_call_with_no_device_event_leaves_its_volume_unlinked():
    t = _volume_trace()
    t.host.append(("cudaMemsetAsync", 190, 191))
    _second_volume(t)
    assert spans.link(t).where == [None] * 9 + [DESKEW]


def test_device_clock_off_the_hosts_links_all_the_same():
    """The profiler's device timestamps can sit milliseconds before or
    after the host's, and a pageable copy can show after the synchronize
    that waited on it: pairing by order never compares the two clocks."""
    want = [DESKEW, START, START, ITER, ITER, ITER, ITER, CROP, spans.OUTSIDE]
    for offset in (-3000.0, 3000.0):
        t = _volume_trace()
        t.device = [(n, s + offset, e + offset) for n, s, e in t.device]
        assert spans.link(t).where == want
    t = _volume_trace()
    t.device = [("Memcpy HtoD (Pageable -> Device)", 100.5, 101.5) if e[1] == 81 else e
                for e in t.device]
    assert spans.link(t).where == want


def test_kinds_that_disagree_are_not_linked():
    t = _volume_trace()
    t.device = [("void pad_kernel", 455, 480) if e[1] == 455 else e for e in t.device]
    assert spans.link(t).where == [None] * 9


def test_innermost_of_nested_ranges():
    ranges = [("a", 0, 10), ("b", 1, 5), ("c", 2, 3), ("d", 6, 9)]
    assert spans.innermost(ranges, [0, 1.5, 2.5, 3, 5, 7, 9.5, 10, 11]) == [
        "a", "b", "c", "b", "a", "d", "a", None, None]


@pytest.mark.parametrize("name,want", [
    ("rl_edges_ms", (1 + 10 + 25) / 1e3),
    ("elementwise_ms.fft", (30 + 30) / 1e3),
    ("step_sync_ms", (10 + 20 + 2) / 1e3),
    ("step_syncs", 3.0),
    ("alloc_calls", 1.0),
])
def test_each_reader_on_a_hand_made_volume(name, want):
    read = spec.load_reader(name)
    assert read(_ctx(_volume_trace())) == pytest.approx(want)
    t = _volume_trace()
    _second_volume(t)  # the deskew alone: the same totals over two volumes
    assert read(_ctx(t, volumes=2)) == pytest.approx(want / 2)
    assert read(_ctx(None)) is None
    assert read(_ctx(Trace(host=[(CALL, 0, 10)], end_us=10.0))) is None  # a run on the CPU


@pytest.mark.parametrize("name", ["rl_edges_ms", "elementwise_ms.fft"])
def test_span_readers_read_nothing_from_a_program_without_spans(name):
    t = _volume_trace()
    t.host = [h for h in t.host if not h[0].startswith(spans.PREFIX)]
    assert spec.load_reader(name)(_ctx(t)) is None


def test_host_readers_count_only_the_steps_call():
    """The harness's own synchronize and copy after the call are not the
    step's: they leave ``step_syncs`` and ``alloc_calls`` as they are."""
    t = _volume_trace()
    t.host += [("cudaStreamSynchronize", 950, 960), ("cudaMalloc", 960, 970)]
    assert spec.load_reader("step_syncs")(_ctx(t)) == 3.0
    assert spec.load_reader("alloc_calls")(_ctx(t)) == 1.0


def test_the_new_metrics_are_declared_for_both_cells():
    bench = spec.load_benchmark()
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("rl_edges_ms", "step_sync_ms", "step_syncs", "alloc_calls"):
        assert layer[name]["workloads"] == ["ls-sep.rl20", "ls-fft.rl20"]
    assert layer["elementwise_ms.fft"]["workloads"] == ["ls-fft.rl20"]
    for name in ("rl_edges_ms", "elementwise_ms.fft", "step_sync_ms", "step_syncs", "alloc_calls"):
        assert layer[name]["moves"] == "gvox_s" and layer[name]["source"] == "device_trace"


def test_gap_labels_gain_the_span_and_stay_as_they_were_without_one():
    t = _volume_trace()
    bare = Trace(device=t.device, host=[h for h in t.host if not h[0].startswith(spans.PREFIX)],
                 start_us=t.start_us, end_us=t.end_us)
    for at in (3, 85, 125, 250, 600, 950):
        assert spans.gap_label(bare, at) == trace.host_at(bare, at)
    assert spans.gap_label(t, 85) == f"{CALL}: {START}: cudaStreamSynchronize"
    assert spans.gap_label(t, 250) == f"{CALL}: {ITER}"
    assert spans.gap_label(t, 600) == f"{SYNC}: cudaDeviceSynchronize"
    assert spans.gap_label(t, 950) == "between volumes"
    # Without spans, the breakdown's gaps read as gap_label names them.
    gaps = sorted(trace.idle_gaps(bare), key=lambda g: g[0] - g[1])
    assert [g[0] for g in trace.breakdown(bare)["idle_gaps"]] == [
        spans.gap_label(bare, a) for a, _ in gaps]


def test_span_annotations_on_the_device_timeline_stay_off_the_device_list(monkeypatch):
    """The profiler draws each span again on the device's timeline, flagged
    as a user annotation: ``from_profiler`` keeps it off ``Trace.device``,
    so busy time and every share read the same events as without spans."""
    events = [(trace.WINDOW, False, True, 0.0, 100.0), (VOLUME, False, True, 1.0, 90.0),
              (VOLUME, True, True, 5.0, 60.0), (RL, True, True, 20.0, 60.0),
              ("cudaLaunchKernel", False, False, 2.0, 3.0), ("rl_half_kernel", True, False, 5.0, 60.0)]
    monkeypatch.setattr(trace, "_kineto_events", lambda prof: events)
    t = trace.from_profiler(None)
    assert t.device == [("rl_half_kernel", 5.0, 60.0)]
    assert not any(n.startswith(spans.PREFIX) for n, _, _ in t.device)
    assert trace.busy_s(t) == pytest.approx(55e-6)


def test_readers_on_a_real_cpu_trace_of_the_spanned_step():
    """A window traced on the CPU around the port's step: its spans are host
    ranges of the trace, no device event, and every new reader returns
    nothing without raising."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from shrimpy_tpu_torch import config as tconfig
    from shrimpy_tpu_torch.ops.deconv import gaussian_psf
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    settings = tconfig.reconstruct_settings(
        deskew=tconfig.deskew_settings(px_to_scan_ratio=0.386),
        deconvolve=tconfig.deconvolve_settings(iterations=2))
    step = build_reconstruct_step(settings, psf=gaussian_psf((3, 5, 5), (0.8, 1.2, 1.5)),
                                  device="cpu", plain=True)
    raw = np.ones((1, 40, 12, 20), np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function(CALL):
                step(raw)
    t = trace.from_profiler(prof)
    names = [n for n, _, _ in spans.span_ranges(t)]
    assert names == [VOLUME, DESKEW, RL, START, ITER, ITER, CROP] and t.device == []
    for name in ("rl_edges_ms", "elementwise_ms.fft", "step_sync_ms", "step_syncs", "alloc_calls"):
        assert spec.load_reader(name)(_ctx(t)) is None
