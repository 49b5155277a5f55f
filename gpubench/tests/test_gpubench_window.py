"""The window's arithmetic: a rate over whole volumes, the 95th
percentile over all of them, the loop's end."""

import itertools

import pytest

from gpubench import window
from gpubench.window import Volume


def _volumes(latencies, gap=0.0):
    out, t = [], 10.0
    for i, lat in enumerate(latencies):
        out.append(Volume(t, t + lat / 4, t + lat, i % 4))
        t += lat + gap
    return out


def test_rate_counts_whole_volumes_over_their_span():
    vols = _volumes([0.2] * 10, gap=0.01)
    # 10 volumes of 0.2 s with 9 gaps of 0.01 s between the first call and the last end.
    assert window.rate(vols, 591_462_400) == pytest.approx(10 * 591_462_400 / (2.0 + 0.09))
    assert window.span_s(vols) == pytest.approx(2.09)


@pytest.mark.parametrize("n, want", [(200, 190), (201, 191), (20, 19), (1, 1)])
def test_p95_is_nearest_rank_over_all_volumes(n, want):
    values = list(range(1, n + 1))
    assert window.percentile(values[::-1], 95) == want


def test_p95_of_the_window_reads_its_tail():
    lat = [0.2] * 190 + [0.3] * 10
    vols = _volumes(lat)
    assert window.percentile([v.latency_s for v in vols], 95) == pytest.approx(0.2)
    vols = _volumes(lat + [0.3])
    assert window.percentile([v.latency_s for v in vols], 95) == pytest.approx(0.3)


def test_drive_closes_at_the_first_completion_past_the_window(monkeypatch):
    clock = itertools.count(0.0, 0.25)
    monkeypatch.setattr(window.time, "perf_counter", lambda: next(clock))
    seen = []
    vols = window.drive(lambda slot: slot, lambda: None, [2, 3, 0, 1], 2.0,
                        lambda i, slot, out: seen.append((i, slot, out)) or 7)
    # Each volume reads the clock three times (call, return, done), 0.25 s
    # apart: volumes end at 0.5, 1.25 and 2.0 s.
    assert [v.done for v in vols] == [0.5, 1.25, 2.0]
    assert [v.slot for v in vols] == [2, 3, 0]
    assert seen == [(i, s, s) for i, s in enumerate([2, 3, 0])]
    assert all(v.peak_bytes == 7 for v in vols)
