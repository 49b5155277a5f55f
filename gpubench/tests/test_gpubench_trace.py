"""The trace's arithmetic: the union of device events, the idle share
of the window, what the host was doing in each gap, the breakdown."""

import pytest
import torch

from gpubench import trace
from gpubench.trace import Trace


def _trace():
    t = Trace(start_us=0.0, end_us=100.0)
    t.device = [("deskew_kernel", 0.0, 10.0), ("rl_half_kernel<1>", 5.0, 30.0),
                ("rl_half_kernel<1>", 40.0, 70.0), ("regular_fft_c2r", 69.0, 80.0)]
    t.host = [(trace.CALL, 0.0, 35.0), ("aten::index_select", 31.0, 34.0),
              (trace.SYNC, 35.0, 81.0), ("cudaDeviceSynchronize", 35.0, 80.5)]
    return t


def test_union_counts_overlaps_once():
    assert trace.union_us([(0, 10), (5, 30), (40, 70), (69, 80)]) == 70
    assert trace.union_us([]) == 0


def test_busy_and_idle_of_the_window():
    t = _trace()
    assert trace.busy_s(t) == pytest.approx(70e-6)
    assert t.window_s == pytest.approx(100e-6)
    assert trace.idle_gaps(t) == [(30.0, 40.0), (80.0, 100.0)]


def test_kinds_and_seconds():
    t = _trace()
    by = trace.seconds_by(t, trace.kind)
    assert by == pytest.approx({"deskew": 10e-6, "separable": 55e-6, "transforms": 11e-6})
    assert trace.kind("void zband_reg_kernel<15>(float2 const*)") == "band"
    assert trace.kind("vectorized_elementwise_kernel<4, clamp>") == "elementwise"


def test_breakdown_names_gaps_by_the_host():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["rl_half_kernel<1>", pytest.approx(55e-6)]
    assert b["idle_gaps"][0] == [f"{trace.SYNC}: cudaDeviceSynchronize", pytest.approx(20e-6)]
    assert b["idle_gaps"][1] == [trace.CALL, pytest.approx(10e-6)]
    assert trace.host_at(_trace(), 90.0) == "between volumes"


def test_from_profiler_reads_the_window_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
        with record_function(trace.WINDOW):
            with record_function(trace.CALL):
                torch.ones(8).cumsum(0)
    t = trace.from_profiler(prof)
    assert t.window_s > 0 and t.device == []
    assert any(name == trace.CALL for name, _, _ in t.host)
