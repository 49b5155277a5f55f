"""The port's spans (``utils/timing.py::span``): the tree the step records
under a profiler on every RL backend, outputs that do not depend on the
profiler, a span that does nothing while no profiler records, and the
spans of ``StageTimer`` and of the CLI's ``--profile`` trace."""

import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shrimpy_tpu_torch import config as tconfig
from shrimpy_tpu_torch.ops.deconv import gaussian_psf
from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step
from shrimpy_tpu_torch.utils import timing
from shrimpy_tpu_torch.utils.timing import StageTimer, profiler_trace, span

torch.set_num_threads(1)

ITERS = 3
WARM = 2  # the hybrid's separable iterations
BACKENDS = {
    "fused": {"separable_backend": "fused"},
    "fused-biggs": {"separable_backend": "fused", "acceleration": "biggs"},
    "fused_iter": {"separable_backend": "fused_iter"},
    "conv3-linear": {"separable_backend": "linear_pallas"},
    "conv3-circular": {"separable_backend": "zy_pallas"},
    "matmul": {"separable_backend": "matmul"},
    "matmul-biggs": {"separable_backend": "matmul", "acceleration": "biggs"},
    "fft3": {"algorithm": "fft", "fft_backend": "fft3"},
    "fft2z": {"algorithm": "fft", "fft_backend": "fft2z"},
    "hybrid": {"algorithm": "hybrid", "hybrid_separable_iters": WARM},
}


def _raw(n=2):
    return (np.random.default_rng(0).random((n, 40, 12, 20)) * 100).astype(np.float32)


def _step(**deconv):
    settings = tconfig.reconstruct_settings(
        deskew=tconfig.deskew_settings(px_to_scan_ratio=0.386),
        deconvolve=tconfig.deconvolve_settings(iterations=ITERS, **deconv))
    return build_reconstruct_step(settings, psf=gaussian_psf((3, 5, 5), (0.8, 1.2, 1.5)),
                                  device="cpu", plain=True)


def span_tree(prof) -> list:
    """The ``shrimpy.*`` ranges of a profile as ``(name, children)``
    nested by their intervals."""
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("shrimpy.")), key=lambda x: (x[1], -x[2]))
    root: list = []
    stack = [(root, math.inf)]
    for name, start, end in events:
        while stack[-1][1] <= start:
            stack.pop()
        children: list = []
        stack[-1][0].append((name, children))
        stack.append((children, end))
    return root


def _leaf(name):
    return (name, [])


def _rl_phase(iterations):
    return ([_leaf("shrimpy.rl.start")] + [_leaf("shrimpy.rl.iteration")] * iterations
            + [_leaf("shrimpy.rl.crop")])


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_step_records_one_volume_span_a_volume_on_every_backend(backend):
    """Each volume is one ``shrimpy.volume`` holding the deskew, then RL:
    one start, an iteration span per iteration and one crop, in that order
    (the hybrid runs two RLs, its separable warm phase and the FFT RL).
    The profiler changes no bit of the output."""
    step = _step(**BACKENDS[backend])
    raw = _raw()
    plain_out = step(raw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced_out = step(raw)
    assert torch.equal(plain_out, traced_out)
    rl = _rl_phase(ITERS) if backend != "hybrid" else _rl_phase(WARM) + _rl_phase(ITERS)
    volume = ("shrimpy.volume", [_leaf("shrimpy.deskew"), ("shrimpy.rl", rl)])
    assert span_tree(prof) == [volume] * raw.shape[0]


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """With no profiler recording, a span is one shared no-op context: the
    step runs with ``record_function`` made to raise, and gives the same
    bits."""
    step = _step(separable_backend="fused")
    raw = _raw(1)
    want = step(raw)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("shrimpy.a") is span("shrimpy.b")
    with span("shrimpy.a") as entered:
        assert entered is None
    assert torch.equal(step(raw), want)


def test_span_is_a_record_function_range_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(span("shrimpy.x"), torch.profiler.record_function)
        with span("shrimpy.x"):
            with span("shrimpy.x.y"):
                torch.ones(4).sum()
    assert span_tree(prof) == [("shrimpy.x", [_leaf("shrimpy.x.y")])]
    assert not torch.autograd._profiler_enabled()
    assert span("shrimpy.x") is timing._OFF


def test_stage_timer_stages_are_spans():
    """``StageTimer.stage`` keeps its records and opens
    ``shrimpy.stage.<name>``, so a ``--profile`` trace of the store loop
    and of tracking names read, compute and write."""
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("read", log=False):
            with span("shrimpy.inner"):
                pass
        with timer.stage("write", log=False):
            pass
    assert span_tree(prof) == [("shrimpy.stage.read", [_leaf("shrimpy.inner")]),
                               _leaf("shrimpy.stage.write")]
    assert [r.name for r in timer.records] == ["read", "write"]


def test_profiler_trace_writes_the_step_spans(tmp_path):
    """The CLI's ``--profile`` exporter writes the step's spans into
    ``trace.json``."""
    step = _step(separable_backend="fused")
    with profiler_trace(str(tmp_path)):
        step(_raw(1))
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"shrimpy.volume", "shrimpy.deskew", "shrimpy.rl", "shrimpy.rl.start",
            "shrimpy.rl.iteration", "shrimpy.rl.crop"} <= names
