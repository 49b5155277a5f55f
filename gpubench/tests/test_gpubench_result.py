"""The result line's shape, at a tiny size on the CPU, and the check's
numbers at the end of standard error."""

import json
import math

import pytest


@pytest.mark.parametrize("cell", ["tiny-sep.rl3", "tiny-fft.rl3"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line(run_tiny, cell, traced):
    rc, lines, errs, result = run_tiny(cell, 2**31 + 977, traced=traced)
    assert rc == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if traced else []) + ["check"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "step_host_ms" in result["metrics"]
    else:
        assert {"gvox_s", "setup_s"} <= set(result["metrics"])
        assert ("volume_p95_ms" in result["metrics"]) == (cell == "tiny-sep.rl3")
        assert all(m["value"] > 0 and m["unit"] for m in result["metrics"].values())
    assert lines[-2].startswith("gpubench counters per volume: ")
    counters = json.loads(lines[-2].split(": ", 1)[1])
    assert counters["volumes"] == result["attempted"] and counters["plain_calls_on_cuda"] == {}
    check = result["check"]
    assert list(check) == ["max_rel_err", "voxel_rel_err", "raws_changed"]
    assert all(v["value"] <= v["limit"] for v in check.values())
    assert errs[-len(check):] == [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in check.items()]
    assert all(math.isfinite(v["value"]) for v in check.values())


def test_same_seed_same_raws():
    import torch

    from gpubench import inputs, spec

    params = spec.load_named("traffic", "ring4-closed")["raw"] | {"structures": 30}
    a = inputs.make_raws((20, 8, 12), params, 2**31 + 5, 2, "cpu")
    b = inputs.make_raws((20, 8, 12), params, 2**31 + 5, 2, "cpu")
    c = inputs.make_raws((20, 8, 12), params, 2**31 + 6, 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert all(bool((x == x.round()).all()) and 0 <= float(x.min()) for x in a)
    assert float(a[0].max()) > params["dark_offset"] + params["peak_counts"][0] / 2


def test_no_cuda_device_no_result(tiny, monkeypatch):
    import io

    import torch

    from gpubench import cell, spec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    rc = cell.run("tiny-sep.rl3", 1, 0.1, False, device="cuda",
                  bench=spec.load_benchmark(tiny.parent / "BENCHMARK.json"), root=tiny,
                  out=out, err=err)
    assert rc == 2 and out.getvalue() == "" and "needs 1 CUDA device" in err.getvalue()


def test_jax_loaded_no_result(run_tiny, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, lines, errs, result = run_tiny("tiny-sep.rl3", 1)
    assert rc == 3 and lines == [] and "jax" in errs[-1]


def test_jax_loaded_after_the_window_no_result(tiny, run_tiny, tmp_path):
    """A metric's reader that imports a module named ``jax``: the run
    prints nothing on standard output and exits 3."""
    import sys

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (tiny / "metrics" / "gvox_s.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(stub)!r})\n"
        "import jax  # noqa: F401\n"
        "sys.path.remove({!r})\n".format(str(stub))
        + "def read(ctx):\n    return 1.0\n")
    had = "jax" in sys.modules
    try:
        rc, lines, errs, result = run_tiny("tiny-sep.rl3", 2**32 + 9)
        assert sys.modules["jax"].__file__.startswith(str(stub))
    finally:
        if not had:
            sys.modules.pop("jax", None)
    assert rc == 3 and lines == [] and result is None
    assert errs[-1].startswith("gpubench: loaded during the run: jax")


@pytest.mark.parametrize("loop", [{"in_flight": 2}, {"loop": "open"}, {"loop": None}])
def test_a_loop_the_harness_does_not_drive_is_refused(tiny, run_tiny, loop):
    traffic = json.loads((tiny / "traffic" / "tiny.json").read_text())
    traffic.update(loop)
    if loop.get("loop", "") is None:
        del traffic["loop"]
    (tiny / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match="the harness drives 'closed' with 1 only"):
        run_tiny("tiny-sep.rl3", 3)


def test_a_check_the_harness_does_not_compute_is_refused(tiny, run_tiny):
    path = tiny / "workloads" / "tiny-sep.rl3.json"
    body = json.loads(path.read_text())
    body["check"]["l2_rel_err"] = 1e-5
    path.write_text(json.dumps(body))
    with pytest.raises(ValueError, match="l2_rel_err"):
        run_tiny("tiny-sep.rl3", 3)
