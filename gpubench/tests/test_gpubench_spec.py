"""Discovery by name, the benchmark's file against its contract, and a
cell added as new files without editing any that exist."""

import hashlib
import json
import re

import pytest

from gpubench import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def test_every_cell_resolves_by_name():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.cell_of(bench, w["name"])
        assert c["config"]["raw_shape"] and c["traffic"]["loop"] == "closed"
        assert 0 < c["cell"]["check"]["max_rel_err"] < 1e-2
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
    for c in bench["configs"]:
        assert (spec.HERE.parent / c["file"]).is_file()
        assert spec.load_named("configs", c["name"]) == json.loads((spec.HERE.parent / c["file"]).read_text())


def test_metrics_of_a_cell():
    bench = spec.load_benchmark()
    names = lambda cell, traced: [m["name"] for m in spec.metrics_of(bench, cell, traced)]
    assert names("ls-sep.rl20", False) == ["gvox_s", "volume_p95_ms", "peak_gib", "setup_s"]
    assert names("ls-fft.rl20", False) == ["gvox_s", "peak_gib", "setup_s"]
    assert "rl_roofline.sep" in names("ls-sep.rl20", True)
    assert "zband_roofline" not in names("ls-sep.rl20", True)
    assert {"transform_ms.fft", "zband_roofline"} <= set(names("ls-fft.rl20", True))


def test_benchmark_file_keeps_its_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"] == ["python3", "gpubench/run.py"]
    cells = 24  # the most a benchmark may have; later cells run at this length too
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[g]]
    assert len(names) == len(set(names)) and all(NAME.fullmatch(n) for n in names)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()}


def test_a_cell_added_as_new_files_runs(tiny, run_tiny):
    before = _digests(tiny)
    # A new configuration, traffic mix, cell and per-layer metric, each a new file.
    config = spec.load_named("configs", "tiny-sep", tiny)
    config["psf"]["sigma_zyx"] = [1.0, 1.0, 1.0]
    (tiny / "configs" / "tiny-round.json").write_text(json.dumps(config))
    traffic = spec.load_named("traffic", "tiny", tiny)
    traffic["warm_volumes"] = 1
    (tiny / "traffic" / "tiny-one-warm.json").write_text(json.dumps(traffic))
    (tiny / "workloads" / "tiny-round.rl3.json").write_text(json.dumps(
        {"config": "tiny-round", "traffic": "tiny-one-warm",
         "check": {"outputs": 2, "max_rel_err": 1e-4, "voxel_rel_err": 1e-4}}))
    (tiny / "metrics" / "volumes_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.volumes))\n")
    bench_path = tiny.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "tiny-round.rl3", "config": "tiny-round",
                               "traffic": "tiny-one-warm", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "volumes_in_window", "unit": "volumes", "better": "higher",
                               "source": "program_counter", "layer": "step", "moves": "gvox_s",
                               "workloads": ["tiny-round.rl3"]})
    bench_path.write_text(json.dumps(bench))
    after = _digests(tiny)
    assert all(after[p] == d for p, d in before.items())  # nothing that was there changed
    rc, lines, errs, result = run_tiny("tiny-round.rl3", 11, traced=True)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["volumes_in_window"]["value"] == result["attempted"]


def test_a_cell_file_must_agree_with_the_benchmark(tiny):
    bench = json.loads((tiny.parent / "BENCHMARK.json").read_text())
    bench["workloads"][0]["traffic"] = "ring4-closed"
    with pytest.raises(ValueError, match="names traffic"):
        spec.cell_of(bench, "tiny-sep.rl3", tiny)
    with pytest.raises(ValueError, match="not a benchmark name"):
        spec.load_named("configs", "../x", tiny)
    with pytest.raises(KeyError):
        spec.cell_of(bench, "no-such.cell", tiny)
