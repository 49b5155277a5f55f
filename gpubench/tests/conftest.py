"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's
layout in a temporary directory with tiny cells of the two
configurations, run on the CPU through the program's plain path."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from gpubench import spec

TINY_RAW = [64, 16, 24]


def tiny_layout(dest: Path) -> Path:
    """``dest/BENCHMARK.json`` and ``dest/gpubench/`` with the real
    metrics and, beside the real configurations, cells ``tiny-sep.rl3``
    and ``tiny-fft.rl3``: the same settings and checks at a raw of
    ``TINY_RAW``, RL-3 and small PSFs. Returns the folder."""
    root = dest / "gpubench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    sep = spec.load_named("configs", "mantis-ls-sep")
    sep.update(raw_shape=TINY_RAW, psf={"kind": "gaussian", "shape_zyx": [3, 5, 5],
                                        "sigma_zyx": [0.8, 1.2, 1.5]})
    sep["deconvolve"]["iterations"] = 3
    fft = copy.deepcopy(sep)
    fft["psf"] = {"kind": "tilted_gaussian", "shape_zyx": [5, 9, 9], "shears": [0.9, 0.8],
                  "sigma_zyx": [1.0, 1.5, 2.5]}
    fft["deconvolve"]["algorithm"] = "fft"
    traffic = spec.load_named("traffic", "ring4-closed")
    traffic["raw"]["structures"] = 40
    files = {"configs/tiny-sep.json": sep, "configs/tiny-fft.json": fft,
             "traffic/tiny.json": traffic}
    bench = spec.load_benchmark()
    bench["workloads"] = []
    for cell, config, real in (("tiny-sep.rl3", "tiny-sep", "ls-sep.rl20"),
                               ("tiny-fft.rl3", "tiny-fft", "ls-fft.rl20")):
        files[f"workloads/{cell}.json"] = {"config": config, "traffic": "tiny",
                                           "check": spec.load_named("workloads", real)["check"]}
        bench["workloads"].append({"name": cell, "config": config, "traffic": "tiny",
                                   "chips": 1, "why": "a test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny-sep.rl3" if "sep" in w else "tiny-fft.rl3"
                              for w in m["workloads"]]
    for name, body in files.items():
        (root / name).write_text(json.dumps(body))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture()
def tiny(tmp_path) -> Path:
    return tiny_layout(tmp_path)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture()
def run_tiny(tiny):
    """``run_tiny(cell, seed, seconds=0.3, traced=False, make_step=None)``:
    one run on the CPU; returns ``(exit code, stdout lines, stderr lines,
    the last line's JSON or None)``."""
    import io

    from gpubench import cell as cell_mod

    def go(cell, seed, seconds=0.3, traced=False, make_step=None, **kw):
        out, err = io.StringIO(), io.StringIO()
        rc = cell_mod.run(cell, seed, seconds, traced, device="cpu", make_step=make_step,
                          bench=spec.load_benchmark(tiny.parent / "BENCHMARK.json"), root=tiny,
                          out=out, err=err, **kw)
        lines, errs = out.getvalue().splitlines(), err.getvalue().splitlines()
        result = json.loads(lines[-1]) if rc == 0 and lines else None
        return rc, lines, errs, result

    return go
