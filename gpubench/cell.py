"""One run of one cell: set-up, the measured window (traced with
``--trace 1``), the metrics, the check of the window's outputs against
the reference, and the result line.

The program under test is ``shrimpy_tpu_torch``'s reconstruction step,
built once in set-up with ``build_reconstruct_step`` and called as
``reconstruct_store`` calls it per batch, ``step(batch, None)`` on a
``(1, scan, tilt, x)`` float32 tensor on the card.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from gpubench import inputs, reference, spec, trace, window

# Top-level module names no run may hold: JAX and the JAX package (the
# port's own name begins with the latter's, so names compare whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "shrimpy_tpu")
PORT = "shrimpy_tpu_torch"
COUNTER_ATTRS = ("launches", "accel_launches", "cuda_calls")


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names of ``modules`` (default: ``sys.modules``)
    that are JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Context:
    """What a metric's reader sees of a run."""

    cell: str
    config: dict
    traffic: dict
    psf: np.ndarray
    raw_shape: tuple
    out_shape: tuple
    setup_s: float
    volumes: list = field(default_factory=list)
    trace: trace.Trace | None = None
    counters: dict = field(default_factory=dict)

    @property
    def voxels(self) -> int:
        """Output voxels of one volume."""
        return int(np.prod(self.out_shape))


def port_step(config: dict, psf: np.ndarray, device):
    """The program's step for ``config``, built once."""
    from shrimpy_tpu_torch.parallel.pipeline import build_reconstruct_step

    return build_reconstruct_step(port_settings(config), psf=psf, device=device)


def port_settings(config: dict):
    from shrimpy_tpu_torch.config import deconvolve_settings, deskew_settings, reconstruct_settings

    parts = {"deskew": deskew_settings(**config["deskew"])}
    if config.get("deconvolve") is not None:
        parts["deconvolve"] = deconvolve_settings(**config["deconvolve"])
    return reconstruct_settings(**parts)


def port_counters() -> dict:
    """Every launch and plain-call counter the program's loaded modules
    keep on their functions, ``module.function.attribute -> count``."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith(PORT + "."):
            continue
        for fn_name, fn in vars(mod).items():
            if getattr(fn, "__module__", None) != mod_name:
                continue
            for attr in COUNTER_ATTRS:
                count = getattr(fn, attr, None)
                if isinstance(count, int) and not isinstance(count, bool):
                    out[f"{mod_name[len(PORT) + 1:]}.{fn_name}.{attr}"] = count
    return out


def control_step(config: dict, psf: np.ndarray, device):
    """The control in the program's place: the reference computed in
    float32 with every array it keeps rounded to bfloat16."""
    def step(batch, tf=None):
        return torch.stack([reference.reconstruct(raw, psf, config, torch.float32,
                                                  torch.bfloat16).float() for raw in batch])
    return step


def _nbytes(t: torch.Tensor) -> int:
    return t.untyped_storage().nbytes()


class Run:
    """State of one run (``run`` below drives it)."""

    def __init__(self, cell: str, seed: int, seconds: float, traced: bool, *, device: str,
                 make_step, bench: dict, root: Path):
        self.cell, self.seed, self.seconds, self.traced = cell, int(seed), float(seconds), traced
        self.device, self.make_step, self.bench, self.root = device, make_step, bench, root
        self.spec = spec.cell_of(bench, cell, root)
        self.config, self.traffic = self.spec["config"], self.spec["traffic"]
        self.check = self.spec["cell"]["check"]
        self.cuda = device == "cuda"
        loop = (self.traffic.get("loop"), self.traffic.get("in_flight"))
        if loop != window.LOOP:
            raise ValueError(f"traffic {self.spec['entry']['traffic']!r} asks for loop "
                             f"{loop[0]!r} with {loop[1]!r} in flight; the harness drives "
                             f"{window.LOOP[0]!r} with {window.LOOP[1]!r} only")
        unknown = set(self.check) - {"outputs"} - set(reference.COMPARISONS)
        if unknown:
            raise ValueError(f"cell {cell!r} checks {sorted(unknown)}, which the harness "
                             f"does not compute")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def setup(self) -> None:
        cfg = self.config
        self.raw_shape = tuple(cfg["raw_shape"])
        self.psf = inputs.make_psf(cfg["psf"])
        self.raws = inputs.make_raws(self.raw_shape, self.traffic["raw"], self.seed,
                                     int(cfg["distinct_volumes"]), self.device)
        self.sums = [float(r.sum(dtype=torch.float64)) for r in self.raws]
        self.step = (self.make_step or port_step)(cfg, self.psf, self.device)
        # The ring's order from the seed; the warm volumes are the slots
        # just before the window's first, so no volume repeats the raw of
        # the one before it.
        self.rng = random.Random(self.seed)
        n = len(self.raws)
        first = self.rng.randrange(n)
        self.slots = [(first + i) % n for i in range(n)]
        warm = int(self.traffic["warm_volumes"])
        out = None
        for i in range(warm):
            out = self.step(self.raws[self.slots[(i - warm) % n]][None], None)
            self.sync()
        self.out_shape = tuple(out.shape[1:])
        # The check's samples are copied into buffers made here, so the
        # window allocates what the program allocates and nothing more.
        self.kept_bufs = [torch.empty_like(out[0]) for _ in range(int(self.check["outputs"]))]
        del out

    def window(self):
        """The measured window; returns its volumes, the kept outputs and
        (traced) the trace."""
        rng, slots = self.rng, self.slots
        keep = len(self.kept_bufs)
        kept: list = []  # [index, slot, buffer]: a reservoir sample of the window's outputs
        raw_bytes = [_nbytes(r) for r in self.raws]
        held = sum(raw_bytes) + sum(_nbytes(b) for b in self.kept_bufs)
        self.process_peak = torch.cuda.max_memory_allocated() if self.cuda else None

        def call(slot):
            if self.cuda:
                torch.cuda.reset_peak_memory_stats()
            return self.step(self.raws[slot][None], None)

        def on_done(i, slot, out):
            peak = None
            if self.cuda:
                top = torch.cuda.max_memory_allocated()
                self.process_peak = max(self.process_peak, top)
                peak = top - (held - raw_bytes[slot])
            j = i if len(kept) < keep else rng.randrange(i + 1)
            if j < keep:
                buf = self.kept_bufs[j]
                buf.copy_(out[0])
                self.sync()  # between volumes, not inside the next one's time
                if j < len(kept):
                    kept[j] = [i, slot, buf]
                else:
                    kept.append([i, slot, buf])
            return peak

        before = port_counters()
        if not self.traced:
            volumes = window.drive(call, self.sync, slots, self.seconds, on_done)
            return volumes, kept, None, before
        from torch.profiler import ProfilerActivity, profile, record_function

        names = {"call": trace.CALL, "sync": trace.SYNC}
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                volumes = window.drive(call, self.sync, slots, self.seconds, on_done,
                                       around=lambda name: record_function(names[name]))
        return volumes, kept, trace.from_profiler(prof), before

    def metrics(self, ctx: Context) -> dict:
        out = {}
        for m in spec.metrics_of(self.bench, self.cell, self.traced):
            value = spec.load_reader(m["name"], self.root)(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def compare(self, kept) -> tuple[dict, int]:
        """The check: each kept output against the reference of its raw,
        by every number the cell's ``check`` names, and the raws unchanged
        by the run. Returns ``name -> (value, limit)``, each the worst kept
        output's, and how many kept outputs are over a limit."""
        limits = {k: float(v) for k, v in self.check.items() if k != "outputs"}
        changed = sum(float(r.sum(dtype=torch.float64)) != s for r, s in zip(self.raws, self.sums))
        errs = []  # one {name: value} a kept output
        for slot in sorted({s for _, s, _ in kept}):
            ref = reference.reconstruct(self.raws[slot], self.psf, self.config)
            errs += [{k: reference.COMPARISONS[k](out, ref) for k in limits}
                     for _, s, out in kept if s == slot]
            del ref
        numbers = {k: (max((e[k] for e in errs), default=float("inf")), lim)
                   for k, lim in limits.items()}
        numbers["raws_changed"] = (changed, 0)
        return numbers, sum(any(not e[k] <= lim for k, lim in limits.items()) for e in errs)


def run(cell: str, seed: int, seconds: float, traced: bool, *, device: str = "cuda",
        make_step=None, bench: dict | None = None, root: Path = spec.HERE,
        t0: float | None = None, out=None, err=None) -> int:
    """One run of ``cell``; prints the launch counters, then the result
    line as the last line of ``out``, the numbers compared as the last
    lines of ``err``. Returns the exit code: 0, or 2 without the chips
    the cell asks for, or 3 where JAX or the JAX package is loaded at the
    start or just before the result would be printed (nothing on ``out``
    then)."""
    out = out or sys.stdout
    err = err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    bench = bench if bench is not None else spec.load_benchmark(root.parent / "BENCHMARK.json")
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded before the run: {', '.join(bad)} (JAX or the JAX package)",
              file=err)
        return 3
    r = Run(cell, seed, seconds, traced, device=device, make_step=make_step, bench=bench,
            root=root)
    chips = int(r.spec["entry"]["chips"])
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: cell {cell} needs {chips} CUDA device(s), this machine has {have}",
              file=err)
        return 2
    r.setup()
    volumes, kept, tr, before = r.window()
    setup_s = volumes[0].call - t0
    after = port_counters()
    n = len(volumes)
    counters = {k: (after[k] - before.get(k, 0)) / n for k in after}
    ctx = Context(cell, r.config, r.traffic, r.psf, r.raw_shape, r.out_shape, setup_s, volumes,
                  tr, counters)
    metrics = r.metrics(ctx)
    dev = {"platform": "gpu" if r.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if r.cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(r.process_peak or 0)}
    if tr is not None:
        dev["busy_s"] = trace.busy_s(tr)
        dev["window_s"] = tr.window_s
    del r.step
    gc.collect()
    if r.cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, over = r.compare(kept)
    print(f"gpubench: reference of {len({s for _, s, _ in kept})} raw(s) for {len(kept)} "
          f"output(s) took {time.perf_counter() - t_ref:.3f} s", file=err, flush=True)
    correct = all(v <= lim for v, lim in numbers.values())
    result = {"correct": correct, "attempted": n, "failed": over if over or correct else 1,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = trace.breakdown(tr)
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    # Last, with everything after the window loaded (the readers, the
    # reference): a run that holds JAX or the JAX package gives no result.
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded during the run: {', '.join(bad)} (JAX or the JAX package)",
              file=err)
        return 3
    # The launches name the route the step took (``rl_half_step``: the
    # separable one; ``zband`` and no ``rl_half_step``: the FFT one).
    plain = {k: v for k, v in counters.items() if k.endswith(".cuda_calls") and v}
    print("gpubench counters per volume: " + json.dumps(
        {"volumes": n, "plain_calls_on_cuda": plain,
         "counters": {k: v for k, v in sorted(counters.items()) if v}}), file=out, flush=True)
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v!r} limit {lim!r}", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return 0

