"""Where the time of one production step goes, on one NVIDIA GPU.

Run from the repository root: ``python3 profile_step.py``. For each
path ``chip_smoke.py`` drives (deskew + RL-20 and deskew + Biggs RL-10
on the ``fused``, ``fused_iter``, ``linear_pallas`` and ``zy_pallas``
backends, deskew + RL-20 on ``matmul``) it runs one warm step under
``torch.profiler`` and prints:

* ``wall``: host time of the profiled step, launch to synchronise;
* ``busy``: the union of the device events' intervals (kernels, copies,
  memsets) in that step, so overlapping events are counted once;
* ``idle = 1 - busy / wall``;
* ``sum``: the device events' durations added up, and the events by
  name (total ms, count), largest first.

Only device events are read: the CPU-side rows of ``key_averages()``
repeat the time of the kernels they launch.

``python3 profile_step.py --tiles`` instead times the whole-iteration
kernel ``rl_iter`` at the production carry on every (ty, tx) tile of
``ops/rl_fused_iter.py::TILES`` whose rings fit a block (CUDA events,
warm, 5 launches each), each checked against the first tile's output.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch


def device_events(prof):
    """(name, start_us, end_us) of every device event of ``prof``."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def union_us(intervals) -> float:
    busy, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile(step, batch) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    step(batch)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    busy = union_us([(s, e) for _, s, e in events]) / 1e3
    total = sum(e - s for _, s, e in events) / 1e3
    print(f"  wall {wall:.3f} ms; busy {busy:.3f} ms; idle {1 - busy / wall:.4f}; "
          f"sum {total:.3f} ms over {len(events)} device events", flush=True)
    by_name = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:10.3f} ms  x{n:4d}  {name[:100]}", flush=True)


def sweep_tiles(cs) -> None:
    """rl_iter at the production carry, one time per tile that fits."""
    from shrimpy_tpu_torch.ops.rl_fused import _SMEM_BYTES, Stencil
    from shrimpy_tpu_torch.ops.rl_fused_iter import (
        TILES,
        iter_smem_bytes,
        pack_taps,
        rl_iter_cuda,
        tile_threads,
    )

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    terms, carry = cs.production_terms()
    eps = cs.headline_settings().deconvolve.epsilon
    conv, adj = Stencil(terms, device="cuda"), Stencil(terms, flip=True, device="cuda")
    taps = pack_taps(conv, adj, "cuda")
    est, data = cs.uniform(carry, gen, 0.5, 10.5), cs.uniform(carry, gen, 0.0, 5.0)
    out, first = torch.empty_like(est), None
    for tile in TILES:
        smem = iter_smem_bytes(tile, conv.radii, len(terms))
        if smem > _SMEM_BYTES:
            print(f"  tile {tile}: {smem} bytes, does not fit", flush=True)
            continue
        ms = cs.gpu_ms(lambda: rl_iter_cuda(est, data, conv, adj, eps, out, taps=taps,
                                            tile=tile), 5)
        if first is None:
            first = out.clone()
        print(f"  tile {tile} x {tile_threads(tile)} threads: {smem} bytes a block, {ms:.3f} ms a "
              f"launch, max|a-b|/max|b| vs the first tile {cs.rel_err(out, first):.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_step: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from shrimpy_tpu_torch.kernels import build

    print(cs.card_line(), flush=True)
    build.load_library()
    if "--tiles" in sys.argv[1:]:
        sweep_tiles(cs)
        return 0
    steps = cs.Steps(torch.Generator(device="cuda").manual_seed(cs.SEED))
    biggs = {"acceleration": "biggs", "iterations": cs.BIGGS_ITERATIONS}
    for label, kw in (("deskew + RL-20, fused", {}),
                      ("deskew + Biggs RL-10, fused", biggs),
                      ("deskew + RL-20, fused_iter", {"separable_backend": "fused_iter"}),
                      ("deskew + Biggs RL-10, fused_iter",
                       {"separable_backend": "fused_iter", **biggs}),
                      ("deskew + RL-20, linear_pallas", {"separable_backend": "linear_pallas"}),
                      ("deskew + Biggs RL-10, linear_pallas",
                       {"separable_backend": "linear_pallas", **biggs}),
                      ("deskew + RL-20, zy_pallas", {"separable_backend": "zy_pallas"}),
                      ("deskew + Biggs RL-10, zy_pallas",
                       {"separable_backend": "zy_pallas", **biggs}),
                      ("deskew + RL-20, matmul", {"separable_backend": "matmul"})):
        print(f"== {label}", flush=True)
        profile(steps.build(**kw), steps.batch)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
