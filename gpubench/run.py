"""Run one benchmark cell on this machine's GPU.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the program's launch counters per
volume, then as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each number compared beside its limit, which also end
standard error. Exits 2, printing no result, where the machine lacks
the CUDA devices the cell asks for; 3 where JAX or the JAX package is
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # Caches of compilers the program might use, at fixed paths inside the
    # checkout; the program's own kernels build into shrimpy_tpu_torch/build.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench import cell

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return cell.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)


if __name__ == "__main__":
    sys.exit(main())
