"""The readings a cell's check limits are set from, on the card, in one
process: every number the cell's check names, for the program on many
seeds, each a short run at the cell's own load with its outputs sampled
and compared as a benchmark run compares them; for the control, the
reference computed in float32 with every array it keeps in bfloat16 put
in the program's place; and for the program with a fault planted under
the harness (``FAULTS``). The benchmark's own runs never run this.

    python3 gpubench/control.py --workload ls-sep.rl20 --seconds 4 \\
        --seeds 101 102 103 --control-seeds 201 202 203 \\
        --fault dim_voxel --fault-seeds 301 302 303

Prints a JSON line a run (``side``, ``seed``, each number, ``correct``,
``attempted``) and last a summary: for each number the program's largest
reading and the smallest of the control and of each fault.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _near_median(flat: torch.Tensor) -> int:
    """The index of a voxel whose value is nearest the median of an even
    stride of about 2**20 of ``flat``'s."""
    med = flat[::max(1, flat.numel() // (1 << 20))].median()
    return int((flat - med).abs_().argmin())


def _alter(fault: str, out: torch.Tensor) -> None:
    """Plant ``fault`` in the step's output ``out`` in place."""
    flat = out.view(-1)
    if fault == "half_left_out":  # the second half of each volume never computed
        out[:, :, out.shape[2] // 2:] = 0
    elif fault == "peak_voxel":  # the brightest voxel 1 % off
        flat[int(flat.argmax())] *= 1.01
    elif fault == "dim_voxel":  # one voxel near the median 1 % off
        flat[_near_median(flat)] *= 1.01
    elif fault == "background_region":  # a 1 % run of voxels at or below the median 5 % off
        n = flat.numel()
        run = flat[n // 2:n // 2 + max(1, n // 100)]
        med = flat[::max(1, n // (1 << 20))].median()
        run.copy_(torch.where(run <= med, run * 1.05, run))
    else:
        raise ValueError(f"unknown fault {fault!r}")


# A step with one fault under the harness: ``FAULTS[name](config, psf,
# device)`` builds it as ``cell.port_step`` builds the program's.
def _state_unchanged(config, psf, device):  # RL returns its start: the deskew alone
    from gpubench import cell

    return cell.port_step({**config, "deconvolve": None}, psf, device)


def _stale_output(config, psf, device):  # each call returns the one before it
    from gpubench import cell

    step, last = cell.port_step(config, psf, device), {}

    def stale(batch, tf=None):
        out = step(batch, tf)
        prev, last["out"] = last.get("out", out), out
        return prev
    return stale


def _altered(fault):
    def make(config, psf, device):
        from gpubench import cell

        step = cell.port_step(config, psf, device)

        def altered(batch, tf=None):
            out = step(batch, tf)
            _alter(fault, out)
            return out
        return altered
    return make


FAULTS = {"state_unchanged": _state_unchanged, "stale_output": _stale_output}
FAULTS |= {f: _altered(f) for f in ("half_left_out", "peak_voxel", "dim_voxel",
                                    "background_region")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", action="append", default=[], choices=sorted(FAULTS))
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from gpubench import cell

    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, cell.control_step) for s in args.control_seeds]
    runs += [(f, s, FAULTS[f]) for f in args.fault for s in args.fault_seeds]
    readings: dict = {}
    for side, seed, make_step in runs:
        out, err = io.StringIO(), io.StringIO()
        rc = cell.run(args.workload, seed, args.seconds, False, make_step=make_step, out=out,
                      err=err)
        if rc != 0:
            print(err.getvalue(), file=sys.stderr)
            return rc
        result = json.loads(out.getvalue().splitlines()[-1])
        values = {k: v["value"] for k, v in result["check"].items()}
        for k, v in values.items():
            readings.setdefault(side, {}).setdefault(k, []).append(v)
        print(json.dumps({"side": side, "seed": seed, **values, "correct": result["correct"],
                          "attempted": result["attempted"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload}
    for side, numbers in readings.items():
        pick = max if side == "program" else min
        summary[side + ("_max" if side == "program" else "_min")] = {
            k: pick(v) for k, v in numbers.items()}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
