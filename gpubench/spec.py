"""Finding what a run needs by name: ``BENCHMARK.json`` at the root of
the checkout, and in this folder ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json`` and
``metrics/<metric>.py`` (each a ``read(ctx)`` that returns the metric's
value, or None where it finds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(path: Path | None = None) -> dict:
    """``BENCHMARK.json`` beside this folder."""
    path = path or HERE.parent / "BENCHMARK.json"
    return json.loads(Path(path).read_text())


def load_named(kind: str, name: str, root: Path = HERE) -> dict:
    """The JSON file of ``kind`` (``configs``, ``traffic``, ``workloads``)
    called ``name``."""
    path = root / kind / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} {name!r}: {path}")
    return json.loads(path.read_text())


def metrics_of(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones with
    ``--trace 0``, its per-layer ones with ``--trace 1``; a metric with a
    ``workloads`` list belongs to those cells only."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_of(bench: dict, cell: str, root: Path = HERE) -> dict:
    """Everything a run of ``cell`` reads: its ``BENCHMARK.json`` entry,
    its own file (which has to name the same configuration and traffic),
    the configuration and the traffic mix."""
    entries = [w for w in bench["workloads"] if w["name"] == cell]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {cell!r}")
    entry = entries[0]
    own = load_named("workloads", cell, root)
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"workloads/{cell}.json names {key} {own[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return {"entry": entry, "cell": own, "config": load_named("configs", entry["config"], root),
            "traffic": load_named("traffic", entry["traffic"], root)}


def load_reader(name: str, root: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
