"""A cell's files, found by the names in ``BENCHMARK.json``.

``configs/<config>.json`` (the configuration as it is run),
``traffic/<traffic>.json`` (the mix: members and their hyperparameters,
chunk length, what the check takes), ``limits/<cell>.json`` (the limit of
each number compared) and ``metrics/<metric>.py`` (a per-layer reader).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[dict] = None) -> Dict[str, object]:
    """Everything one cell runs from: its BENCHMARK.json entry, its
    config, traffic and limits files, and the names of the end-to-end and
    per-layer metrics it reports."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = entries[0]
    limits_path = BENCH_DIR / "limits" / f"{name}.json"

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name, "entry": entry,
        "config": load_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
        "traffic": load_json(BENCH_DIR / "traffic"
                             / f"{entry['traffic']}.json"),
        "limits": load_json(limits_path) if limits_path.exists() else {},
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py`` (loaded by
    path: a metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
