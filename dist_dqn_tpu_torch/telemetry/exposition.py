"""Prometheus text exposition (format 0.0.4) + JSON snapshot rendering
of the port (twin of ``dist_dqn_tpu/telemetry/exposition.py``).

``render_prometheus`` turns a Registry into the plain-text format every
Prometheus-compatible scraper parses (byte for byte the JAX package's
text for the same instruments); ``snapshot`` is the JSON twin for offline
runs. Stdlib only.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from dist_dqn_tpu_torch.telemetry.registry import Registry, get_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels_str(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _escape_help(h: str) -> str:
    return h.replace("\\", r"\\").replace("\n", r"\n")


def render_prometheus(registry: Optional[Registry] = None) -> str:
    """The registry's current state as Prometheus text exposition."""
    registry = registry if registry is not None else get_registry()
    lines = []
    for name, insts in registry.collect().items():
        first = insts[0]
        if first.help:
            lines.append(f"# HELP {name} {_escape_help(first.help)}")
        lines.append(f"# TYPE {name} {first.kind}")
        for inst in insts:
            if inst.kind == "histogram":
                for bound, cum in inst.cumulative_buckets():
                    le = "+Inf" if bound == float("inf") \
                        else _fmt_value(bound)
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_str(inst.labels, {'le': le})} {cum}")
                lines.append(f"{name}_sum{_labels_str(inst.labels)} "
                             f"{_fmt_value(inst.sum)}")
                lines.append(f"{name}_count{_labels_str(inst.labels)} "
                             f"{inst.count}")
            else:
                lines.append(f"{name}{_labels_str(inst.labels)} "
                             f"{_fmt_value(inst.value)}")
    return "\n".join(lines) + "\n"


def snapshot(registry: Optional[Registry] = None) -> Dict:
    """JSON-able snapshot of every instrument (the offline-run twin of
    the /metrics endpoint)."""
    registry = registry if registry is not None else get_registry()
    return registry.snapshot()


def write_snapshot(path: str, registry: Optional[Registry] = None) -> None:
    """Dump ``snapshot()`` to ``path`` as one JSON document."""
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1, sort_keys=True)
        f.write("\n")
