"""Throughput metrics of the port (twin of ``dist_dqn_tpu/utils/metrics.py``):
the windowed env-steps/sec and grad-steps/sec rates every runtime logs,
and the JSON-row logger that prints them.

The logger is a registry client: every flush mirrors the rates and extras
into the process telemetry registry (telemetry/), so the same numbers that
land on the JSON-line stream are scrapeable from the ``/metrics`` endpoint
and captured in registry snapshots. Stdlib only.
"""
from __future__ import annotations

import json
import re
import time
from typing import Dict, Optional

from dist_dqn_tpu_torch import telemetry


class RateTracker:
    """Windowed rate estimator for a monotonically increasing counter."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = window_s
        self._events = []  # (t, count) pairs

    def update(self, count: float, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        self._events.append((now, count))
        cutoff = now - self.window_s
        while len(self._events) > 2 and self._events[0][0] < cutoff:
            self._events.pop(0)

    def rate(self, now: Optional[float] = None) -> float:
        """Events/sec over the window — 0 once the window has gone quiet.

        A tracker whose updates STOPPED must not report its last computed
        rate forever: with no event inside the last ``window_s``, the
        honest windowed rate is 0, the same value a fresh tracker
        reports.
        """
        if len(self._events) < 2:
            return 0.0
        now = time.perf_counter() if now is None else now
        (t0, c0), (t1, c1) = self._events[0], self._events[-1]
        if now - t1 >= self.window_s:
            return 0.0
        return (c1 - c0) / max(t1 - t0, 1e-9)


def _metric_name(key: str) -> str:
    """JSON-row key -> registry family name (``dqn_`` + sanitized key)."""
    return "dqn_" + re.sub(r"[^a-zA-Z0-9_]", "_", key)


class MetricLogger:
    """Accumulates scalar metrics; emits one JSON line per flush.

    Every flush also mirrors the row into ``registry`` (the process
    default unless one is passed): the two rates become
    ``dqn_env_steps_per_sec`` / ``dqn_grad_steps_per_sec`` gauges and
    each extra becomes ``dqn_<key>`` — so scrapers see exactly what the
    log stream sees.
    """

    def __init__(self, log_fn=print, num_chips: int = 1, registry=None):
        self.log_fn = log_fn
        self.num_chips = max(num_chips, 1)
        self.env_steps = RateTracker()
        self.grad_steps = RateTracker()
        self._extra: Dict[str, float] = {}
        self.registry = (registry if registry is not None
                         else telemetry.get_registry())
        self._g_env_rate = self.registry.gauge(
            "dqn_env_steps_per_sec", "windowed env-steps/sec (all chips)")
        self._g_env_rate_chip = self.registry.gauge(
            "dqn_env_steps_per_sec_per_chip",
            "windowed env-steps/sec/chip (north-star, BASELINE.json:2)")
        self._g_grad_rate = self.registry.gauge(
            "dqn_grad_steps_per_sec", "windowed learner grad-steps/sec")
        self._extra_gauges: Dict[str, object] = {}

    def record(self, env_steps: Optional[float] = None,
               grad_steps: Optional[float] = None,
               **extra: float) -> None:
        now = time.perf_counter()
        if env_steps is not None:
            self.env_steps.update(env_steps, now)
        if grad_steps is not None:
            self.grad_steps.update(grad_steps, now)
        self._extra.update(extra)

    def _mirror_extra(self, key: str, value) -> None:
        g = self._extra_gauges.get(key)
        if g is None:
            try:
                g = self.registry.gauge(_metric_name(key),
                                        f"mirrored log field {key!r}")
            except ValueError:
                # The sanitized name collides with an existing non-gauge
                # family (a collector's counter/histogram already owns
                # it): that instrument is the canonical series — the
                # mirror stands down permanently for this key instead of
                # crashing the flush.
                g = False
            self._extra_gauges[key] = g
        if g is False:
            return
        try:
            g.set(float(value))
        except (TypeError, ValueError):
            pass  # non-numeric extras stay log-only

    def flush(self) -> Dict[str, float]:
        """Emit one JSON row: the rates plus extras recorded SINCE the last
        flush (one-shot values like eval_return must not go stale-sticky
        into every later throughput row)."""
        env_rate = self.env_steps.rate()
        grad_rate = self.grad_steps.rate()
        row = {
            "env_steps_per_sec_per_chip":
                round(env_rate / self.num_chips, 2),
            "grad_steps_per_sec": round(grad_rate, 2),
        }
        row.update({k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in self._extra.items()})
        self._g_env_rate.set(env_rate)
        self._g_env_rate_chip.set(env_rate / self.num_chips)
        self._g_grad_rate.set(grad_rate)
        for k, v in self._extra.items():
            self._mirror_extra(k, v)
        self._extra.clear()
        self.log_fn(json.dumps(row))
        return row
