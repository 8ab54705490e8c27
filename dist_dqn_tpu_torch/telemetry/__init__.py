"""Telemetry core of the port (twin of part of ``dist_dqn_tpu/telemetry/``):
the metrics registry, its Prometheus exposition, the serving tier's
metric names and the health half of the watchdog. Stdlib only.

Quick start::

    from dist_dqn_tpu_torch import telemetry

    reg = telemetry.get_registry()
    shed = reg.counter("dqn_serving_shed_total", "requests shed")
    text = telemetry.render_prometheus(reg)

The standalone telemetry endpoint, the stall watchdog's sweeper, the
divergence sentinel, forensics, the flight recorder, fleet registration,
device-time attribution and the exit snapshot dump are not ported yet
(ROADMAP.md A10).
"""
from dist_dqn_tpu_torch.telemetry.exposition import (  # noqa: F401
    CONTENT_TYPE, render_prometheus, snapshot, write_snapshot)
from dist_dqn_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, NullRegistry, Registry,
    get_registry)
from dist_dqn_tpu_torch.telemetry.server import healthz_body  # noqa: F401
from dist_dqn_tpu_torch.telemetry.watchdog import (  # noqa: F401
    Heartbeat, NullHeartbeat, health_state, heartbeat,
    register_health_probe, unregister_health_probe)
