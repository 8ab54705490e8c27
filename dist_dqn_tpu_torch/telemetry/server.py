"""The ``/healthz`` body of the port (twin of ``healthz_body`` in
``dist_dqn_tpu/telemetry/server.py``).

Every HTTP surface of a process answers ``/healthz`` with this one body,
so a failing health probe flips them all at once. The standalone
telemetry endpoint (``TelemetryServer``, ``start_server`` and the
``--telemetry-port`` flags) is not ported yet (ROADMAP.md A10); the
serving tier's act server already serves ``/metrics`` and ``/healthz``.
"""
from __future__ import annotations

import json

from dist_dqn_tpu_torch.telemetry import watchdog as watchdog_mod


def healthz_body():
    """(status, body): 200 ``ok`` when no health probe reports trouble;
    503 + JSON naming the failing probes otherwise
    (telemetry/watchdog.py ``health_state``). Shared with the serving
    tier's HTTP surface (dist_dqn_tpu_torch/serving/server.py) so
    /healthz means the same thing on every endpoint of a process."""
    ok, detail = watchdog_mod.health_state()
    if ok:
        return 200, b"ok\n"
    return 503, (json.dumps({"status": "unhealthy", **detail},
                            sort_keys=True) + "\n").encode()
