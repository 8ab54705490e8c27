"""Prometheus scrape endpoint + debug surface of the port (twin of
``dist_dqn_tpu/telemetry/server.py``): a stdlib http.server on a daemon
thread.

``TelemetryServer(port=0)`` binds an ephemeral port (the bound port is on
``.port``) and serves

  * ``/metrics`` and ``/`` — Prometheus text exposition (scrape this)
  * ``/metrics.json`` — the JSON snapshot (same data, offline tooling)
  * ``/healthz`` — liveness probe: 200 ``ok``, or 503 with what failed
    as JSON (telemetry/watchdog.py ``health_state``): stale stage
    heartbeats of an installed watchdog, the latched signals of an armed
    divergence sentinel, failing health probes
  * ``/debug/stacks`` — every live thread's Python stack, by thread NAME
  * ``/debug/config`` — the run manifest (git sha, versions, config
    hash/dict, argv; telemetry/manifest.py) of this process
  * ``/debug/profile?seconds=N`` — a torch.profiler capture of the next N
    seconds (default 1) into the forensics dir (telemetry/devtime.py
    ``capture_profile``); JSON with its ``trace_dir``, 409 while another
    capture runs
  * ``/debug/flight`` — the flight recorder's event tail as JSON
    (telemetry/flight.py)

Every body but the profile capture's is byte for byte the JAX package's
for the same registry contents, health state, flight events and manifest.
The handler renders under the registry's own locks, so a scrape never
blocks a training loop for more than an instrument read. Loopback by
default: the metric/debug surface is unauthenticated. Stdlib only.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from dist_dqn_tpu_torch.telemetry import devtime as devtime_mod
from dist_dqn_tpu_torch.telemetry import flight as flight_mod
from dist_dqn_tpu_torch.telemetry import manifest as manifest_mod
from dist_dqn_tpu_torch.telemetry import watchdog as watchdog_mod
from dist_dqn_tpu_torch.telemetry.exposition import (CONTENT_TYPE,
                                                     render_prometheus,
                                                     snapshot)
from dist_dqn_tpu_torch.telemetry.registry import Registry, get_registry


def healthz_body():
    """(status, body): 200 ``ok`` when nothing armed reports trouble;
    503 + JSON naming stale stages, latched divergence signals and/or
    failing health probes otherwise (telemetry/watchdog.py
    ``health_state``). Shared with the serving tier's HTTP surface
    (dist_dqn_tpu_torch/serving/server.py) so /healthz means the same
    thing on every endpoint of a process."""
    ok, detail = watchdog_mod.health_state()
    if ok:
        return 200, b"ok\n"
    return 503, (json.dumps({"status": "unhealthy", **detail},
                            sort_keys=True) + "\n").encode()


class TelemetryServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[Registry] = None):
        registry = registry if registry is not None else get_registry()

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                status = 200
                if path in ("/metrics", "/"):
                    body = render_prometheus(registry).encode()
                    ctype = CONTENT_TYPE
                elif path == "/metrics.json":
                    body = (json.dumps(snapshot(registry), sort_keys=True)
                            + "\n").encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    status, body = healthz_body()
                    ctype = ("text/plain" if status == 200
                             else "application/json")
                elif path == "/debug/stacks":
                    body = watchdog_mod.format_stacks().encode()
                    ctype = "text/plain"
                elif path == "/debug/flight":
                    body = (json.dumps(flight_mod.get_flight().snapshot())
                            + "\n").encode()
                    ctype = "application/json"
                elif path == "/debug/config":
                    man = manifest_mod.get_run_manifest()
                    body = (json.dumps(man if man is not None else {},
                                       sort_keys=True) + "\n").encode()
                    ctype = "application/json"
                elif path == "/debug/profile":
                    qs = parse_qs(urlsplit(self.path).query)
                    seconds = (qs.get("seconds") or ["1"])[0]
                    result = devtime_mod.capture_profile(seconds)
                    if result.get("error") == "busy":
                        status = 409
                    body = (json.dumps(result, sort_keys=True)
                            + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam the JSON-line log stream

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="telemetry-http", daemon=True)
        self._thread.start()
        #: The fleet descriptor announcing this server (telemetry/fleet.py
        #: ``register_endpoint``), removed when the server closes.
        self.registration = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        if self.registration is not None:
            self.registration.close()
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5)


def start_server(port: int, host: str = "127.0.0.1",
                 registry: Optional[Registry] = None) -> TelemetryServer:
    """Convenience: build + start (port 0 = ephemeral, see ``.port``)."""
    return TelemetryServer(port=port, host=host, registry=registry)


def serve_if_asked(port: Optional[int], host: str, log_fn,
                   role: Optional[str] = None,
                   labels: Optional[dict] = None
                   ) -> Optional[TelemetryServer]:
    """An entry point's ``--telemetry-port``: None serves nothing;
    otherwise the server, its bound port logged through ``log_fn`` as the
    JAX entry points log it, ``{"telemetry_port": N}``. With ``role`` the
    server is announced to the run's fleet after it bound and before the
    port is logged (telemetry/fleet.py ``register_endpoint``; a no-op
    without ``DQN_FLEET_DIR``), and its descriptor goes when it
    closes."""
    if port is None:
        return None
    server = start_server(port, host=host)
    if role is not None:
        from dist_dqn_tpu_torch.telemetry import fleet

        server.registration = fleet.register_endpoint(
            role, server.port, host=host, labels=labels)
    log_fn(json.dumps({"telemetry_port": server.port}))
    return server
