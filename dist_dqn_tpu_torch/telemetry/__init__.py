"""Telemetry plane of the port (twin of ``dist_dqn_tpu/telemetry/``): the
metrics registry, its Prometheus exposition, the metric family names and
collector helpers every runtime records through, the ``/metrics`` scrape
endpoint with its debug surface, the exit-flush lifecycle with the
registry snapshot dump, the run manifest, the chip-time plane (the
program table, the utilization ledger, the learner MFU, device-memory
gauges and on-demand profiles; telemetry/devtime.py), and crash
forensics with the fleet plane. Stdlib at import: the actor and feeder
processes import it, and the chip-time plane imports torch only where it
is used.

Quick start::

    from dist_dqn_tpu_torch import telemetry

    reg = telemetry.get_registry()
    steps = reg.counter("dqn_env_steps_total", "env steps processed")
    server = telemetry.start_server(0)      # ephemeral port: server.port

Serve ``/metrics`` with ``telemetry.start_server(port)``; dump a JSON
snapshot at exit with ``telemetry.install_snapshot_dump(path)`` (or, in
any process that calls ``maybe_install_snapshot_from_env``, through
``DQN_TELEMETRY_SNAPSHOT``).

Crash forensics: ``telemetry.get_flight()`` is the process's
flight-recorder ring, ``telemetry.heartbeat(stage)`` registers a stall-
watchdog heartbeat (the no-op twin until ``install_watchdog`` arms it),
and ``telemetry.observe_divergence(loss=...)`` feeds the NaN/explosion
sentinel; see telemetry/flight.py and telemetry/watchdog.py. The fleet
plane (``register_endpoint``, the aggregator and its CLI) is
telemetry/fleet.py. The chaos plane (``dist_dqn_tpu_torch.chaos``) counts
its injections and recoveries in this registry.
"""
from dist_dqn_tpu_torch.telemetry.devtime import (  # noqa: F401
    IDLE_CAUSES, ProgramRecord, ProgramRegistry, UtilizationLedger,
    capture_profile, device_work, get_program_registry,
    maybe_trace_first_chunk,
    programs_snapshot, register_program, reset_program_registry,
    set_learner_mfu, sweep_device_memory)
from dist_dqn_tpu_torch.telemetry.exposition import (  # noqa: F401
    CONTENT_TYPE, render_prometheus, snapshot, write_snapshot)
from dist_dqn_tpu_torch.telemetry.flight import (  # noqa: F401
    FlightRecorder, NullFlightRecorder, get_flight)
from dist_dqn_tpu_torch.telemetry.lifecycle import (  # noqa: F401
    install_snapshot_dump, maybe_install_snapshot_from_env, on_exit)
from dist_dqn_tpu_torch.telemetry.manifest import (  # noqa: F401
    build_manifest, get_run_manifest, set_run_manifest)
from dist_dqn_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, NullRegistry, Registry,
    get_registry)
from dist_dqn_tpu_torch.telemetry.server import (  # noqa: F401
    TelemetryServer, healthz_body, serve_if_asked, start_server)
from dist_dqn_tpu_torch.telemetry.watchdog import (  # noqa: F401
    DivergenceSentinel, FenceLock, Heartbeat, NullHeartbeat, Watchdog,
    dump_forensics, format_stacks, get_watchdog, health_state, heartbeat,
    install_sentinel, install_watchdog, maybe_install_from_env,
    observe_divergence, register_health_probe, unregister_health_probe)
