"""Host-side structured tracing of the port (twin of
``dist_dqn_tpu/utils/trace.py``).

The device program is profiled with torch.profiler (``--profile-dir``,
``/debug/profile``); this module covers the other half of the system —
the learner service's HOST loop (actors/service.py), where Ape-X
throughput is won or lost: record ingestion, trajectory assembly,
priority bootstraps, replay sampling, train-step dispatch.
``SpanTracer`` records wall-clock spans/instants/counters with ~µs
overhead per event (a perf_counter_ns and a tuple append; serialization
happens at flush) and writes the Chrome trace-event format, so traces
open in chrome://tracing or Perfetto next to a torch.profiler device
timeline.

Profiler spans: :func:`span` is the one span of the port that a
torch.profiler capture sees. While a profiler records, it opens a range
the profiler keeps as an op (a host ``cpu_op`` event on the kernels'
clock, nothing on the device track); with none recording it is one flag
check. The fused loop's layers (train_loop.py, replay/, agents/dqn.py)
open it at every boundary, and every tracer's ``span`` opens it too, so
``--profile-dir`` and ``/debug/profile`` captures name the service's
spans as well.

A ``NullTracer`` with the same surface is the disabled path — call sites
never branch.

Registry integration: a live ``SpanTracer`` mirrors its events into the
process telemetry registry — span durations feed the
``dqn_host_span_seconds`` histogram family (one labeled series per span
name), trace counters the ``dqn_trace_counter`` gauge family — so the
Chrome trace and the /metrics endpoint tell one consistent story. Flush
is registered on the shared exit lifecycle (telemetry/lifecycle.py):
traces from atexit'd or SIGTERM'd processes keep every flushed-plus-
buffered event instead of silently losing the tail.

Flight-recorder integration: every span close, instant and counter of a
live ``SpanTracer`` is mirrored into the process flight ring
(telemetry/flight.py), and with no Chrome trace path ``make_tracer(None)``
returns ``FlightTracer``, which records ONLY into that ring while the
recorder is on (the default), so forensics bundles and ``/debug/flight``
carry the service's spans either way. Stdlib only at import: torch is
read from ``sys.modules`` at the first span, so torch-free processes
(spawned actors) never load it.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from dist_dqn_tpu_torch.telemetry import lifecycle
from dist_dqn_tpu_torch.telemetry.flight import get_flight
from dist_dqn_tpu_torch.telemetry.registry import get_registry

#: Span-duration histogram buckets: host-loop spans run ~10µs (ring pop)
#: to whole seconds (first CUDA initialisation under a span, checkpoint
#: writes).
SPAN_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0)


#: The profiler spans of the fused loop (train_loop.py, replay/,
#: agents/dqn.py), in the order a chunk opens them; ``--profile-dir``
#: rows report each.
FUSED_SPANS = (
    "fused.chunk", "fused.act", "fused.env", "fused.ring_add",
    "fused.train", "replay.draw", "replay.gather", "learner.forward",
    "learner.backward", "learner.allreduce", "learner.optimizer",
    "replay.writeback", "fused.episode_stats")

_NO_SPAN = contextlib.nullcontext()
# (is a profiler recording, the op-recording range), bound from torch at
# the first span after torch is loaded.
_profiler = None


def span(name: str):
    """A context manager naming the code it wraps in a torch.profiler
    capture: an op ``name`` (``is_user_annotation`` false) while a
    profiler records, so its interval lies on the clock of the device
    events the code launches and adds no device event; a shared no-op
    otherwise."""
    global _profiler
    if _profiler is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return _NO_SPAN
        _profiler = (torch._C._autograd._profiler_enabled,
                     torch._C._profiler._RecordFunctionFast)
    recording, op_range = _profiler
    if not recording():
        return _NO_SPAN
    return op_range(name)


class NullTracer:
    """No-op twin of SpanTracer (the default when tracing is off): its
    spans reach a running profiler only (:func:`span`)."""

    enabled = False

    def span(self, name: str, **args):
        return span(name)

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class FlightTracer(NullTracer):
    """Span surface that records ONLY into the flight-recorder ring.

    The default tracer when Chrome tracing is off but the flight recorder
    is on: one ``record()`` per span close, instant or counter (about a
    microsecond), no buffering, no file. ``enabled`` stays False: callers
    that gate EXPENSIVE argument computation on ``tracer.enabled`` keep
    skipping it; the ring gets the cheap events.
    """

    def __init__(self, flight=None):
        self._flight = flight if flight is not None else get_flight()

    @contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._flight.record(
                "span", name,
                dur_s=round(time.perf_counter() - start, 6),
                **args)

    def instant(self, name: str, **args) -> None:
        self._flight.record("instant", name, **args)

    def counter(self, name: str, value: float) -> None:
        self._flight.record("counter", name, value=float(value))


class SpanTracer(NullTracer):
    """Chrome trace-event recorder for one host process.

    Events buffer in memory as tuples and serialize on ``flush()`` /
    ``close()`` — the hot path never touches JSON or the filesystem.
    Thread-safe appends (the TCP drain thread traces too); each event
    carries its thread id so Perfetto lays concurrent work out per track.
    """

    enabled = True

    def __init__(self, path: str, process_name: str = "dist_dqn_tpu",
                 registry=None):
        self.path = path
        self.process_name = process_name
        self._events: List[Tuple] = []
        # Reentrant: the SIGTERM exit flush runs on the main thread and
        # can land while an interrupted frame holds this lock mid-append
        # (telemetry/lifecycle.py) — a plain Lock would deadlock there.
        self._lock = threading.RLock()
        self._pid = os.getpid()
        self._t0 = time.perf_counter_ns()
        self._started = False
        self._closed = False
        self.registry = (registry if registry is not None
                         else get_registry())
        self._flight = get_flight()
        self._span_hists: Dict[str, object] = {}
        self._counter_gauges: Dict[str, object] = {}
        # Shared flush lifecycle: a SIGTERM'd/atexit'd process keeps its
        # buffered events (the format tolerates a missing terminator).
        lifecycle.on_exit(self.flush)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _span_hist(self, name: str):
        h = self._span_hists.get(name)
        if h is None:
            h = self.registry.histogram(
                "dqn_host_span_seconds", "host-loop span durations",
                labels={"span": name}, buckets=SPAN_BUCKETS)
            self._span_hists[name] = h
        return h

    @contextmanager
    def span(self, name: str, **args):
        start = self._now_us()
        try:
            with span(name):
                yield
        finally:
            end = self._now_us()
            with self._lock:
                self._events.append(
                    ("X", name, start, end - start,
                     threading.get_ident(), args or None))
            self._span_hist(name).observe((end - start) / 1e6)
            self._flight.record("span", name,
                                dur_s=round((end - start) / 1e6, 6),
                                **(args or {}))

    def instant(self, name: str, **args) -> None:
        with self._lock:
            self._events.append(("i", name, self._now_us(), 0.0,
                                 threading.get_ident(), args or None))
        self._flight.record("instant", name, **args)

    def counter(self, name: str, value: float) -> None:
        with self._lock:
            self._events.append(("C", name, self._now_us(), float(value),
                                 threading.get_ident(), None))
        g = self._counter_gauges.get(name)
        if g is None:
            g = self.registry.gauge("dqn_trace_counter",
                                    "trace counter-track values",
                                    labels={"counter": name})
            self._counter_gauges[name] = g
        g.set(value)

    def flush(self) -> None:
        """Append buffered events to ``path`` and clear the buffer.

        The file is the trace-event JSON-array format, streamed: each flush
        writes only the NEW events (O(new), bounded memory over long runs);
        ``close()`` terminates the array. The format spec allows a missing
        terminator, so a trace from a crashed run still loads in Perfetto.
        """
        with self._lock:
            if self._closed:
                return
            events = self._events
            self._events = []
            first = not self._started
            self._started = True
        lines = []
        if first:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            lines.append("[\n" + json.dumps(
                {"name": "process_name", "ph": "M", "pid": self._pid,
                 "args": {"name": self.process_name}}))
        for ph, name, ts, extra, tid, args in events:
            ev = {"name": name, "ph": ph, "ts": ts, "pid": self._pid,
                  "tid": tid}
            if ph == "X":
                ev["dur"] = extra
            elif ph == "C":
                ev["args"] = {"value": extra}
            elif ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = {**ev.get("args", {}), **args}
            lines.append(json.dumps(ev))
        if not lines:
            return
        mode = "w" if first else "a"
        with open(self.path, mode) as f:
            f.write(",\n".join(lines) if first
                    else ",\n" + ",\n".join(lines))

    def close(self) -> None:
        self.flush()
        # A closed tracer no longer needs the exit-flush hook; dropping
        # it releases this tracer for GC in long-lived processes that
        # construct many tracers (sweeps, test suites).
        lifecycle.off_exit(self.flush)
        with self._lock:
            if self._closed or not self._started:
                self._closed = True
                return
            self._closed = True
        with open(self.path, "a") as f:
            f.write("\n]\n")


def make_tracer(trace_path: Optional[str],
                process_name: str = "dist_dqn_tpu"):
    """Tracer factory: a real SpanTracer when a path is given; the
    flight-ring-only tracer when the flight recorder is on (the default);
    the inert twin when both are off."""
    if trace_path:
        return SpanTracer(trace_path, process_name=process_name)
    flight = get_flight()
    if flight.enabled:
        return FlightTracer(flight)
    return NullTracer()
