"""Flight recorder of the port (twin of ``dist_dqn_tpu/telemetry/flight.py``):
a fixed-size ring of structured runtime events.

The registry answers "how fast is it going"; the flight recorder answers
"what were the last N things this process did before it died or hung".
Every interesting host-side event (span close, queue put/get, chunk
fence, train event, watchdog or sentinel trip) lands in one per-process
ring of ``capacity`` events; the tail is dumped into every forensics
bundle (telemetry/watchdog.py) and served live at ``/debug/flight``
(telemetry/server.py).

  * Safe on a hot path: ``record()`` is one clock read, one tuple build
    and one ring store under a REENTRANT lock (the SIGTERM forensics dump
    runs on the main thread and may interrupt a frame already inside the
    critical section; telemetry/lifecycle.py). About a microsecond in
    CPython; ``chip_smoke.py`` prints the cost on the card's host.
  * Stdlib only: actor and feeder processes load no torch, and they
    record too.
  * A null twin: ``NullFlightRecorder`` carries the same surface at
    about zero cost; ``--no-flight-recorder`` (train CLI) or
    ``DQN_FLIGHT_RECORDER=0`` (the environment, which spawned actor and
    feeder processes inherit) swaps it in, so call sites never branch.

Events are tuples in the ring and dicts on the way out (``tail()``):
``{"t": unix_time, "thread": name, "kind": ..., "name": ..., **args}``.
``kind`` is a coarse taxonomy ("span", "instant", "counter", "chunk",
"queue", "fence", "train", "watchdog", "divergence") so a bundle reader
can filter without knowing every event name. No device value is ever
read here: callers pass host scalars.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

#: Environment knobs (inherited by spawned actor/feeder processes):
#: ``DQN_FLIGHT_RECORDER=0`` disables, ``DQN_FLIGHT_CAPACITY=N`` sizes
#: the ring.
ENABLE_ENV = "DQN_FLIGHT_RECORDER"
CAPACITY_ENV = "DQN_FLIGHT_CAPACITY"

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Lock-light ring of the last ``capacity`` structured events."""

    enabled = True

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(
                f"flight recorder capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._total = 0
        self._lock = threading.RLock()

    def record(self, kind: str, name: str, **args) -> None:
        """Append one event; O(1), overwrites the oldest when full."""
        ev = (time.time(), threading.current_thread().name, kind, name,
              args or None)
        with self._lock:
            self._buf[self._total % self.capacity] = ev
            self._total += 1

    @property
    def total(self) -> int:
        """Events ever recorded (``total - capacity`` were overwritten)."""
        return self._total

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        """The newest ``n`` (default: all retained) events, oldest first,
        as JSON-able dicts."""
        with self._lock:
            total = self._total
            held = min(total, self.capacity)
            take = held if n is None else max(0, min(int(n), held))
            start = total - take
            events = [self._buf[i % self.capacity]
                      for i in range(start, total)]
        out = []
        for t, thread, kind, name, args in events:
            ev = {"t": t, "thread": thread, "kind": kind, "name": name}
            if args:
                ev.update(args)
            out.append(ev)
        return out

    def snapshot(self) -> Dict:
        """JSON-able dump for forensics bundles and ``/debug/flight``."""
        return {"capacity": self.capacity, "total": self._total,
                "events": self.tail()}


class NullFlightRecorder:
    """Disabled path: identical surface, zero work, empty tail."""

    enabled = False
    capacity = 0
    total = 0

    def record(self, kind: str, name: str, **args) -> None:
        pass

    def __len__(self) -> int:
        return 0

    def tail(self, n: Optional[int] = None) -> List[Dict]:
        return []

    def snapshot(self) -> Dict:
        return {"capacity": 0, "total": 0, "events": []}


NULL_FLIGHT = NullFlightRecorder()

_lock = threading.RLock()
_flight = None  # lazy: the first get_flight() reads the environment knobs


def get_flight():
    """The process-global flight recorder (the null twin when disabled)."""
    global _flight
    with _lock:
        if _flight is None:
            if os.environ.get(ENABLE_ENV, "1") == "0":
                _flight = NULL_FLIGHT
            else:
                try:
                    cap = int(os.environ.get(CAPACITY_ENV,
                                             DEFAULT_CAPACITY))
                except ValueError:
                    cap = DEFAULT_CAPACITY
                _flight = FlightRecorder(capacity=cap)
        return _flight


def configure(enabled: bool = True,
              capacity: int = DEFAULT_CAPACITY):
    """Replace the process-global recorder (the train CLI's
    ``--no-flight-recorder``). Call sites that cached the old recorder
    keep their reference: configure before wiring loops."""
    global _flight
    with _lock:
        _flight = FlightRecorder(capacity) if enabled else NULL_FLIGHT
        return _flight


def _reset_for_tests() -> None:
    global _flight
    with _lock:
        _flight = None
