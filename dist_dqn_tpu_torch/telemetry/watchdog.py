"""The health half of the stall watchdog (twin of part of
``dist_dqn_tpu/telemetry/watchdog.py``): stage heartbeats, the
``/healthz`` state with its registered health probes, and the named
thread stacks ``/debug/stacks`` serves.

What is here:

  * :class:`Heartbeat` / :class:`NullHeartbeat` and ``heartbeat(stage)``,
    which every pipeline loop wires unconditionally. With no watchdog
    installed, ``heartbeat`` returns the no-op twin, and in the port no
    watchdog can be installed yet, so every heartbeat is the no-op twin
    and loops pay nothing.
  * ``health_state``: the (ok, detail) pair every ``/healthz`` surface of
    the process serves, from the registered health probes
    (``register_health_probe``: the serving tier's SLO tracker flips it).
  * ``format_stacks``: every live thread's Python stack by thread name.

Not here yet (ROADMAP.md A10c): the ``Watchdog`` sweeper thread that
expires heartbeats, the divergence sentinel, forensics bundles, the
flight recorder and the emergency-checkpoint hooks. Until they land,
``health_state`` reports the probes only, which is what the JAX
package's reports in a process with no watchdog installed and an unarmed
sentinel.

Stdlib only.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Dict, Optional


class Heartbeat:
    """One pipeline stage's liveness signal. ``beat()`` is two plain
    float stores (each atomic in CPython) — safe to call from any thread
    at any rate with no lock."""

    __slots__ = ("stage", "deadline_s", "_grace", "_last", "_owner")

    def __init__(self, stage: str, deadline_s: float, owner=None,
                 startup_grace_s: float = 0.0):
        self.stage = stage
        self.deadline_s = float(deadline_s)
        self._grace = float(startup_grace_s)
        self._last = time.monotonic()
        self._owner = owner

    def beat(self) -> None:
        # _last refreshes BEFORE the grace drops: a sweep between the
        # two stores must see (stale age, grace) or (fresh age, no
        # grace) — never (stale age, no grace), a false stall.
        self._last = time.monotonic()
        self._grace = 0.0  # the stage proved itself; normal deadline now

    def age(self, now: Optional[float] = None) -> float:
        return (time.monotonic() if now is None else now) - self._last

    def limit(self) -> float:
        """The currently allowed silence: deadline, plus the startup
        grace until the first beat."""
        return self.deadline_s + self._grace

    @property
    def expired(self) -> bool:
        return self.age() > self.limit()

    def close(self) -> None:
        """Deregister: a stage that FINISHED is not a stall (a completed
        run must not flip /healthz to 503)."""
        if self._owner is not None:
            self._owner.unregister(self.stage)


class NullHeartbeat:
    """No-watchdog twin: loops wire unconditionally, pay nothing."""

    stage = ""
    deadline_s = float("inf")
    expired = False

    def beat(self) -> None:
        pass

    def age(self, now=None) -> float:
        return 0.0

    def close(self) -> None:
        pass


NULL_HEARTBEAT = NullHeartbeat()

_global_lock = threading.RLock()
#: name -> zero-arg probe; see register_health_probe.
_health_probes: Dict[str, object] = {}


def heartbeat(stage: str, deadline_s: Optional[float] = None,
              startup_grace_s: float = 0.0):
    """A stage heartbeat on the global watchdog, or the no-op twin when
    none is installed — call sites never branch. The port installs no
    watchdog yet (ROADMAP.md A10c), so this is always the no-op twin."""
    return NULL_HEARTBEAT


def health_state():
    """(ok, detail) for /healthz: every registered health probe's
    verdict. A probe returning a dict is unhealthy and its dict is served
    under its name; a probe that raises is itself unhealthy."""
    ok, detail = True, {}
    with _global_lock:
        probes = list(_health_probes.items())
    for name, probe in probes:
        try:
            extra = probe()
        except Exception as e:  # a broken probe is itself unhealthy
            extra = {"probe_error": f"{type(e).__name__}: {e}"}
        if extra:
            ok = False
            detail[name] = extra
    return ok, detail


def register_health_probe(name: str, probe) -> None:
    """Add a /healthz contributor: ``probe()`` -> None (healthy) or a
    detail dict (unhealthy; served as 503 JSON under ``name``).
    Re-registering a name replaces its probe."""
    with _global_lock:
        _health_probes[name] = probe


def unregister_health_probe(name: str) -> None:
    with _global_lock:
        _health_probes.pop(name, None)


def format_stacks() -> str:
    """Every live thread's Python stack, labeled with the thread's NAME
    (``sys._current_frames`` keys on ident; ``threading.enumerate``
    provides the mapping): what ``/debug/stacks`` serves. Unnamed threads
    print as ``Thread-N``."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    parts = []
    for ident, frame in sorted(frames.items()):
        t = by_ident.get(ident)
        name = t.name if t is not None else f"<unregistered-{ident}>"
        daemon = t.daemon if t is not None else "?"
        parts.append(f"--- thread {name!r} (ident {ident}, "
                     f"daemon={daemon}) ---")
        parts.append("".join(traceback.format_stack(frame)).rstrip())
        parts.append("")
    return "\n".join(parts)
