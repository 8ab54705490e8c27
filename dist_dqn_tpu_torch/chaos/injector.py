"""ChaosInjector of the port (twin of ``dist_dqn_tpu/chaos/injector.py``):
arms a FaultPlan over the named seams.

The injection contract at every seam is two lines::

    ev = chaos.fire("transport.recv")
    if ev is not None: <interpret ev.fault locally>

``fire`` is a no-op (one global read + compare) while nothing is
armed, so the seams cost nothing on production hot paths. When a plan
is armed, every pass through a seam increments that seam's hit
counter; a pending event whose trigger matches (``at_hit`` == count,
or ``at_s`` elapsed) is popped and returned EXACTLY ONCE — the seam
code interprets the fault (drop the frame, raise, sleep, SIGKILL...).

Evidence trail per injection: ``dqn_chaos_injected_total{seam,fault}``,
a flight-recorder event, and — once the surviving path proves itself via
``mark_recovered(seam)`` — ``dqn_recovery_seconds{seam}`` measuring
injection -> recovery, through the writers of telemetry/collectors.py.

Stdlib-only (plus the telemetry registry, itself torch-free): actor and
feeder processes arm their slice of a plan from ``DQN_CHAOS_PLAN``
(inline JSON or a file path), the same env-inheritance pattern as
DQN_FORENSICS_DIR; so do spawned mesh ranks (train.py ``_rank_main``).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from dist_dqn_tpu_torch.chaos.plan import FaultEvent, FaultPlan
from dist_dqn_tpu_torch.telemetry import flight as _flight_mod
from dist_dqn_tpu_torch.telemetry.collectors import (
    chaos_injected_counter, chaos_recovery_histogram)
from dist_dqn_tpu_torch.telemetry.registry import get_registry

#: Env knob: inline JSON plan or a path to one — how spawned actor/
#: feeder/worker processes arm the plan slice their parent exported.
CHAOS_PLAN_ENV = "DQN_CHAOS_PLAN"


class ChaosInjectedError(RuntimeError):
    """An exception fault raised at a seam. A distinct type so tests
    and supervisors can tell an injected failure from an organic one —
    the whole point is asserting the SURROUNDING machinery (tombstones,
    fences, retries) behaves identically for both."""

    def __init__(self, seam: str, fault: str):
        super().__init__(f"chaos: injected {fault!r} at seam {seam!r}")
        self.seam = seam
        self.fault = fault


class ChaosInjector:
    """One armed plan. Thread-safe: seams fire from transport serve
    threads, pipeline workers and the main loop concurrently."""

    def __init__(self, plan: FaultPlan, registry=None, log_fn=print):
        self.plan = plan
        self.log = log_fn
        self._lock = threading.Lock()
        self._armed_at = time.monotonic()
        self._hits: Dict[str, int] = {}
        self._pending: Dict[str, List[FaultEvent]] = {}
        for ev in plan.events:
            self._pending.setdefault(ev.seam, []).append(ev)
        for seam, evs in self._pending.items():
            # at_hit ascending, wall-clock events last (checked every
            # hit regardless); stable for equal keys.
            evs.sort(key=lambda e: (e.at_hit is None, e.at_hit or 0.0,
                                    e.at_s or 0.0))
        self.injected: List[Dict] = []   # chronological evidence log
        self._open_trips: Dict[str, float] = {}  # seam -> trip time
        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self._c_injected: Dict[tuple, object] = {}
        self._h_recovery: Dict[str, object] = {}

    # -- seam surface --------------------------------------------------------
    def fire(self, seam: str) -> Optional[FaultEvent]:
        now = time.monotonic()
        with self._lock:
            hits = self._hits.get(seam, 0) + 1
            self._hits[seam] = hits
            pending = self._pending.get(seam)
            if not pending:
                return None
            ev = None
            for i, cand in enumerate(pending):
                if cand.at_hit is not None:
                    if cand.at_hit <= hits:
                        ev = pending.pop(i)
                        break
                elif now - self._armed_at >= cand.at_s:
                    ev = pending.pop(i)
                    break
            if ev is None:
                return None
            self.injected.append({"seam": seam, "fault": ev.fault,
                                  "hit": hits,
                                  "t_s": round(now - self._armed_at, 3)})
            # One open trip per seam: recovery measures injection ->
            # first proof of recovery; overlapping injections on one
            # seam keep the OLDEST trip (worst-case recovery).
            self._open_trips.setdefault(seam, now)
        self._count(seam, ev.fault)
        _flight_mod.get_flight().record("chaos", f"{seam}.{ev.fault}",
                                        hit=hits, args=ev.args)
        if self.log is not None:
            self.log(json.dumps({"chaos_injected": {
                "seam": seam, "fault": ev.fault, "hit": hits,
                "args": ev.args}}))
        return ev

    def mark_recovered(self, seam: str) -> Optional[float]:
        """The surviving path proved itself (next valid frame decoded,
        next job drained, next save landed...): close the seam's open
        trip and observe ``dqn_recovery_seconds{seam}``. No-op without
        an open trip, so call sites mark unconditionally."""
        with self._lock:
            t0 = self._open_trips.pop(seam, None)
        if t0 is None:
            return None
        dt = time.monotonic() - t0
        h = self._h_recovery.get(seam)
        if h is None:
            h = chaos_recovery_histogram(seam, self._reg)
            self._h_recovery[seam] = h
        h.observe(dt)
        _flight_mod.get_flight().record("chaos", f"{seam}.recovered",
                                        recovery_s=round(dt, 4))
        return dt

    def open_trips(self) -> List[str]:
        """Seams with an injection not yet marked recovered — the
        game-day runner's end-of-scenario invariant is this being
        empty."""
        with self._lock:
            return sorted(self._open_trips)

    def _count(self, seam: str, fault: str) -> None:
        key = (seam, fault)
        c = self._c_injected.get(key)
        if c is None:
            c = chaos_injected_counter(seam, fault, self._reg)
            self._c_injected[key] = c
        c.inc()


# -- fault interpretation helpers (shared by the seams) ----------------------

def corrupt_bytes(payload: bytes, ev: FaultEvent) -> bytes:
    """Flip one bit at a plan-determined offset — the canonical
    bit_flip interpretation, deterministic per event."""
    if not payload:
        return payload
    bit = int(ev.args.get("bit", 0)) % (len(payload) * 8)
    buf = bytearray(payload)
    buf[bit // 8] ^= 1 << (bit % 8)
    return bytes(buf)


def truncate_bytes(payload: bytes, ev: FaultEvent) -> bytes:
    keep = max(1, int(len(payload) * float(ev.args.get("keep_frac", 0.5))))
    return payload[:keep]


def sleep_for(ev: FaultEvent, default_s: float = 0.2) -> float:
    dt = float(ev.args.get("delay_s", default_s))
    time.sleep(dt)
    return dt


# -- process-global arming ---------------------------------------------------

_lock = threading.Lock()
_injector: Optional[ChaosInjector] = None


def install(plan: FaultPlan, registry=None, log_fn=print,
            export_env: bool = False) -> ChaosInjector:
    """Arm ``plan`` process-globally, record it into the run manifest
    (provenance: every chaos run is replayable from its manifest), and
    — with ``export_env`` — hand the plan down to child processes via
    ``DQN_CHAOS_PLAN`` (multiprocessing-spawned actors arm their own)."""
    global _injector
    from dist_dqn_tpu_torch.telemetry import manifest as manifest_mod

    inj = ChaosInjector(plan, registry=registry, log_fn=log_fn)
    with _lock:
        _injector = inj
    manifest_mod.annotate_manifest("chaos_plan", plan.to_dict())
    if export_env:
        os.environ[CHAOS_PLAN_ENV] = plan.to_json()
    return inj


def uninstall() -> None:
    global _injector
    with _lock:
        _injector = None


def get_injector() -> Optional[ChaosInjector]:
    return _injector


@contextlib.contextmanager
def installed(plan: FaultPlan, registry=None, log_fn=None):
    """Scoped arming — the in-process pytest surface:

        with chaos.installed(plan) as inj:
            ... run the system under test ...
        assert inj.injected == [...]
    """
    inj = install(plan, registry=registry, log_fn=log_fn)
    try:
        yield inj
    finally:
        uninstall()


def fire(seam: str) -> Optional[FaultEvent]:
    """The seam entry point: None (fast path, nothing armed) or the
    fault event to interpret."""
    inj = _injector
    if inj is None:
        return None
    return inj.fire(seam)


def mark_recovered(seam: str) -> None:
    inj = _injector
    if inj is not None:
        inj.mark_recovered(seam)


def maybe_install_from_env() -> Optional[ChaosInjector]:
    """Arm from ``DQN_CHAOS_PLAN`` (inline JSON or a file path) if set
    and nothing is armed yet — how spawned actor/feeder processes join
    the parent's game day. Malformed plans fail LOUDLY: a chaos run
    whose faults silently never arm would pass its survival invariants
    vacuously."""
    raw = os.environ.get(CHAOS_PLAN_ENV)
    if not raw:
        return None
    if _injector is not None:
        return _injector
    if not raw.lstrip().startswith("{"):
        with open(raw) as fh:
            raw = fh.read()
    return install(FaultPlan.from_json(raw))
