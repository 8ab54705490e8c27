"""Stall watchdog, divergence sentinel and crash-forensics bundles of the
port (twin of ``dist_dqn_tpu/telemetry/watchdog.py``).

A wedged thread raises nothing and a NaN loss trains politely to garbage.
This module turns both into evidence:

  * **Heartbeats and the watchdog thread.** Each pipeline stage registers
    a named heartbeat (``heartbeat("host_replay.collect")``) and beats it
    every pass. A daemon thread sweeps them; a heartbeat past its deadline
    dumps a forensics bundle, increments
    ``dqn_watchdog_stalls_total{stage=...}``, flips ``/healthz`` to 503
    (telemetry/server.py reads ``health_state``), and, with
    ``abort=True``, runs the emergency-checkpoint hooks, SIGTERMs the
    process (the graceful kill: the lifecycle flush chains off SIGTERM)
    and hard-exits with code 70 after a bounded grace.
  * **Divergence sentinel.** The learner loops feed it loss, grad-norm
    and param-checksum scalars they already hold on the host; NaN/Inf or
    a checksum explosion dumps the same bundle, counted in
    ``dqn_divergence_trips_total{signal=...}`` and latched per signal, so
    a diverged run writes one bundle, not one per step.
  * **Forensics bundle.** A directory under ``--forensics-dir`` holding
    ``stacks.txt`` (all threads BY NAME, plus a ``faulthandler`` dump),
    ``flight.json`` (the flight-recorder tail), ``registry.json`` (the
    metrics snapshot), ``manifest.json`` (run provenance) and
    ``reason.json``. It is staged under ``<name>.writing`` and renamed
    when complete.

On the card, a main thread stalled inside a device wait
(``torch.cuda.synchronize()``, ``.item()``) behind a kernel that does not
return still gets its bundle: the sweeper is a Python thread of its own,
those waits release the GIL, and the bundle reads no device state (the
stacks, the ring, the registry, whose device-memory gauges hold the
allocator's counters as last swept, and the manifest). A SIGTERM handler
cannot run while the main thread sits in C code, so under ``abort`` the
way out of such a stall is the hard exit 70 after the grace.

Emergency-checkpoint hooks run on a side thread while the main loop may
be wedged. The port's optimiser updates parameters and moments in place,
so a hook must save a state the loop held at a fence, never a mix of two
steps: ``FenceLock`` is the loop's lock from its first launch to its
fence, and a hook takes it with a bounded wait (``FenceLock.snapshot``);
one that cannot take it within the grace raises, and
``run_emergency_hooks`` logs it ``completed: false``.

Stdlib only (actor and feeder processes register heartbeats too) and
null-safe: ``heartbeat()`` returns a no-op twin when no watchdog is
installed, so loops wire unconditionally and pay nothing by default.
"""
from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import os
import signal
import sys
import threading
import time
import traceback
from typing import Dict, Iterator, Optional, Set

from dist_dqn_tpu_torch.telemetry import flight as _flight_mod
from dist_dqn_tpu_torch.telemetry.collectors import (DIVERGENCE_TRIPS,
                                                     FLIGHT_CAPACITY,
                                                     FLIGHT_EVENTS,
                                                     FORENSICS_BUNDLES,
                                                     WATCHDOG_HEARTBEAT_AGE,
                                                     WATCHDOG_STAGES,
                                                     WATCHDOG_STALLS)
from dist_dqn_tpu_torch.telemetry.registry import get_registry

#: Environment knobs (inherited by spawned actor/feeder processes, as
#: DQN_TELEMETRY_SNAPSHOT is): a directory here makes
#: ``maybe_install_from_env()`` arm the watchdog and sentinel in any
#: process that calls it (the actor and feeder entry points do).
FORENSICS_ENV = "DQN_FORENSICS_DIR"
DEADLINE_ENV = "DQN_WATCHDOG_DEADLINE_S"

DEFAULT_DEADLINE_S = 120.0

_bundle_seq = 0
_bundle_lock = threading.RLock()


def format_stacks() -> str:
    """Every live thread's Python stack, labeled with the thread's NAME
    (``sys._current_frames`` keys on ident; ``threading.enumerate``
    provides the mapping): what ``/debug/stacks`` serves and
    ``stacks.txt`` stores. Unnamed threads print as ``Thread-N``."""
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


def dump_forensics(forensics_dir: str, reason: str,
                   detail: Optional[Dict] = None,
                   registry=None, log_fn=print) -> str:
    """Write one forensics bundle; returns the bundle directory.

    Bundle contents: ``reason.json`` (trigger + detail), ``stacks.txt``
    (named all-thread stacks, plus a ``faulthandler`` dump of the same:
    the C-level view survives interpreter states the traceback module
    cannot walk), ``flight.json``, ``registry.json``, ``manifest.json``.
    Best effort per file: a half-broken process still writes the parts it
    can, and a part that fails leaves ``<part>.error`` beside the others.
    """
    global _bundle_seq
    from dist_dqn_tpu_torch.telemetry import exposition
    from dist_dqn_tpu_torch.telemetry import manifest as manifest_mod

    with _bundle_lock:
        seq = _bundle_seq
        _bundle_seq += 1
    stamp = time.strftime("%Y%m%d_%H%M%S")
    bundle = os.path.join(forensics_dir,
                          f"{stamp}_pid{os.getpid()}_{seq:03d}_{reason}")
    # Written under a temp name and renamed when complete, so a reader
    # polling the forensics dir never sees a half-written bundle as
    # finished.
    staging_dir = bundle + ".writing"
    os.makedirs(staging_dir, exist_ok=True)

    def write(name, fn):
        try:
            with open(os.path.join(staging_dir, name), "w") as f:
                fn(f)
        except Exception as e:  # noqa: BLE001 — dump what we can
            try:
                with open(os.path.join(staging_dir, name + ".error"),
                          "w") as f:
                    f.write(f"{type(e).__name__}: {e}\n")
            except OSError:
                pass

    write("reason.json", lambda f: json.dump(
        {"reason": reason, "detail": detail or {}, "pid": os.getpid(),
         "unix_time": time.time()}, f, indent=1, sort_keys=True))

    def stacks(f):
        f.write(format_stacks())
        f.write("\n=== faulthandler ===\n")
        f.flush()
        faulthandler.dump_traceback(file=f)

    write("stacks.txt", stacks)
    write("flight.json", lambda f: json.dump(
        _flight_mod.get_flight().snapshot(), f, indent=1))
    write("registry.json", lambda f: json.dump(
        exposition.snapshot(registry), f, indent=1, sort_keys=True))
    man = manifest_mod.get_run_manifest() or manifest_mod.build_manifest()
    write("manifest.json", lambda f: json.dump(man, f, indent=1,
                                               sort_keys=True))
    os.rename(staging_dir, bundle)

    reg = registry if registry is not None else get_registry()
    reg.counter(FORENSICS_BUNDLES, "forensics bundles written",
                labels={"trigger": reason}).inc()
    if log_fn is not None:
        log_fn(json.dumps({"forensics_bundle": bundle, "reason": reason}))
    return bundle


#: Extra allowance between a loop heartbeat's REGISTRATION and its first
#: beat: the first pass carries one-time set-up (kernel builds, CUDA
#: initialisation, a census), whose wall is long but legitimate. A stage
#: that never beats at all still trips once deadline + grace elapse.
STARTUP_GRACE_S = 600.0


class Heartbeat:
    """One pipeline stage's liveness signal. ``beat()`` is two plain
    float stores (each atomic in CPython): safe to call from any thread
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
        # grace), never (stale age, no grace), a false stall.
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


def _dump_or_record(owner, reason: str, detail: Dict) -> None:
    """``dump_forensics`` for the sweeper and the sentinel, which must
    survive a failed write: the bundle path lands on ``owner.bundles``,
    a failure on ``owner.bundle_errors`` and in the flight ring, so a
    caller that checks for its bundle sees why there is none."""
    try:
        owner.bundles.append(dump_forensics(
            owner.forensics_dir, reason, detail=detail,
            registry=owner._registry, log_fn=owner.log_fn))
    except Exception as e:  # noqa: BLE001 — the sweep must survive
        err = f"{type(e).__name__}: {e}"
        owner.bundle_errors.append(err)
        _flight_mod.get_flight().record("watchdog", "bundle_failed",
                                        reason=reason, error=err)


class Watchdog:
    """Sweeps registered heartbeats on a named daemon thread; a missed
    deadline dumps ONE forensics bundle per stall episode (latched until
    the stage beats again), counts
    ``dqn_watchdog_stalls_total{stage=...}`` and optionally aborts."""

    def __init__(self, forensics_dir: Optional[str] = None,
                 deadline_s: float = DEFAULT_DEADLINE_S,
                 poll_s: float = 1.0, abort: bool = False,
                 abort_grace_s: float = 10.0, log_fn=print,
                 registry=None, start: bool = True):
        self.forensics_dir = forensics_dir
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s)
        self.abort = abort
        self.abort_grace_s = float(abort_grace_s)
        self.log_fn = log_fn
        self._registry = registry
        self._lock = threading.RLock()
        self._beats: Dict[str, Heartbeat] = {}
        self._stalled: Set[str] = set()
        self._stall_counters: Dict[str, object] = {}
        self._age_gauges: Dict[str, object] = {}
        self._aborting = False
        self.bundles: list = []         # bundle directories written
        self.bundle_errors: list = []   # bundle writes that failed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry-watchdog",
                                        daemon=True)
        if start:
            self._thread.start()

    # -- registration --------------------------------------------------------
    def register(self, stage: str, deadline_s: Optional[float] = None,
                 startup_grace_s: float = 0.0) -> Heartbeat:
        """Get-or-create the stage's heartbeat (re-registering resets its
        clock: a restarted stage starts fresh, not pre-stalled).
        ``startup_grace_s`` extends the allowed silence until the FIRST
        beat (loop stages register before their one-time set-up)."""
        with self._lock:
            hb = self._beats.get(stage)
            if hb is None:
                hb = Heartbeat(stage,
                               deadline_s if deadline_s is not None
                               else self.deadline_s, owner=self,
                               startup_grace_s=startup_grace_s)
                self._beats[stage] = hb
            else:
                if deadline_s is not None:
                    hb.deadline_s = float(deadline_s)
                hb.beat()
            self._stalled.discard(stage)
            return hb

    def unregister(self, stage: str) -> None:
        with self._lock:
            self._beats.pop(stage, None)
            self._stalled.discard(stage)

    def stages(self) -> Dict[str, float]:
        """{stage: age_s} for every registered heartbeat."""
        now = time.monotonic()
        with self._lock:
            return {s: hb.age(now) for s, hb in self._beats.items()}

    # -- health --------------------------------------------------------------
    def stale(self) -> Dict[str, float]:
        """{stage: age_s} for heartbeats past their allowed silence."""
        now = time.monotonic()
        with self._lock:
            return {s: hb.age(now) for s, hb in self._beats.items()
                    if hb.age(now) > hb.limit()}

    def healthz(self):
        """(ok, stale dict): what /healthz serves (stale => 503)."""
        stale = self.stale()
        return (not stale, stale)

    # -- sweep ---------------------------------------------------------------
    def _reg(self):
        return self._registry if self._registry is not None \
            else get_registry()

    def _stage_instruments(self, stage: str):
        c = self._stall_counters.get(stage)
        if c is None:
            c = self._reg().counter(
                WATCHDOG_STALLS, "watchdog-detected stage stalls",
                labels={"stage": stage})
            self._stall_counters[stage] = c
        g = self._age_gauges.get(stage)
        if g is None:
            g = self._reg().gauge(
                WATCHDOG_HEARTBEAT_AGE,
                "seconds since the stage's last heartbeat",
                labels={"stage": stage})
            self._age_gauges[stage] = g
        return c, g

    def check(self) -> Dict[str, float]:
        """One sweep (the poll thread's body; callable directly from
        tests): update age gauges, detect NEWLY stale stages, dump one
        bundle covering them, arm the abort. Returns the stale map."""
        now = time.monotonic()
        with self._lock:
            beats = dict(self._beats)
        stale: Dict[str, float] = {}
        for stage, hb in beats.items():
            age = hb.age(now)
            c, g = self._stage_instruments(stage)
            g.set(age)
            if age > hb.limit():
                stale[stage] = age
        fr = _flight_mod.get_flight()
        reg = self._reg()
        reg.gauge(FLIGHT_EVENTS,
                  "events recorded by the flight ring").set(fr.total)
        reg.gauge(FLIGHT_CAPACITY, "flight ring capacity").set(fr.capacity)
        reg.gauge(WATCHDOG_STAGES,
                  "heartbeat stages registered").set(len(beats))

        with self._lock:
            fresh = [s for s in stale if s not in self._stalled]
            recovered = self._stalled - set(stale)
            self._stalled -= recovered
            self._stalled |= set(fresh)
        if fresh:
            detail = {"stale": {s: round(a, 3) for s, a in stale.items()},
                      "deadline_s": {s: beats[s].deadline_s for s in stale},
                      "newly_stale": fresh}
            fr.record("watchdog", "stall", stages=fresh)
            for s in fresh:
                self._stall_counters[s].inc()
            if self.log_fn is not None:
                self.log_fn(json.dumps({"watchdog_stall": fresh,
                                        "ages_s": detail["stale"]}))
            if self.forensics_dir:
                _dump_or_record(self, "watchdog_stall", detail)
            if self.abort:
                self._abort()
        return stale

    def _abort(self) -> None:
        """Emergency checkpoint hooks first, then SIGTERM ourselves
        (graceful: chains the lifecycle flush), then hard-exit 70 if still
        alive past the grace window: a main thread wedged in a device
        wait never runs the SIGTERM handler. Runs on the watchdog
        thread."""
        if self._aborting:
            return
        self._aborting = True
        if self.log_fn is not None:
            self.log_fn(json.dumps(
                {"watchdog_abort": True,
                 "grace_s": self.abort_grace_s}))
        # An aborting run's newest learner state would otherwise be lost
        # to whatever the periodic save cadence left behind. Hooks ride a
        # bounded side thread: one that itself wedges must not block the
        # abort past the grace window.
        run_emergency_hooks(timeout_s=self.abort_grace_s,
                            log_fn=self.log_fn)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(self.abort_grace_s)
        os._exit(70)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — a sweep bug must not
                pass           # silently kill the watchdog thread loop

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)


# -- divergence sentinel ------------------------------------------------------

class DivergenceSentinel:
    """Watches loss / grad-norm / param-checksum streams; NaN/Inf or a
    checksum explosion dumps a forensics bundle. Latched per signal: a
    diverged run produces one bundle, then keeps running (or aborts,
    when configured), not a bundle per step."""

    def __init__(self, forensics_dir: Optional[str] = None,
                 explosion_factor: float = 1e4, abort: bool = False,
                 log_fn=print, registry=None):
        self.forensics_dir = forensics_dir
        self.explosion_factor = float(explosion_factor)
        self.abort = abort
        self.log_fn = log_fn
        self._registry = registry
        self._lock = threading.RLock()
        self._tripped: Set[str] = set()
        self._ref_checksum: Optional[float] = None
        self._counters: Dict[str, object] = {}
        self.bundles: list = []
        self.bundle_errors: list = []

    def configure(self, forensics_dir=None, explosion_factor=None,
                  abort=None, log_fn=None, registry=None) -> None:
        with self._lock:
            if forensics_dir is not None:
                self.forensics_dir = forensics_dir
            if explosion_factor is not None:
                self.explosion_factor = float(explosion_factor)
            if abort is not None:
                self.abort = abort
            if log_fn is not None:
                self.log_fn = log_fn
            if registry is not None:
                self._registry = registry

    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                param_checksum: Optional[float] = None,
                step: Optional[int] = None) -> Optional[str]:
        """Feed one step's host scalars; returns the tripped signal name
        (or None). Cheap on the healthy path: a few isfinite checks."""
        if loss is not None and not math.isfinite(loss):
            return self._trip("loss_nonfinite", loss, step)
        if grad_norm is not None and not math.isfinite(grad_norm):
            return self._trip("grad_norm_nonfinite", grad_norm, step)
        if param_checksum is not None:
            if not math.isfinite(param_checksum):
                return self._trip("param_checksum_nonfinite",
                                  param_checksum, step)
            mag = abs(param_checksum)
            with self._lock:
                ref = self._ref_checksum
                self._ref_checksum = mag
            if ref is not None and mag > self.explosion_factor \
                    * max(ref, 1.0):
                return self._trip("param_checksum_explosion",
                                  param_checksum, step,
                                  reference=ref)
        return None

    @property
    def tripped(self):
        """Latched signal names (sorted): feeds /healthz when armed."""
        with self._lock:
            return sorted(self._tripped)

    def _trip(self, sig: str, value, step, **extra) -> str:
        with self._lock:
            latched = sig in self._tripped
            self._tripped.add(sig)
            c = self._counters.get(sig)
            if c is None:
                reg = self._registry if self._registry is not None \
                    else get_registry()
                c = reg.counter(DIVERGENCE_TRIPS,
                                "divergence-sentinel trips",
                                labels={"signal": sig})
                self._counters[sig] = c
        if latched:
            # One count per divergence EPISODE: a run that stays NaN must
            # not read as thousands of trips.
            return sig
        c.inc()
        detail = {"signal": sig, "value": repr(value), "step": step,
                  **{k: repr(v) for k, v in extra.items()}}
        _flight_mod.get_flight().record("divergence", sig,
                                        value=repr(value), step=step)
        if self.log_fn is not None:
            self.log_fn(json.dumps({"divergence": detail}))
        if self.forensics_dir:
            _dump_or_record(self, f"divergence_{sig}", detail)
        if self.abort:
            os.kill(os.getpid(), signal.SIGTERM)
        return sig

    def _reset(self) -> None:
        with self._lock:
            self._tripped.clear()
            self._ref_checksum = None


# -- process-global install ---------------------------------------------------

_global_lock = threading.RLock()
_watchdog: Optional[Watchdog] = None
_sentinel = DivergenceSentinel()
#: Extra /healthz contributors: name -> probe(). A probe returns None
#: while healthy, or a JSON-able detail dict to flip /healthz to 503 with
#: that detail under its name: how the serving tier's SLO tracker joins
#: the SAME health surface the stall watchdog and divergence sentinel
#: feed, on every /healthz endpoint of the process at once.
_health_probes: Dict[str, object] = {}


def install_watchdog(forensics_dir: Optional[str] = None,
                     deadline_s: float = DEFAULT_DEADLINE_S,
                     poll_s: float = 1.0, abort: bool = False,
                     log_fn=print) -> Watchdog:
    """Create (or reconfigure) the process-global watchdog. Idempotent:
    a second call updates knobs on the running instance instead of
    leaking a second sweep thread."""
    global _watchdog
    with _global_lock:
        if _watchdog is None:
            _watchdog = Watchdog(forensics_dir=forensics_dir,
                                 deadline_s=deadline_s, poll_s=poll_s,
                                 abort=abort, log_fn=log_fn)
        else:
            _watchdog.forensics_dir = forensics_dir
            _watchdog.deadline_s = float(deadline_s)
            _watchdog.abort = abort
            _watchdog.log_fn = log_fn
        return _watchdog


def get_watchdog() -> Optional[Watchdog]:
    return _watchdog


def uninstall_watchdog() -> None:
    """Stop and forget the process watchdog, and disarm the sentinel (its
    forensics dir, abort and latches cleared): for a long-lived process
    that arms forensics around one piece of work (``chip_smoke.py``'s
    phases). Heartbeats handed out before stay harmless: their owner is
    gone from the process globals."""
    global _watchdog
    with _global_lock:
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
        _sentinel.forensics_dir = None
        _sentinel.abort = False
        _sentinel._reset()


def heartbeat(stage: str, deadline_s: Optional[float] = None,
              startup_grace_s: float = 0.0):
    """Register (get-or-create) a stage heartbeat on the global watchdog;
    the no-op twin when none is installed: call sites never branch."""
    with _global_lock:
        if _watchdog is None:
            return NULL_HEARTBEAT
        return _watchdog.register(stage, deadline_s=deadline_s,
                                  startup_grace_s=startup_grace_s)


def install_sentinel(forensics_dir: Optional[str] = None,
                     explosion_factor: Optional[float] = None,
                     abort: Optional[bool] = None,
                     log_fn=None) -> DivergenceSentinel:
    """Point the always-present global sentinel at a forensics dir (it
    counts and logs trips even unconfigured; bundles need the dir)."""
    _sentinel.configure(forensics_dir=forensics_dir,
                        explosion_factor=explosion_factor,
                        abort=abort, log_fn=log_fn)
    return _sentinel


def get_sentinel() -> DivergenceSentinel:
    return _sentinel


def observe_divergence(**kwargs) -> Optional[str]:
    """Feed the global sentinel (see ``DivergenceSentinel.observe``)."""
    return _sentinel.observe(**kwargs)


def armed_forensics_dir() -> Optional[str]:
    """The forensics directory of the armed watchdog, else of the armed
    sentinel, else None: where on-demand profiles land
    (telemetry/devtime.py)."""
    if _watchdog is not None and _watchdog.forensics_dir:
        return _watchdog.forensics_dir
    return _sentinel.forensics_dir or None


def health_state():
    """(ok, detail) for /healthz: stale watchdog heartbeats AND latched
    divergence trips (the latter only from an ARMED sentinel, one with a
    forensics dir, so an unarmed process's health probe never turns on a
    training accident nobody asked it to police), then every registered
    health probe's verdict."""
    ok, detail = True, {}
    if _watchdog is not None:
        w_ok, stale = _watchdog.healthz()
        if not w_ok:
            ok = False
            detail["stale_stages_age_s"] = {
                s: round(a, 3) for s, a in stale.items()}
    if _sentinel.forensics_dir:
        trips = _sentinel.tripped
        if trips:
            ok = False
            detail["diverged"] = trips
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


#: Emergency-checkpoint hooks: name -> zero-arg callable run by a
#: watchdog abort BEFORE the SIGTERM, so the newest learner state
#: survives the kill. Registered by the loops that own checkpointers
#: (the fused loop in train.py, host_replay_loop, the Ape-X service) and
#: deregistered in their finally blocks.
_emergency_hooks: Dict[str, object] = {}


def register_emergency_hook(name: str, hook) -> None:
    """Register a best-effort pre-abort hook (re-registering a name
    replaces it). The hook runs on a side thread while the main loop may
    be wedged: it saves a state the loop held at a fence (``FenceLock``),
    taking it with a bounded wait."""
    with _global_lock:
        _emergency_hooks[name] = hook


def unregister_emergency_hook(name: str) -> None:
    with _global_lock:
        _emergency_hooks.pop(name, None)


def run_emergency_hooks(timeout_s: float = 10.0, log_fn=print) -> None:
    """Run every registered hook on a bounded side thread; a hook that
    hangs past ``timeout_s`` is abandoned (daemon thread) rather than
    blocking the abort."""
    with _global_lock:
        hooks = list(_emergency_hooks.items())
    for name, hook in hooks:
        done = threading.Event()
        err: list = []

        def _run(hook=hook):
            try:
                hook()
            except Exception as e:  # noqa: BLE001 — best effort
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=_run,
                             name=f"emergency-hook-{name}", daemon=True)
        t.start()
        finished = done.wait(timeout_s)
        if log_fn is not None:
            log_fn(json.dumps({"emergency_hook": name,
                               "completed": bool(finished and not err),
                               "error": (f"{type(err[0]).__name__}: "
                                         f"{err[0]}") if err else None}))


class FenceLock:
    """The lock a training loop holds from its first launch of a step or
    chunk to the fence that ends it, so an emergency hook on a side thread
    never reads a state that the in-place optimiser has half written.

    ``held()`` is the loop's side (one uncontended lock round trip per
    chunk or train event); ``snapshot(fn, timeout_s)`` is the hook's: it
    calls ``fn()`` while holding the lock, and raises ``TimeoutError``
    when the loop kept it past ``timeout_s`` (a wedged step: the hook
    then logs ``completed: false`` instead of saving a torn state)."""

    def __init__(self):
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def held(self) -> Iterator[None]:
        with self._lock:
            yield

    def snapshot(self, fn, timeout_s: float):
        if not self._lock.acquire(timeout=timeout_s):
            raise TimeoutError(
                f"the training loop held its fence lock for more than "
                f"{timeout_s:g} s: no state at a fence to save")
        try:
            return fn()
        finally:
            self._lock.release()


#: How long an emergency hook waits for the loop's fence.
EMERGENCY_FENCE_WAIT_S = 8.0


def register_health_probe(name: str, probe) -> None:
    """Add a /healthz contributor: ``probe()`` -> None (healthy) or a
    detail dict (unhealthy; served as 503 JSON under ``name``).
    Re-registering a name replaces its probe."""
    with _global_lock:
        _health_probes[name] = probe


def unregister_health_probe(name: str) -> None:
    with _global_lock:
        _health_probes.pop(name, None)


def maybe_install_from_env() -> Optional[str]:
    """Honour ``DQN_FORENSICS_DIR`` (and ``DQN_WATCHDOG_DEADLINE_S``) if
    set: how spawned actor and feeder processes arm their own watchdog
    and sentinel; returns the directory. The twin of
    ``maybe_install_snapshot_from_env``."""
    d = os.environ.get(FORENSICS_ENV)
    if not d:
        return None
    try:
        deadline = float(os.environ.get(DEADLINE_ENV, DEFAULT_DEADLINE_S))
    except ValueError:
        deadline = DEFAULT_DEADLINE_S
    install_watchdog(forensics_dir=d, deadline_s=deadline)
    install_sentinel(forensics_dir=d)
    return d


def _reset_for_tests() -> None:
    """Stop and forget the global watchdog; replace the global sentinel
    with a fresh unconfigured one."""
    global _watchdog, _sentinel
    with _global_lock:
        if _watchdog is not None:
            _watchdog.stop()
            _watchdog = None
        _sentinel = DivergenceSentinel()
        _health_probes.clear()
        _emergency_hooks.clear()
