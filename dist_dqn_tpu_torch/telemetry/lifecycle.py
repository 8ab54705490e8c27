"""One flush lifecycle for all telemetry of the port (twin of
``dist_dqn_tpu/telemetry/lifecycle.py``): atexit + SIGTERM callbacks.

Every telemetry sink registers its flush here exactly once:
``install_snapshot_dump(path)`` registers a registry JSON dump
(``DQN_TELEMETRY_SNAPSHOT=<path>`` does the same from the environment,
which is how spawned actor and feeder processes opt in); the span
tracer (utils/trace.py) registers its flush, and a fleet endpoint
registration (telemetry/fleet.py) the removal of its descriptor.

The SIGTERM handler CHAINS any pre-existing handler (the serving CLI
installs its own drain handler; order of installation does not matter:
whichever runs first calls the other), and callbacks run at most once per
process so the atexit leg after a handled signal cannot double-flush. A
handler only runs while the main thread executes Python bytecode: SIGKILL,
or a SIGTERM landing inside an uninterruptible syscall, still loses the
tail. Stdlib only.
"""
from __future__ import annotations

import atexit
import os
import signal
import threading
from typing import Callable, List, Optional

# Reentrant: the SIGTERM leg runs on the main thread and may interrupt a
# frame that already holds this lock (a registration in progress).
_lock = threading.RLock()
_callbacks: List[Callable[[], None]] = []
_installed = False
_ran = False

#: Environment knob: a path here makes ANY process that imports telemetry
#: (and calls maybe_install_snapshot_from_env, as actor/feeder entry
#: points do) dump its registry snapshot on exit. ``{pid}`` in the path
#: is substituted so a process fleet does not clobber one file.
SNAPSHOT_ENV = "DQN_TELEMETRY_SNAPSHOT"


def _run_callbacks() -> None:
    global _ran
    with _lock:
        if _ran:
            return
        _ran = True
        callbacks = list(_callbacks)
    for fn in callbacks:
        try:
            fn()
        except Exception:  # noqa: BLE001 — exit path must not raise
            pass


def _install() -> None:
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True

    atexit.register(_run_callbacks)
    prev = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        _run_callbacks()
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            os._exit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        pass  # not the main thread: atexit-only


def on_exit(fn: Callable[[], None]) -> None:
    """Register ``fn`` to run once at process exit (normal or SIGTERM)."""
    _install()
    with _lock:
        _callbacks.append(fn)


def off_exit(fn: Callable[[], None]) -> None:
    """Deregister an ``on_exit`` callback (no-op if absent). Owners with
    an explicit close() call this so a long-lived process constructing
    many short-lived sinks does not pin every one until exit."""
    with _lock:
        try:
            _callbacks.remove(fn)
        except ValueError:
            pass


def install_snapshot_dump(path: str, registry=None) -> None:
    """Dump the registry's JSON snapshot to ``path`` at exit (normal or
    SIGTERM)."""
    from dist_dqn_tpu_torch.telemetry.exposition import write_snapshot

    def dump():
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        write_snapshot(path, registry)

    on_exit(dump)


def maybe_install_snapshot_from_env(tag: str = "") -> Optional[str]:
    """Honor ``DQN_TELEMETRY_SNAPSHOT`` if set; returns the resolved path.

    ``{pid}``/``{tag}`` placeholders keep per-process files distinct
    (actor fleets all inherit the same environment).
    """
    template = os.environ.get(SNAPSHOT_ENV)
    if not template:
        return None
    path = template.replace("{pid}", str(os.getpid())) \
                   .replace("{tag}", tag)
    install_snapshot_dump(path)
    return path


def _reset_for_tests() -> None:
    """Test hook: forget callbacks and allow the run-once latch to rearm
    (the installed signal/atexit hooks stay; they just see a new list)."""
    global _ran
    with _lock:
        _callbacks.clear()
        _ran = False
