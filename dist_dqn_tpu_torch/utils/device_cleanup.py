"""Device-release hygiene for SIGTERM and exit (twin of
``dist_dqn_tpu/utils/device_cleanup.py``).

``install()`` registers a SIGTERM handler and an atexit hook that release
what the process holds on the card before it dies: an initialised
``torch.distributed`` group (NCCL or ``gloo``) is destroyed, so its peers
and the card's communicator resources do not wait on a dead rank, and the
caching allocator's cached blocks are freed on the card
(``torch.cuda.empty_cache()``), so a politely terminated run leaves the
card to the next process at once. The SIGTERM leg ends the process with
``128 + SIGTERM`` unless an earlier Python handler was installed, which it
chains.

Order: the stall watchdog's abort (telemetry/watchdog.py) runs the
emergency-checkpoint hooks first, each copying the learner under its
loop's ``FenceLock``, and only then SIGTERMs the process, so the release
here always comes after the hooks, as in JAX.

Honest limits: a handler only runs when the main thread is executing
Python bytecode — a process SIGTERM'd while *blocked inside* a device
call runs it when that call returns, and SIGKILL (or the chaos plane's
``os._exit(137)`` crashes) never does: a crash is a crash, and the card
is reclaimed only when the process is gone.

SIGINT is deliberately left alone: Ctrl-C stays a KeyboardInterrupt
(clean Python unwind through ``finally`` blocks), and the atexit hook
still releases the card on that path.
"""
from __future__ import annotations

import atexit
import os
import signal
import sys
import threading

_installed = False
_lock = threading.Lock()


def _release_devices(log_fn=None) -> None:
    """Best-effort device release; every step tolerates a dead backend.
    Imports nothing that is not loaded already: a process that never
    touched torch (or CUDA) has nothing to release."""
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 — a dead or aborted group
            pass
        try:
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        except Exception:  # noqa: BLE001 — a lost or reset device
            pass
    if log_fn is not None:
        try:
            log_fn("# device buffers released")
        except Exception:  # noqa: BLE001
            pass
    # The SIGTERM path ends in os._exit, which discards buffered stdio —
    # flush here so the cleanup notice (and any buffered JSON log lines)
    # survive on block-buffered stdout.
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:  # noqa: BLE001
        pass


def release(log_fn=None) -> None:
    """Public best-effort device release for watchdog and timeout paths:
    a watchdog that must abandon a stuck run calls this (bounded by its
    own timer) before its hard exit."""
    _release_devices(log_fn)


def install(log_fn=None) -> None:
    """Idempotently register the SIGTERM handler + atexit release hook.

    Call once near the top of any entry point that will touch the card
    (the train CLI, the Ape-X service)."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True

    atexit.register(_release_devices, log_fn)

    prev = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        _release_devices(log_fn)
        # Chain a pre-existing Python-level handler; otherwise exit with
        # the conventional fatal-signal status (atexit will not run —
        # cleanup already did).
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)
        else:
            os._exit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except ValueError:
        # Not the main thread (e.g. installed from a worker): atexit-only.
        pass
