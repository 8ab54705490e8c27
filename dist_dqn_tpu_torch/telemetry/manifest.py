"""Run manifest of the port (twin of ``dist_dqn_tpu/telemetry/manifest.py``):
who/what/where a run was, as one JSON-able block.

Log streams, ``/debug/config`` and the checkpoint's ``LATEST`` pointer all
need the same provenance record: git sha, library versions, platform, the
exact config (and a short hash of it), argv and a schema version, so a
number found in a file weeks later says how it was produced. One function
here, reused by ``train.py`` (one ``{"manifest": ...}`` log line at
startup), ``/debug/config`` (telemetry/server.py) and
``utils/checkpoint.py`` (``manifest_hash``).

Stdlib only, and library versions are read from ``sys.modules`` WITHOUT
importing: a torch-free actor process building a manifest must stay
torch-free (actors/actor.py contract). Where the caller holds torch, it
adds what only torch knows (the card's name, ``torch.version.cuda``)
through ``build_manifest(extra=...)``. The config hash is the JAX
package's for the same config, byte for byte.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

#: Bump when the manifest's key set changes shape (consumers key on it).
SCHEMA_VERSION = 1

_lock = threading.RLock()
_run_manifest: Optional[Dict] = None


def _git_sha() -> Optional[str]:
    """HEAD sha of the repo this package runs from; None outside a
    checkout (installed wheel) or without git."""
    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:  # noqa: BLE001 — provenance must never break a run
        return None


def _module_version(name: str) -> Optional[str]:
    """Version of an ALREADY-IMPORTED module (never triggers an import:
    torch-free processes must stay torch-free)."""
    mod = sys.modules.get(name)
    return getattr(mod, "__version__", None) if mod is not None else None


def config_fingerprint(cfg) -> Dict:
    """{"config_name", "config", "config_hash"} for a config dataclass
    (ExperimentConfig or any other); hash is over the sorted JSON form,
    so two runs with identical knobs fingerprint identically."""
    as_dict = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    blob = json.dumps(as_dict, sort_keys=True, default=str)
    return {
        "config_name": getattr(cfg, "name", None) or as_dict.get("name"),
        "config": json.loads(json.dumps(as_dict, default=str)),
        "config_hash": hashlib.sha256(blob.encode()).hexdigest()[:16],
    }


def build_manifest(cfg=None, argv=None, extra: Optional[Dict] = None
                   ) -> Dict:
    """One provenance block; every field is best-effort (a manifest must
    never fail the run it describes)."""
    man = {
        "schema_version": SCHEMA_VERSION,
        "git_sha": _git_sha(),
        "versions": {
            "python": platform.python_version(),
            "torch": _module_version("torch"),
            "numpy": _module_version("numpy"),
        },
        "platform": platform.platform(),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "argv": list(argv if argv is not None else sys.argv),
        "built_at_unix": time.time(),
    }
    if cfg is not None:
        try:
            man.update(config_fingerprint(cfg))
        except Exception as e:  # noqa: BLE001 — best-effort provenance
            man["config_error"] = f"{type(e).__name__}: {e}"
    if extra:
        man.update(extra)
    return man


def set_run_manifest(manifest: Dict) -> None:
    """Install the process's run manifest (served at ``/debug/config``
    and hashed into the checkpoint's ``LATEST`` pointer)."""
    global _run_manifest
    with _lock:
        _run_manifest = dict(manifest)


def get_run_manifest() -> Optional[Dict]:
    with _lock:
        return None if _run_manifest is None else dict(_run_manifest)


def annotate_manifest(key: str, value) -> None:
    """Fold one key into the run manifest (so ``/debug/config`` says,
    for example, which faults a plan scheduled). Installs a fresh
    cfg-less manifest when none exists yet — processes that never built
    one (spawned actors, bare tests) still get the annotation
    recorded."""
    global _run_manifest
    with _lock:
        if _run_manifest is None:
            _run_manifest = build_manifest()
        _run_manifest[key] = value


def _reset_for_tests() -> None:
    global _run_manifest
    with _lock:
        _run_manifest = None
