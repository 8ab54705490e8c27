"""Check registry + plugin discovery for the port's dqnlint (twin of
``dist_dqn_tpu/analysis/registry.py``).

A plugin is a module under ``dist_dqn_tpu_torch/analysis/plugins/`` that
instantiates a :class:`~dist_dqn_tpu_torch.analysis.core.Check` subclass and
passes it to :func:`register` at import time. Discovery is one
``pkgutil`` walk over the plugins package — adding a check is adding a
file, not editing a central list.
"""
from __future__ import annotations

import importlib
import pkgutil
from typing import Dict, List, Optional, Sequence

from dist_dqn_tpu_torch.analysis.core import Check

_CHECKS: Dict[str, Check] = {}
_discovered = False


def register(check: Check) -> Check:
    """Register one check instance (import-time, from its plugin
    module). Duplicate names are a programming error — two plugins
    fighting over a name would make ``--check NAME`` ambiguous."""
    if not check.name:
        raise ValueError(f"check {check!r} has no name")
    existing = _CHECKS.get(check.name)
    if existing is not None and type(existing) is not type(check):
        raise ValueError(f"duplicate check name {check.name!r}: "
                         f"{type(existing).__name__} vs "
                         f"{type(check).__name__}")
    _CHECKS[check.name] = check
    return check


def discover() -> None:
    """Import every module under analysis/plugins/ exactly once."""
    global _discovered
    if _discovered:
        return
    from dist_dqn_tpu_torch.analysis import plugins

    for mod in pkgutil.iter_modules(plugins.__path__):
        importlib.import_module(f"{plugins.__name__}.{mod.name}")
    _discovered = True


def get_checks(names: Optional[Sequence[str]] = None) -> List[Check]:
    """The registered checks (all, in name order) or the named subset
    (in the requested order); unknown names raise with the known set."""
    discover()
    if names is None:
        return [_CHECKS[n] for n in sorted(_CHECKS)]
    out = []
    for n in names:
        if n not in _CHECKS:
            raise KeyError(f"unknown check {n!r} "
                           f"(known: {sorted(_CHECKS)})")
        out.append(_CHECKS[n])
    return out


def check_names() -> List[str]:
    discover()
    return sorted(_CHECKS)
