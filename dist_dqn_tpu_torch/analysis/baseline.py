"""Baseline suppression with mandatory reasons (twin of
``dist_dqn_tpu/analysis/baseline.py``).

The third triage outcome for a finding (after "fix it" and "own it with
a rationale comment at the site"): a reasoned entry in the port's
baseline file ``dist_dqn_tpu_torch/analysis/dqnlint_baseline.json``
(the JAX package keeps its own). The contract that
keeps the baseline from becoming a landfill:

  * every entry carries a non-empty ``reason`` string — loading a
    reasonless entry is a hard :class:`BaselineError`, not a warning
    (zero silent suppressions, by construction);
  * entries match findings on ``(check, path, key)`` — ``key`` is the
    check's line-number-free fingerprint (e.g.
    ``DivergenceSentinel._trip:log_fn``), so unrelated edits to the
    file never invalidate or mis-apply an entry;
  * an entry that no longer matches any finding is STALE and becomes a
    finding itself — the defect was fixed (or the code deleted), so the
    entry must leave in the same PR; baselines only shrink toward zero.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from dist_dqn_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1
#: Repo-relative default location (next to the runner it feeds).
DEFAULT_BASELINE = "dist_dqn_tpu_torch/analysis/dqnlint_baseline.json"

_REQUIRED_FIELDS = ("check", "path", "key", "reason")


class BaselineError(ValueError):
    """The baseline file itself is invalid (missing reason, unknown
    shape) — the run fails loudly instead of suppressing on bad data."""


def load_baseline(path: Path) -> List[Dict]:
    """Parse + validate the baseline file; [] when absent (a repo with
    no baseline is simply a repo with nothing suppressed)."""
    path = Path(path)
    if not path.exists():
        return []
    try:
        payload = json.loads(path.read_text())
    except ValueError as e:
        raise BaselineError(f"{path}: not valid JSON ({e})") from e
    if not isinstance(payload, dict) or "entries" not in payload:
        raise BaselineError(
            f"{path}: expected {{\"version\": {BASELINE_VERSION}, "
            f"\"entries\": [...]}}")
    entries = payload["entries"]
    if not isinstance(entries, list):
        raise BaselineError(f"{path}: \"entries\" must be a list")
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict):
            raise BaselineError(f"{path}: entry {i} is not an object")
        for field in _REQUIRED_FIELDS:
            if field not in entry:
                raise BaselineError(
                    f"{path}: entry {i} is missing {field!r}")
        reason = entry["reason"]
        if not isinstance(reason, str) or not reason.strip():
            raise BaselineError(
                f"{path}: entry {i} ({entry['check']}: {entry['key']}) "
                f"has no reason — every baseline suppression must say "
                f"WHY the finding is acceptable")
    return entries


def save_baseline(path: Path, entries: Sequence[Dict]) -> None:
    payload = {"version": BASELINE_VERSION,
               "entries": sorted(entries,
                                 key=lambda e: (e["check"], e["path"],
                                                e["key"]))}
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True)
                          + "\n")


def apply_baseline(findings: Sequence[Finding], entries: Sequence[Dict],
                   checks_run: Sequence[str],
                   ) -> Tuple[List[Finding], List[Tuple[Finding, str]],
                              List[Finding]]:
    """Partition ``findings`` against the baseline.

    Returns ``(active, suppressed, stale)``: unsuppressed findings, the
    suppressed ones paired with their entry's reason, and one synthetic
    ``baseline`` finding per entry (for a check that actually ran) that
    matched nothing — stale entries fail the run until removed.
    """
    by_ident = {(e["check"], e["path"], e["key"]): e for e in entries}
    active: List[Finding] = []
    suppressed: List[Tuple[Finding, str]] = []
    matched = set()
    for f in findings:
        entry = by_ident.get((f.check, f.path, f.key))
        if entry is None:
            active.append(f)
        else:
            matched.add(id(entry))
            suppressed.append((f, entry["reason"]))
    ran = set(checks_run)
    stale = [
        Finding(check="baseline", path=e["path"], line=0,
                message=(f"stale baseline entry for {e['check']} "
                         f"(key {e['key']!r}): it no longer matches any "
                         "finding — the defect was fixed or the code "
                         "moved; delete the entry"),
                key=f"stale:{e['check']}:{e['key']}")
        for e in entries
        if id(e) not in matched and e["check"] in ran
    ]
    return active, suppressed, stale
