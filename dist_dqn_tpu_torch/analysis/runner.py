"""dqnlint run orchestration: checks x context x baseline -> results.

One :class:`~dist_dqn_tpu_torch.analysis.core.AnalysisContext` is shared by
every check in a run (files parse once), the baseline is applied per
finding, and stale baseline entries surface as findings of a synthetic
``baseline`` check — so ``python -m dist_dqn_tpu_torch.analysis``, the
in-process tests and ``python -m dist_dqn_tpu_torch.analysis.check
<name>`` (the twin of JAX's ``scripts/check_*.py`` shims) all run the
exact same code path and can only agree.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

from dist_dqn_tpu_torch.analysis import baseline as baseline_mod
from dist_dqn_tpu_torch.analysis import registry
from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.report import CheckResult


class _BaselineCheck(Check):
    """Synthetic owner of stale-baseline findings (never registered —
    it has no ``run``; the runner materializes its findings)."""

    name = "baseline"
    description = ("baseline hygiene: every entry must still match a "
                   "finding of a check that ran")


def run_checks(root: Path, names: Optional[Sequence[str]] = None,
               baseline_path: Optional[Path] = None) -> List[CheckResult]:
    """Run the named checks (default: all registered) over ``root``.

    Raises :class:`~dist_dqn_tpu_torch.analysis.baseline.BaselineError` on an
    invalid baseline file — bad suppression data fails the run, it does
    not get skipped.
    """
    root = Path(root).resolve()
    checks = registry.get_checks(names)
    if baseline_path is None:
        baseline_path = root / baseline_mod.DEFAULT_BASELINE
    entries = baseline_mod.load_baseline(baseline_path)
    ctx = AnalysisContext(root)

    raw: Dict[str, List[Finding]] = {}
    for check in checks:
        raw[check.name] = list(check.run(ctx))

    all_findings = [f for fs in raw.values() for f in fs]
    ran = [c.name for c in checks]
    active, suppressed, stale = baseline_mod.apply_baseline(
        all_findings, entries, checks_run=ran)

    active_by = _group(active)
    supp_by: Dict[str, List] = {}
    for f, reason in suppressed:
        supp_by.setdefault(f.check, []).append((f, reason))

    results = [CheckResult(check=c,
                           findings=active_by.get(c.name, []),
                           suppressed=supp_by.get(c.name, []))
               for c in checks]
    if stale:
        results.append(CheckResult(check=_BaselineCheck(),
                                   findings=stale, suppressed=[]))
    return results


def _group(findings: Sequence[Finding]) -> Dict[str, List[Finding]]:
    out: Dict[str, List[Finding]] = {}
    for f in findings:
        out.setdefault(f.check, []).append(f)
    return out


def legacy_main(check_name: str, legacy_label: str,
                root: Optional[Path] = None) -> int:
    """Single-check runner, the twin of JAX's ``scripts/check_*.py``
    shims: same verdict line (``check_X: OK`` / ``check_X: FAIL`` +
    per-finding stderr detail), same exit code, logic shared with
    dqnlint."""
    import sys

    if root is None:
        root = Path(__file__).resolve().parents[2]
    results = run_checks(root, names=[check_name])
    failures = [f for r in results for f in r.findings]
    if failures:
        print(f"{legacy_label}: FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f.location()}: {f.message}", file=sys.stderr)
        return 1
    print(f"{legacy_label}: OK")
    return 0
