"""dqnlint reporters: human text and the machine-readable JSON artifact.

The JSON shape (``python -m dist_dqn_tpu_torch.analysis --all --json``,
the JAX runner's schema) is a versioned
contract — CI tooling diffs findings across runs on it, so additive
evolution only (bump ``JSON_SCHEMA_VERSION`` on a breaking change):

    {"dqnlint": 1,
     "ok": bool,
     "summary": {"checks_run": N, "findings": N, "suppressed": N,
                 "stale_baseline": N},
     "checks": [{"name": str, "description": str, "ok": bool,
                 "rationale_tag": str | null,
                 "findings": [{"check", "path", "line", "message",
                               "key"}],
                 "suppressed": [{finding..., "reason": str}]}]}
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from dist_dqn_tpu_torch.analysis.core import Check, Finding

JSON_SCHEMA_VERSION = 1


@dataclasses.dataclass
class CheckResult:
    """One check's outcome after baseline application."""

    check: Check
    findings: List[Finding]                    # active (unsuppressed)
    suppressed: List[Tuple[Finding, str]]      # (finding, reason)

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict:
        return {
            "name": self.check.name,
            "description": self.check.description,
            "rationale_tag": self.check.rationale_tag,
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [{**f.to_dict(), "reason": reason}
                           for f, reason in self.suppressed],
        }


def render_json(results: List[CheckResult]) -> Dict:
    findings = sum(len(r.findings) for r in results)
    stale = sum(1 for r in results for f in r.findings
                if f.check == "baseline")
    return {
        "dqnlint": JSON_SCHEMA_VERSION,
        "ok": findings == 0,
        "summary": {
            "checks_run": len(results),
            "findings": findings,
            "suppressed": sum(len(r.suppressed) for r in results),
            "stale_baseline": stale,
        },
        "checks": [r.to_dict() for r in results],
    }


def render_text(results: List[CheckResult], verbose: bool = False) -> str:
    """The human report: one verdict line per check, finding details for
    the failing ones (and suppression notes with ``verbose``)."""
    out: List[str] = []
    for r in results:
        supp = f" ({len(r.suppressed)} baselined)" if r.suppressed else ""
        if r.ok:
            out.append(f"{r.check.name}: OK{supp}")
        else:
            out.append(f"{r.check.name}: FAIL "
                       f"({len(r.findings)} findings){supp}")
            for f in r.findings:
                out.append(f"  {f.location()}: {f.message}")
        if verbose:
            for f, reason in r.suppressed:
                out.append(f"  [baselined] {f.location()}: {f.message}")
                out.append(f"              reason: {reason}")
    total = sum(len(r.findings) for r in results)
    out.append(f"dqnlint: {'OK' if total == 0 else 'FAIL'} "
               f"({len(results)} checks, {total} findings, "
               f"{sum(len(r.suppressed) for r in results)} suppressed)")
    return "\n".join(out)
