"""Check ``heartbeat-stages``: the watchdog stage table cannot drift.

Twin of ``dist_dqn_tpu/analysis/plugins/heartbeat_stages.py``; the
port keeps JAX's stage names, so the table in docs/observability.md is
the shared contract. The hang runbook triages by
STAGE NAME: a forensics bundle or ``/healthz`` 503 names the wedged
heartbeat, and the reader looks it up in the "Heartbeat stage names"
table to learn what beats it and what stale means. A stage registered
in code but missing from the table sends that reader grepping; a table
row whose stage no longer exists sends them chasing a ghost. This check
cross-references both directions:

  * every ``tm_watchdog.heartbeat(...)`` registration in the runtime
    layers must be covered by a table row — literal names match rows
    exactly, f-string names (``f"host_replay.collect.s{s}"``,
    ``f"evac.{name}"``) match rows as a wildcard over their ``{...}``
    holes, and a bare-identifier argument resolves through a same-file
    ``NAME = "literal"`` constant (serving/batcher.py's
    ``BATCHER_STAGE``);
  * every table row must still be producible by some registration.

The telemetry package (which DEFINES the heartbeat API) and the
analysis layer (which hunts it) are excluded from the scan, same as the
metrics check's emitter exclusion.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.registry import register

#: A heartbeat registration's first argument: string literal, f-string,
#: or a bare identifier (resolved against same-file constants).
CALL = re.compile(
    r"\bheartbeat\(\s*(?:(f?)([\"'])((?:[^\"'\\]|\\.)*?)\2|"
    r"([A-Za-z_][A-Za-z0-9_]*))")

#: Same-file ``NAME = "stage.literal"`` constant assignments.
ASSIGN_TMPL = r"^\s*{name}\s*=\s*[\"']([^\"']+)[\"']"

#: The docs table rows: ``| `stage.name` | ... |`` under the
#: "### Heartbeat stage names" heading.
DOC_ROW = re.compile(r"^\|\s*`([^`]+)`\s*\|", re.M)

DOC_SECTION = "### Heartbeat stage names"

#: Runtime layers that register heartbeats. telemetry/ defines the API
#: (its docstrings quote example names), analysis/ hunts it — excluded.
SCAN_ROOTS = ("dist_dqn_tpu_torch",)
SKIP_PREFIXES = ("dist_dqn_tpu_torch/telemetry/",
                 "dist_dqn_tpu_torch/analysis/")


def _hole_pattern(text: str) -> str:
    """An f-string (or ``{N}``-templated docs) stage name as a regex:
    each ``{...}`` hole matches any non-empty run of name characters."""
    out, depth, hole = [], 0, False
    for ch in text:
        if ch == "{":
            depth += 1
            hole = True
            continue
        if ch == "}":
            depth = max(depth - 1, 0)
            if depth == 0 and hole:
                out.append(r"[A-Za-z0-9_.\-]+")
                hole = False
            continue
        if depth == 0:
            out.append(re.escape(ch))
    return "".join(out)


def scan_stages(repo_root: Path, ctx: AnalysisContext = None
                ) -> List[Tuple[str, str, int, bool]]:
    """Every heartbeat registration: (stage_text, relpath, line,
    is_pattern). ``is_pattern`` marks f-strings with holes. Bare
    identifiers resolve through same-file constants; unresolvable ones
    are skipped (a dynamic name the table documents as a pattern has
    its f-string site scanned where it is built)."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    out: List[Tuple[str, str, int, bool]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if any(rel.startswith(p) for p in SKIP_PREFIXES):
            continue
        src = ctx.source(rel)
        for m in CALL.finditer(src):
            line = src.count("\n", 0, m.start()) + 1
            if m.group(4):  # bare identifier: resolve the constant
                am = re.search(ASSIGN_TMPL.format(name=m.group(4)),
                               src, re.M)
                if am:
                    out.append((am.group(1), rel, line, False))
                continue
            text = m.group(3)
            is_fstr = bool(m.group(1)) and "{" in text
            out.append((text, rel, line, is_fstr))
    return out


def doc_stages(repo_root: Path) -> Dict[str, int]:
    """{stage row -> line} from the docs table (empty dict when the
    section is missing — the check reports that as its own finding)."""
    path = Path(repo_root) / "docs" / "observability.md"
    text = path.read_text()
    at = text.find(DOC_SECTION)
    if at < 0:
        return {}
    # The section runs to the next heading (or EOF).
    end = text.find("\n#", at + len(DOC_SECTION))
    section = text[at:end if end > 0 else len(text)]
    base_line = text.count("\n", 0, at) + 1
    rows: Dict[str, int] = {}
    for m in DOC_ROW.finditer(section):
        if m.group(1) == "stage":
            continue  # the header row
        rows[m.group(1)] = base_line + section.count("\n", 0, m.start())
    return rows


class HeartbeatStagesCheck(Check):
    name = "heartbeat-stages"
    description = ("every registered watchdog heartbeat stage appears "
                   "in the docs/observability.md stage table, and every "
                   "table row is still producible by code")
    rationale_tag = None

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        rows = doc_stages(ctx.root)
        if not rows:
            findings.append(self.finding(
                "docs/observability.md", 0,
                f"missing the {DOC_SECTION!r} table the hang runbook "
                f"keys on", key="no-stage-table"))
            return findings
        stages = scan_stages(ctx.root, ctx=ctx)
        # Docs rows as match targets: {N}-style holes instantiated to a
        # representative name so code wildcards can hit them.
        row_regexes = {row: re.compile(_hole_pattern(row) + r"\Z")
                       for row in rows}
        row_instances = {row: re.sub(r"\{[^}]*\}", "0", row)
                         for row in rows}
        for text, rel, line, is_pattern in stages:
            if is_pattern:
                pat = re.compile(_hole_pattern(text) + r"\Z")
                covered = any(pat.match(inst)
                              for inst in row_instances.values())
            else:
                covered = any(rx.match(text)
                              for rx in row_regexes.values())
            if not covered:
                findings.append(self.finding(
                    rel, line,
                    f"heartbeat stage {text!r} is not in the "
                    f"'Heartbeat stage names' table in docs/"
                    f"observability.md — the hang runbook cannot "
                    f"triage a stage the table does not name",
                    key=f"undocumented-stage:{text}"))
        code_regexes = [re.compile(_hole_pattern(t) + r"\Z")
                        if p else None
                        for t, _, _, p in stages]
        code_literals = {t for (t, _, _, p), rx
                         in zip(stages, code_regexes) if not p}
        for row, row_line in sorted(rows.items()):
            inst = row_instances[row]
            produced = (
                row in code_literals or inst in code_literals
                or any(rx is not None and rx.match(inst)
                       for rx in code_regexes)
                or any(row_regexes[row].match(lit)
                       for lit in code_literals))
            if not produced:
                findings.append(self.finding(
                    "docs/observability.md", row_line,
                    f"stage table row {row!r} matches no heartbeat "
                    f"registration in dist_dqn_tpu_torch/ — a renamed or "
                    f"removed stage must update the table",
                    key=f"ghost-stage:{row}"))
        return findings


register(HeartbeatStagesCheck())
