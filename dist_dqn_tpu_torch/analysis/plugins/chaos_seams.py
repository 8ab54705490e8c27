"""Check ``chaos-seams``: the seam registry and the real code paths
must not drift apart.

Twin of ``dist_dqn_tpu/analysis/plugins/chaos_seams.py`` over the
port's ``chaos/plan.py``. The chaos harness only proves anything while
every registered seam still has (a) an injection point — a
``chaos.fire("seam")`` call threaded through the real code path — and
(b) a recovery proof — a ``chaos.mark_recovered("seam")`` anchor the
surviving path hits. A
refactor that drops either leaves the seam registered, the game-day
scenarios green, and the fault class silently untested: the harness
hollows out without a single test failing. This check cross-references
the three surfaces statically:

  * every seam in ``chaos/plan.py``'s ``SEAMS`` registry has >= 1
    ``fire()`` site in package code (outside ``dist_dqn_tpu_torch/chaos/``
    itself);
  * every seam has >= 1 ``mark_recovered()`` anchor — EXCEPT seams
    whose every fault is terminal (``crash``-only seams kill the
    process; recovery is proved by the next process's resume, which a
    dead process cannot mark);
  * every ``fire()``/``mark_recovered()`` call site names a seam the
    registry knows (an unknown name would fail at arm time — but only
    on the game day that exercises it, which is too late);
  * seam names at call sites are string literals (a computed name is
    invisible to this check AND to the registry validation).

AST-based, so the ``chaos.fire("transport.recv")`` examples in
docstrings never count as injection points.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.registry import register

PLAN_PATH = "dist_dqn_tpu_torch/chaos/plan.py"
CHAOS_PKG_PREFIX = "dist_dqn_tpu_torch/chaos/"
SCAN_ROOTS = ("dist_dqn_tpu_torch",)

#: Faults that end the process at the seam: a seam interpreting ONLY
#: these cannot carry an in-process recovery anchor (the proof is the
#: next process's resume, pinned by the game-day scenarios instead).
TERMINAL_FAULTS = frozenset({"crash"})


def extract_seams(plan_src: str) -> Tuple[Dict[str, Tuple[str, ...]],
                                          Dict[str, int]]:
    """(seam -> faults, seam -> registry lineno) parsed statically from
    chaos/plan.py's ``SEAMS`` dict literal — static on purpose, so a
    synthetic test tree needs no importable package and the check reads
    exactly what is committed, not what an interposed import produced.
    """
    tree = ast.parse(plan_src)
    for node in ast.walk(tree):
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            target = node.target
        if not (isinstance(target, ast.Name) and target.id == "SEAMS"):
            continue
        value = node.value
        if not isinstance(value, ast.Dict):
            break
        seams: Dict[str, Tuple[str, ...]] = {}
        linenos: Dict[str, int] = {}
        for key, val in zip(value.keys, value.values):
            try:
                seam = ast.literal_eval(key)
                faults = tuple(ast.literal_eval(val))
            except (ValueError, TypeError):
                continue
            seams[seam] = faults
            linenos[seam] = key.lineno
        return seams, linenos
    return {}, {}


def _literal_seam_arg(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _call_target(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def scan_sites(repo_root: Path, ctx: Optional[AnalysisContext] = None
               ) -> Tuple[Dict[str, List[Tuple[str, int]]],
                          Dict[str, List[Tuple[str, int]]],
                          List[Tuple[str, int, str]]]:
    """(fire sites, recovery sites, non-literal sites) over the package,
    excluding the chaos package itself (it defines the surface)."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    fires: Dict[str, List[Tuple[str, int]]] = {}
    recoveries: Dict[str, List[Tuple[str, int]]] = {}
    nonliteral: List[Tuple[str, int, str]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if rel.startswith(CHAOS_PKG_PREFIX):
            continue
        try:
            tree = ctx.tree(rel)
        except SyntaxError:
            continue  # the unparseable file is another check's finding
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            target = _call_target(node)
            if target not in ("fire", "mark_recovered"):
                continue
            seam = _literal_seam_arg(node)
            if seam is None:
                nonliteral.append((rel, node.lineno, target))
                continue
            sink = fires if target == "fire" else recoveries
            sink.setdefault(seam, []).append((rel, node.lineno))
    return fires, recoveries, nonliteral


class ChaosSeamsCheck(Check):
    name = "chaos-seams"
    description = ("every registered chaos seam keeps a live fire() "
                   "injection point and (non-crash-only seams) a "
                   "mark_recovered() anchor; every call site names a "
                   "registered seam")
    rationale_tag = None  # the registry IS the intent record

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings: List[Finding] = []
        try:
            plan_src = ctx.source(PLAN_PATH)
        except OSError:
            return [self.finding(
                PLAN_PATH, 0,
                "chaos/plan.py not found — the seam registry the whole "
                "game-day harness hangs off is gone",
                key="no-plan")]
        seams, linenos = extract_seams(plan_src)
        if not seams:
            findings.append(self.finding(
                PLAN_PATH, 0,
                "no SEAMS dict literal found in chaos/plan.py — the "
                "registry moved or became dynamic; update chaos_seams."
                "extract_seams", key="no-registry"))
            return findings
        fires, recoveries, nonliteral = scan_sites(ctx.root, ctx=ctx)
        for seam, faults in seams.items():
            if seam not in fires:
                findings.append(self.finding(
                    PLAN_PATH, linenos.get(seam, 0),
                    f"seam {seam!r} is registered but has no "
                    f"chaos.fire({seam!r}) call site in package code — "
                    "it lost its injection point; every game-day "
                    "scenario naming it now passes vacuously. Re-thread "
                    "the seam or delete the registry entry.",
                    key=f"no-fire:{seam}"))
            if seam not in recoveries \
                    and not set(faults) <= TERMINAL_FAULTS:
                findings.append(self.finding(
                    PLAN_PATH, linenos.get(seam, 0),
                    f"seam {seam!r} interprets recoverable faults "
                    f"{sorted(set(faults) - TERMINAL_FAULTS)} but has "
                    f"no chaos.mark_recovered({seam!r}) anchor — "
                    "dqn_recovery_seconds can never close its trip and "
                    "the open-trips end-of-scenario invariant is "
                    "vacuous for it. Anchor the surviving path or make "
                    "the seam crash-only.",
                    key=f"no-recovery:{seam}"))
        for seam, sites in fires.items():
            if seam not in seams:
                rel, lineno = sites[0]
                findings.append(self.finding(
                    rel, lineno,
                    f"chaos.fire({seam!r}) names a seam the registry "
                    "does not know — a plan can never schedule it, so "
                    "the injection point is dead code (register the "
                    "seam in chaos/plan.py SEAMS with its fault set).",
                    key=f"unregistered-fire:{seam}"))
        for seam, sites in recoveries.items():
            if seam not in seams:
                rel, lineno = sites[0]
                findings.append(self.finding(
                    rel, lineno,
                    f"chaos.mark_recovered({seam!r}) names a seam the "
                    "registry does not know — dead recovery anchor "
                    "(register the seam or fix the name).",
                    key=f"unregistered-recovery:{seam}"))
        for rel, lineno, target in nonliteral:
            # Line-text key, not line number: baseline entries must
            # survive unrelated edits above the site.
            site = ctx.lines(rel)[lineno - 1].strip()[:80] \
                if lineno else ""
            findings.append(self.finding(
                rel, lineno,
                f"chaos.{target}(...) with a non-literal seam name — "
                "the drift check (and arm-time validation) can only "
                "protect literal seams; inline the name.",
                key=f"nonliteral:{rel}:{site}"))
        return findings


register(ChaosSeamsCheck())
