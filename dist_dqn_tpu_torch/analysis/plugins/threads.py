"""Check ``threads``: every ``threading.Thread(...)`` in
``dist_dqn_tpu_torch/`` and ``chip_smoke.py`` must pass explicit
``name=`` AND ``daemon=`` (twin of
``dist_dqn_tpu/analysis/plugins/threads.py``).

The forensics bundles and ``/debug/stacks`` dump every thread's stack
(telemetry/watchdog.py ``format_stacks``): the stacks are labeled by
THREAD NAME, so an unnamed thread prints as ``Thread-7`` and the one
dump you get from a wedged production run points nowhere. Explicit
``daemon=`` is required for the same post-mortem reason — shutdown
behavior must be a decision visible at the call site, not an inherited
default someone has to go look up.

AST-based (no regex false positives on comments/strings): flags any
``threading.Thread(...)`` or bare ``Thread(...)`` call whose keywords
do not include both ``name`` and ``daemon``. ``threading.Timer`` is out
of scope — its constructor takes neither.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Tuple

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, unparseable)
from dist_dqn_tpu_torch.analysis.registry import register

#: The port's package and its card smoke script (JAX scans its package).
SCAN_ROOTS = ("dist_dqn_tpu_torch", "chip_smoke.py")
REQUIRED_KEYWORDS = ("name", "daemon")


def _is_thread_call(func: ast.expr) -> bool:
    if isinstance(func, ast.Attribute) and func.attr == "Thread":
        return isinstance(func.value, ast.Name) \
            and func.value.id == "threading"
    # ``from threading import Thread`` style — not current repo idiom,
    # but the lint must bite if it appears.
    return isinstance(func, ast.Name) and func.id == "Thread"


def scan(repo_root: Path, ctx: AnalysisContext = None
         ) -> List[Tuple[str, int, List[str]]]:
    """[(relpath, lineno, missing keywords), ...] for violating sites.
    Pass the run's shared ``ctx`` to reuse its parse cache."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    failures: List[Tuple[str, int, List[str]]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        try:
            tree = ctx.tree(rel)
        except SyntaxError as e:
            failures.append((rel, e.lineno or 0, ["<unparseable>"]))
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _is_thread_call(node.func)):
                continue
            kw = {k.arg for k in node.keywords}
            missing = [r for r in REQUIRED_KEYWORDS if r not in kw]
            if missing:
                failures.append((rel, node.lineno, missing))
    return failures


class ThreadsCheck(Check):
    name = "threads"
    description = ("every threading.Thread call site passes explicit "
                   "name= and daemon= (forensics stack dumps are "
                   "labeled by thread name)")
    rationale_tag = None

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, lineno, missing in scan(ctx.root, ctx=ctx):
            if missing == ["<unparseable>"]:
                findings.append(unparseable(
                    self, rel, SyntaxError("invalid syntax",
                                           ("", lineno, 0, ""))))
                continue
            wanted = ", ".join(f"{m}=" for m in missing)
            # Key on the call line's TEXT, not its number: unrelated
            # edits above the site must not invalidate a baseline entry.
            site = ctx.lines(rel)[lineno - 1].strip()[:80] \
                if lineno else ""
            findings.append(self.finding(
                rel, lineno,
                f"threading.Thread(...) without explicit {wanted} — "
                "unnamed/implicit threads make forensics stack dumps "
                "unreadable (docs/observability.md)",
                key=f"thread:{rel}:{site}"))
        return findings


register(ThreadsCheck())
