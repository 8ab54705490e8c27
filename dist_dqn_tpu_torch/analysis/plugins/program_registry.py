"""Check ``program_registry``: every train/collect program the port
builds registers in the chip-time ProgramRegistry — or carries a
``devtime:`` rationale comment.

Torch counterpart of
``dist_dqn_tpu/analysis/plugins/program_registry.py``. The attribution
plane (telemetry/devtime.py) only answers "where did the card's time
go" if every program that can occupy the device shows up in its census;
an unregistered program's device seconds land in the ledger's ``other``
bucket and the MFU denominator silently under-counts. The port has no
``jax.jit``: its programs are what its ``make_*`` factories return, the
callable a loop dispatches once per chunk or step (``make_fused_train``,
``make_r2d2_train``, ``make_population_train``, ``make_collect_chunk``,
``make_mesh_fused_train``, ``make_mesh_r2d2_train``,
``make_sharded_train_step``, ``make_scan_step``).

The rule. A call of a factory named ``make_*_train``, ``make_*_chunk``
or ``make_*_step`` whose name or argument text matches JAX's ``TARGET``
vocabulary (the actor steps are out of scope by construction, as JAX's
act/eval/sample jits are) must either

* bind to a name that appears in the same file on a line that wires the
  registry (JAX's ``REG_LINE``: ``register_program``, ``devtime.``,
  ``attach_cost``/``attach_*_cost``, ``.register(``), or within two
  lines below such a line (wrapped call arguments), or
* be preceded (within two lines, or on the same line) by a comment
  containing ``devtime:`` stating where its census lives instead (a
  factory handing the program to a caller that registers it, a test
  fixture, a per-call throwaway).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, List, Tuple

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, has_rationale)
from dist_dqn_tpu_torch.analysis.plugins.donation import TARGET
from dist_dqn_tpu_torch.analysis.registry import register

SCAN_ROOTS = ("dist_dqn_tpu_torch", "chip_smoke.py")

#: The name of a program factory: it returns a per-chunk or per-step
#: callable.
FACTORY = re.compile(r"make_\w+_(?:train|chunk|step)\Z")
#: A line that wires a program into the registry. ``attach_\w*cost``
#: also matches helper wrappers like ``_attach_train_cost(...)``.
REG_LINE = re.compile(
    r"register_program|devtime\.|attach_\w*cost|\.register\(")
RATIONALE_TAG = "devtime:"


def _callee(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _program_expr(node: ast.Call) -> str:
    """The factory call's text: callee name plus its arguments."""
    args = [ast.unparse(a) for a in node.args + node.keywords]
    return f"{_callee(node)}({', '.join(args)})"


def program_sites(ctx: AnalysisContext
                  ) -> Iterator[Tuple[str, ast.AST, ast.Call]]:
    """(relpath, module tree, call) for every program-factory call in
    the scan roots."""
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if rel.startswith("dist_dqn_tpu_torch/analysis/"):
            continue  # the lint layer DEFINES the patterns it hunts
        try:
            tree = ctx.tree(rel)
        except SyntaxError:
            continue  # reported by scan()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and FACTORY.match(_callee(node)) \
                    and TARGET.search(_program_expr(node)):
                yield rel, tree, node


def _bound_names(tree: ast.AST, call: ast.Call) -> List[str]:
    """Names the program is bound to: assignment targets (tuple targets
    unpacked, the terminal attribute of ``self.x = ...``). The call may
    be nested inside the assigned value (``x = make_f(...)(state)``)."""

    def _contains(value: ast.AST) -> bool:
        return any(n is call for n in ast.walk(value))

    def _names(tgt: ast.AST) -> List[str]:
        if isinstance(tgt, ast.Name):
            return [tgt.id]
        if isinstance(tgt, ast.Attribute):
            return [tgt.attr]
        if isinstance(tgt, (ast.Tuple, ast.List)):
            return [n for e in tgt.elts for n in _names(e)]
        return []

    names: List[str] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _contains(node.value):
            for tgt in node.targets:
                names.extend(_names(tgt))
        elif isinstance(node, ast.AnnAssign) and node.value is not None \
                and _contains(node.value):
            names.extend(_names(node.target))
    return names


def _is_registered(lines, names: List[str]) -> bool:
    """True when any bound name appears anywhere in the file on (or
    within two lines below) a line that wires the ProgramRegistry."""
    pats = [re.compile(rf"\b{re.escape(n)}\b") for n in names if n]
    if not pats:
        return False
    for i, ln in enumerate(lines):
        if not REG_LINE.search(ln):
            continue
        window = "\n".join(lines[i:i + 3])
        if any(p.search(window) for p in pats):
            return True
    return False


def scan(repo_root: Path, ctx: AnalysisContext = None
         ) -> List[Tuple[str, int, str]]:
    """[(relpath, lineno, program expr), ...] for violating sites.
    Pass the run's shared ``ctx`` to reuse its parse cache."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    failures: List[Tuple[str, int, str]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        try:
            ctx.tree(rel)
        except SyntaxError as e:
            failures.append((rel, e.lineno or 0, "<unparseable>"))
    for rel, tree, call in program_sites(ctx):
        lines = ctx.lines(rel)
        if has_rationale(lines, call.lineno, RATIONALE_TAG):
            continue
        if _is_registered(lines, _bound_names(tree, call)):
            continue
        failures.append((rel, call.lineno, _program_expr(call)))
    return failures


class ProgramRegistryCheck(Check):
    name = "program_registry"
    description = ("every train/collect program a make_* factory builds "
                   "registers in the chip-time ProgramRegistry or "
                   "carries a '# devtime:' rationale (attribution-census "
                   "guard)")
    rationale_tag = RATIONALE_TAG

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, lineno, expr in scan(ctx.root, ctx=ctx):
            findings.append(self.finding(
                rel, lineno,
                f"{expr.splitlines()[0]} builds a train/collect "
                "program that never registers in the ProgramRegistry — "
                "wire telemetry.register_program(...).attach_cost(...) "
                "so its card time is attributable, or add a '# devtime: "
                "<why out of scope>' rationale comment "
                "(docs/observability.md, chip-time attribution)",
                key=f"program:{rel}:{expr[:60]}"))
        return findings


register(ProgramRegistryCheck())
