"""Check ``donation``: the port's train/collect entry points and replay
ring mutators update their state in place — a state field rebuilt out
of place must carry a ``donation:`` rationale comment.

Torch counterpart of ``dist_dqn_tpu/analysis/plugins/donation.py``. In
JAX "donation" is ``donate_argnums``: a jitted chunk program hands its
GB-sized carry back to XLA, so the update lands in the same HBM
buffers. The port has no jit: its loops own their carries and rings and
update them in place (``state.obs[p] = x``, ``index_put_``, ``copy_``).
The hazard is the one JAX's check guards against: a ring or carry field
rebuilt out of place holds the old and the new tensor at once, which
doubles the card's working set for that field — found as an OOM on a
card that used to fit.

The rule. Look inside every function whose name matches JAX's
``TARGET`` vocabulary (``train|collect|chunk|shard|snapshot|lane|
population``) and every ring mutator of ``dist_dqn_tpu_torch/replay/``
(a function there whose name matches ``RING_MUTATOR``, e.g.
``time_ring_add``), nested functions included. An assignment
``x.field = <expr>`` is a finding when ``<expr>`` builds a new tensor
from ``x.field`` itself: a call of ``torch.cat`` (``concat``,
``concatenate``), ``torch.stack``, ``torch.where``, ``.clone()``, or the
out-of-place ``index_put``, ``scatter``, ``index_copy`` or
``masked_fill`` (the spellings without the trailing ``_``) whose
receiver or arguments read ``x.field``. A comment containing
``donation:`` with a reason, on the assignment's line or within two
lines above it, owns the decision.

numpy host frames (the ``np.concatenate`` frame stacks in ``envs/``) are
out of scope: they live in host memory, not on the card.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, List, Tuple

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, has_rationale)
from dist_dqn_tpu_torch.analysis.registry import register

SCAN_ROOTS = ("dist_dqn_tpu_torch",)
REPLAY_PREFIX = "dist_dqn_tpu_torch/replay/"

#: JAX's vocabulary for a train/collect entry point (its donation check's
#: TARGET, matched here against function names).
TARGET = re.compile(r"train|collect|chunk|shard|snapshot|lane|population")
#: What makes a function of replay/ a ring mutator.
RING_MUTATOR = re.compile(r"add|update|write|flush|scatter|insert|set")

#: ``torch.<fn>`` calls that build a new tensor.
NEW_TENSOR_FUNCS = frozenset({"cat", "concat", "concatenate", "stack",
                              "where"})
#: Methods (or ``torch.<fn>``) whose out-of-place spelling builds a new
#: tensor; the ``_``-suffixed in-place twins are what the rule wants.
NEW_TENSOR_METHODS = frozenset({"clone", "index_put", "scatter",
                                "index_copy", "masked_fill"})
RATIONALE_TAG = "donation:"


def _is_new_tensor_call(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in NEW_TENSOR_METHODS:
        return True
    recv = node.func.value
    return attr in NEW_TENSOR_FUNCS and isinstance(recv, ast.Name) \
        and recv.id == "torch"


def in_scope(rel: str, func_name: str) -> bool:
    """True for the functions the rule looks inside."""
    return bool(TARGET.search(func_name)) or (
        rel.startswith(REPLAY_PREFIX)
        and bool(RING_MUTATOR.search(func_name)))


def scope_functions(ctx: AnalysisContext
                    ) -> Iterator[Tuple[str, ast.AST]]:
    """(relpath, function node) for every in-scope function of the scan
    roots, outermost first (a nested function inside an in-scope one is
    covered by its parent's walk)."""
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if rel.startswith("dist_dqn_tpu_torch/analysis/"):
            continue  # the lint layer DEFINES the patterns it hunts
        try:
            tree = ctx.tree(rel)
        except SyntaxError:
            continue  # reported by scan()
        covered = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or id(node) in covered:
                continue
            if in_scope(rel, node.name):
                covered.update(id(n) for n in ast.walk(node))
                yield rel, node


def _rebuilds(target: ast.Attribute, value: ast.AST) -> bool:
    """True when ``value`` builds a new tensor from ``target``'s field."""
    want = ast.dump(target.value), target.attr
    for call in ast.walk(value):
        if not _is_new_tensor_call(call):
            continue
        for n in ast.walk(call):
            if isinstance(n, ast.Attribute) \
                    and (ast.dump(n.value), n.attr) == want:
                return True
    return False


def scan(repo_root: Path, ctx: AnalysisContext = None
         ) -> List[Tuple[str, int, str, str]]:
    """[(relpath, lineno, function, target text), ...] for violating
    assignments. Pass the run's shared ``ctx`` to reuse its parse
    cache."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    failures: List[Tuple[str, int, str, str]] = []
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        try:
            ctx.tree(rel)
        except SyntaxError as e:
            failures.append((rel, e.lineno or 0, "<unparseable>", ""))
    for rel, func in scope_functions(ctx):
        lines = ctx.lines(rel)
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            flat = [t for tgt in targets
                    for t in (tgt.elts if isinstance(tgt, ast.Tuple)
                              else [tgt])]
            for tgt in flat:
                if not (isinstance(tgt, ast.Attribute)
                        and _rebuilds(tgt, value)):
                    continue
                if has_rationale(lines, node.lineno, RATIONALE_TAG):
                    continue
                failures.append((rel, node.lineno, func.name,
                                 ast.unparse(tgt)))
    return failures


class DonationCheck(Check):
    name = "donation"
    description = ("train/collect entry points and replay ring mutators "
                   "update their state in place: no field rebuilt out of "
                   "place from itself without a '# donation:' rationale "
                   "(device working-set guard)")
    rationale_tag = RATIONALE_TAG

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, lineno, func, target in scan(ctx.root, ctx=ctx):
            if func == "<unparseable>":
                findings.append(self.finding(
                    rel, lineno, "unparseable Python — donation analysis "
                    "skipped", key=f"unparseable:{rel}"))
                continue
            findings.append(self.finding(
                rel, lineno,
                f"{func}() rebuilds {target} out of place from itself — "
                "a train/collect entry point or ring mutator must update "
                "its state in place (copy_, index_put_, slice "
                "assignment) so the old and new tensors never coexist, "
                "or add a '# donation: <why not>' rationale comment",
                key=f"donation:{rel}:{func}:{target}"))
        return findings


register(DonationCheck())
