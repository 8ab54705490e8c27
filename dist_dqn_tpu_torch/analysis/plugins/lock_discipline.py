"""Check ``lock-discipline``: per-class guarded-field race inference.

Twin of ``dist_dqn_tpu/analysis/plugins/lock_discipline.py`` over the
port's twins of the same eight modules. The riskiest bugs have all been
concurrency bugs found by hand in review — the DoubleBufferedStager
aliasing race, the batcher drain/admission windows and the checkpoint
stamp-thread teardown. This analyzer makes the review mechanical for
the lock-using classes:

For every class that owns a lock attribute (``self._lock =
threading.Lock()`` / ``RLock()`` / ``Condition()``), infer the class's
GUARDED FIELD SET: every ``self.<attr>`` that any non-constructor
method writes while holding one of the class's locks (``with
self._lock: ...``) — plain assignment, augmented assignment,
``self.x[k] = v`` subscript stores, and mutating container calls
(``self.q.append(...)`` etc.). The discipline the guarded set implies:
a field the class protects with a lock SOMEWHERE must be protected
EVERYWHERE. Any read or write of a guarded field outside a lexical lock
hold is a finding, unless a ``# lock: <reason>`` rationale comment owns
the decision at the access site (within 3 lines above) or at the
enclosing method's ``def`` line (covering helpers that are only ever
called with the lock already held — lexical analysis cannot see
cross-function holds).

Known limits, by design (each is a rationale comment away):

  * hold tracking is lexical and per-function — ``.acquire()``/
    ``.release()`` pairs and helpers called under a caller's hold read
    as unlocked;
  * fields NEVER written under a hold are invisible (a fully
    lock-free racy class produces no findings — this check finds
    inconsistent discipline, not missing discipline);
  * nested functions/lambdas defined under a hold are analyzed as NOT
    held (closures usually outlive the hold that created them);
  * ANY of the class's locks counts as a hold — in a class with
    several locks partitioning its fields, a read under the WRONG lock
    is a false negative (no such class in the target set today; the
    guarded-set inference would need per-lock partitions to see it).

Constructor writes (``__init__``/``__post_init__``/``__del__``) neither
contribute to the guarded set nor get flagged: construction
happens-before any other thread can hold a reference.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, dedupe,
                                              has_rationale)
from dist_dqn_tpu_torch.analysis.registry import register

#: The concurrency-heavy modules the analyzer polices (the twins of
#: JAX's list; grow it as threads spread — a listed file that stops
#: existing fails the check rather than silently scanning nothing).
TARGET_FILES: Tuple[str, ...] = (
    "dist_dqn_tpu_torch/replay/staging.py",
    "dist_dqn_tpu_torch/serving/batcher.py",
    "dist_dqn_tpu_torch/serving/model_store.py",
    "dist_dqn_tpu_torch/actors/transport.py",
    "dist_dqn_tpu_torch/actors/service.py",
    "dist_dqn_tpu_torch/telemetry/watchdog.py",
    "dist_dqn_tpu_torch/utils/checkpoint.py",
    "dist_dqn_tpu_torch/utils/metrics.py",
)

#: ``self.x = threading.<factory>()`` registers x as a lock attribute.
LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

#: Method calls that mutate the receiver in place — writes for the
#: purposes of guarded-set inference (``self.q.append(...)`` under a
#: hold marks ``q`` guarded exactly like ``self.q = ...`` would).
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse",
})

CONSTRUCTORS = frozenset({"__init__", "__post_init__", "__del__",
                          "__new__"})

RATIONALE_TAG = "lock:"


class _Access:
    __slots__ = ("method", "method_lineno", "attr", "lineno", "is_write",
                 "held")

    def __init__(self, method: str, method_lineno: int, attr: str,
                 lineno: int, is_write: bool, held: bool):
        self.method = method
        self.method_lineno = method_lineno
        self.attr = attr
        self.lineno = lineno
        self.is_write = is_write
        self.held = held


def _self_attr(node: ast.AST) -> Optional[str]:
    """'attr' when node is ``self.attr``, else None."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _find_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes assigned a threading.Lock/RLock/Condition anywhere in
    the class body (constructor included — that is where they live)."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        f = value.func
        factory = None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "threading":
            factory = f.attr
        elif isinstance(f, ast.Name):
            factory = f.id
        if factory not in LOCK_FACTORIES:
            continue
        for target in node.targets:
            attr = _self_attr(target)
            if attr is not None:
                locks.add(attr)
    return locks


def _is_lock_hold(item: ast.withitem, lock_attrs: Set[str]) -> bool:
    """True for ``with self._lock:`` / ``with self._cond:`` items."""
    attr = _self_attr(item.context_expr)
    return attr is not None and attr in lock_attrs


def _collect_accesses(method, lock_attrs: Set[str]) -> List[_Access]:
    """Every ``self.<attr>`` touch in ``method`` with its (lexical)
    hold state and read/write classification."""
    accesses: List[_Access] = []
    name = method.name
    m_lineno = method.lineno

    def record(attr: str, lineno: int, is_write: bool, held: bool):
        accesses.append(_Access(name, m_lineno, attr, lineno, is_write,
                                held))

    def visit(node: ast.AST, held: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held or any(_is_lock_hold(i, lock_attrs)
                                for i in node.items)
            for item in node.items:
                visit(item.context_expr, held)
                if item.optional_vars is not None:
                    visit(item.optional_vars, inner)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # A nested def usually runs AFTER the enclosing hold is
            # released (worker targets, callbacks) — analyze unheld.
            for child in node.body:
                visit(child, False)
            return
        if isinstance(node, ast.Lambda):
            visit(node.body, False)
            return
        if isinstance(node, ast.Call):
            # Mutating container call: self.x.append(...) writes x.
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr in MUTATOR_METHODS:
                attr = _self_attr(f.value)
                if attr is not None:
                    record(attr, node.lineno, True, held)
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            # self.x[k] = v / del self.x[k] writes x.
            attr = _self_attr(node.value)
            if attr is not None:
                record(attr, node.lineno, True, held)
        attr = _self_attr(node)
        if attr is not None:
            record(attr, node.lineno,
                   isinstance(node.ctx, (ast.Store, ast.Del)), held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in method.body:
        visit(stmt, False)
    return accesses


def scan_source(rel: str, src: str,
                lines: Optional[Sequence[str]] = None,
                tree: Optional[ast.AST] = None
                ) -> List[Tuple[str, str, str, int, str]]:
    """[(class, method, attr, lineno, kind), ...] unguarded accesses of
    guarded fields in ``src`` (kind: "read"/"write"), rationale-filtered.
    Pass the run's cached ``tree`` to avoid a second parse.
    """
    if lines is None:
        lines = src.splitlines()
    if tree is None:
        tree = ast.parse(src)
    out: List[Tuple[str, str, str, int, str]] = []
    for cls in [n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)]:
        lock_attrs = _find_lock_attrs(cls)
        if not lock_attrs:
            continue
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))]
        accesses: List[_Access] = []
        for m in methods:
            accesses.extend(_collect_accesses(m, lock_attrs))
        guarded = {a.attr for a in accesses
                   if a.is_write and a.held
                   and a.method not in CONSTRUCTORS}
        guarded -= lock_attrs
        rows: dict = {}
        for a in accesses:
            if a.attr not in guarded or a.held \
                    or a.method in CONSTRUCTORS:
                continue
            if has_rationale(lines, a.lineno, RATIONALE_TAG,
                             def_lineno=a.method_lineno):
                continue
            # One row per (method, attr): a mutator call records both
            # the call-write and the attribute-read — keep the earliest
            # site, preferring "write" (the stronger claim).
            ident = (cls.name, a.method, a.attr)
            prev = rows.get(ident)
            if prev is None:
                rows[ident] = (a.lineno, a.is_write)
            else:
                lineno, was_write = prev
                rows[ident] = (min(lineno, a.lineno),
                               was_write or a.is_write)
        out.extend((c, m, attr, lineno, "write" if w else "read")
                   for (c, m, attr), (lineno, w) in sorted(
                       rows.items(), key=lambda kv: kv[1][0]))
    return out


def scan(repo_root: Path, files: Optional[Sequence[str]] = None,
         ctx: Optional[AnalysisContext] = None
         ) -> List[Tuple[str, str, str, str, int, str]]:
    """[(relpath, class, method, attr, lineno, kind), ...] over
    ``files`` (default: TARGET_FILES when any exist under the root,
    else every .py under dist_dqn_tpu_torch/ — the synthetic-tree test mode).
    A <missing> row marks a listed target file that disappeared."""
    root = Path(repo_root)
    if ctx is None:
        ctx = AnalysisContext(root)
    failures: List[Tuple[str, str, str, str, int, str]] = []
    if files is None:
        present = [f for f in TARGET_FILES if (root / f).is_file()]
        if present:
            files = list(present)
            failures.extend(
                (f, "<missing>", "", "", 0, "missing")
                for f in TARGET_FILES if f not in present)
        else:
            files = list(ctx.iter_py_files(("dist_dqn_tpu_torch",)))
    for rel in files:
        try:
            rows = scan_source(rel, ctx.source(rel), ctx.lines(rel),
                               tree=ctx.tree(rel))
        except SyntaxError as e:
            failures.append((rel, "<unparseable>", "", "",
                             e.lineno or 0, "error"))
            continue
        failures.extend((rel, *row) for row in rows)
    return failures


class LockDisciplineCheck(Check):
    name = "lock-discipline"
    description = ("fields a class writes under a lock hold must be "
                   "read/written under the lock everywhere, or carry a "
                   "'# lock:' rationale / reasoned baseline entry")
    rationale_tag = RATIONALE_TAG

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, cls, meth, attr, lineno, kind in scan(ctx.root,
                                                       ctx=ctx):
            if cls == "<missing>":
                findings.append(self.finding(
                    rel, 0,
                    "listed in lock_discipline.TARGET_FILES but absent "
                    "— update the target list if the module moved",
                    key=f"missing:{rel}"))
                continue
            if cls == "<unparseable>":
                findings.append(self.finding(
                    rel, lineno, "unparseable Python — lock analysis "
                    "skipped", key=f"unparseable:{rel}"))
                continue
            findings.append(self.finding(
                rel, lineno,
                f"{cls}.{meth} {kind}s self.{attr} outside any lock "
                f"hold, but {cls} writes {attr} under a 'with "
                f"self.<lock>' hold elsewhere — take the lock, add a "
                f"'# lock: <why safe>' rationale at the site (or the "
                f"method's def line), or baseline it with a reason",
                key=f"{cls}.{meth}:{attr}"))
        return dedupe(findings)


register(LockDisciplineCheck())
