"""dqnlint core: the shared substrate every static check of the port
builds on (twin of ``dist_dqn_tpu/analysis/core.py``).

  * :class:`Finding` — one defect, with a repo-relative ``file:line``
    anchor, a human message and a STABLE ``key`` (line-number-free) that
    the baseline file suppresses on;
  * :class:`AnalysisContext` — repo-file discovery (one rglob, one
    ``__pycache__``/generated-file skip rule for every check) with
    cached source text, split lines and parsed ASTs, so eleven checks in
    one process parse each file once, not eleven times;
  * :func:`has_rationale` — the one rationale-comment parser behind
    every ``# lock:`` / ``# donation:`` / ``# socket:`` / ``# mesh-axis:``
    / ``# devtime:`` escape hatch (a nearby comment owning the decision,
    with a reason).

Checks subclass :class:`Check` and register through
``dist_dqn_tpu_torch.analysis.registry``; ``python -m
dist_dqn_tpu_torch.analysis`` is the one runner. Stdlib only: the lint
layer imports neither torch nor jax.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

#: Directories never scanned, whatever the check: bytecode caches,
#: VCS internals, build/venv output trees. One skip rule for every
#: check — skipping __pycache__ and generated files is a property of
#: the substrate, not of each plugin's diligence.
SKIP_DIR_NAMES = frozenset({
    "__pycache__", ".git", ".pytest_cache", ".mypy_cache", ".ruff_cache",
    "node_modules", ".eggs", "build", "dist", ".venv", "venv",
})

#: File suffixes that mark generated artifacts which may carry a .py
#: name (protobuf output is the classic).
GENERATED_SUFFIXES = ("_pb2.py", "_pb2_grpc.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect one check found.

    ``path`` is repo-relative posix ("" for repo-level findings like an
    undocumented metric family); ``line`` is 1-based (0 = file/repo
    level). ``key`` is the line-number-free fingerprint baseline
    entries match on — stable across unrelated edits to the file, so a
    baselined finding does not resurface every time code above it
    moves.
    """

    check: str
    path: str
    line: int
    message: str
    key: str = ""

    def location(self) -> str:
        if not self.path:
            return "<repo>"
        return f"{self.path}:{self.line}" if self.line else self.path

    def to_dict(self) -> Dict:
        return {"check": self.check, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key}


class Check:
    """One registered analyzer. Subclasses set the class attributes and
    implement :meth:`run`; ``rationale_tag`` documents the in-source
    suppression comment the check honors (None = none — suppressions go
    through the baseline file only)."""

    name: str = ""
    description: str = ""
    rationale_tag: Optional[str] = None

    def run(self, ctx: "AnalysisContext") -> List[Finding]:
        raise NotImplementedError

    def finding(self, path: str, line: int, message: str,
                key: str = "") -> Finding:
        return Finding(check=self.name, path=path, line=line,
                       message=message, key=key or f"{path}:{line}")


class AnalysisContext:
    """Shared repo-file discovery + per-file parse cache for one run.

    Every check receives the SAME context, so the source text, split
    lines and AST of a file touched by several checks are read/parsed
    once per run. Paths in and out are repo-relative posix strings —
    the same spelling Finding.path, the baseline file and the legacy
    allowlists use.
    """

    def __init__(self, root: Path):
        self.root = Path(root).resolve()
        self._source: Dict[str, str] = {}
        self._lines: Dict[str, List[str]] = {}
        self._trees: Dict[str, ast.AST] = {}

    # -- discovery -----------------------------------------------------------
    def iter_py_files(self, roots: Sequence[str]) -> Iterator[str]:
        """Repo-relative posix paths of every non-generated .py file
        under ``roots`` (each a repo-relative file or directory),
        sorted per root; missing roots yield nothing (the caller guards
        required trees explicitly, like the sockets check does)."""
        for root in roots:
            base = self.root / root
            if base.is_file():
                if self._wanted(base):
                    yield base.relative_to(self.root).as_posix()
                continue
            if not base.is_dir():
                continue
            for f in sorted(base.rglob("*.py")):
                if self._wanted(f):
                    yield f.relative_to(self.root).as_posix()

    def _wanted(self, path: Path) -> bool:
        if path.name.endswith(GENERATED_SUFFIXES):
            return False
        rel = path.relative_to(self.root)
        return not any(part in SKIP_DIR_NAMES for part in rel.parts[:-1])

    # -- cached reads --------------------------------------------------------
    def source(self, rel: str) -> str:
        src = self._source.get(rel)
        if src is None:
            src = (self.root / rel).read_text()
            self._source[rel] = src
        return src

    def lines(self, rel: str) -> List[str]:
        lines = self._lines.get(rel)
        if lines is None:
            lines = self.source(rel).splitlines()
            self._lines[rel] = lines
        return lines

    def tree(self, rel: str) -> ast.AST:
        """Parsed AST (cached). Raises SyntaxError — checks convert an
        unparseable file into a Finding so the run stays a report, not
        a crash."""
        tree = self._trees.get(rel)
        if tree is None:
            tree = ast.parse(self.source(rel))
            self._trees[rel] = tree
        return tree


def unparseable(check: Check, rel: str, err: SyntaxError) -> Finding:
    return check.finding(
        rel, err.lineno or 0,
        f"unparseable Python ({err.msg}) — every check skips this file "
        "until it parses", key=f"unparseable:{rel}")


def rationale_pattern(tag: str) -> "re.Pattern[str]":
    """The comment shape that suppresses a finding at source: a comment
    containing ``<tag>`` (e.g. ``# lock: probe is read-only``) — the tag
    must be followed by an actual reason on the same line, not bare."""
    return re.compile(rf"#.*\b{re.escape(tag.rstrip(':'))}:\s*\S")


def has_rationale(lines: Sequence[str], lineno: int, tag: str,
                  span: int = 3, def_lineno: Optional[int] = None) -> bool:
    """True when a ``# <tag>: <reason>`` comment owns the code at
    1-based ``lineno``: on the line itself or within ``span`` lines
    above it — or, when ``def_lineno`` is given, on/just above the
    enclosing function's ``def`` line (a method-level rationale covering
    every access in the method)."""
    pat = rationale_pattern(tag)
    lo = max(lineno - span, 0)
    if any(pat.search(ln) for ln in lines[lo:lineno]):
        return True
    if def_lineno is not None:
        lo = max(def_lineno - span, 0)
        return any(pat.search(ln) for ln in lines[lo:def_lineno])
    return False


def count_matches(pattern: "re.Pattern[str]", text: str) -> int:
    return len(pattern.findall(text))


def dedupe(findings: Iterable[Finding]) -> List[Finding]:
    """One finding per (check, path, key), keeping the first (lowest
    line) — multi-site defects report once under their stable key."""
    seen = set()
    out: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        ident = (f.check, f.path, f.key)
        if ident in seen:
            continue
        seen.add(ident)
        out.append(f)
    return out
