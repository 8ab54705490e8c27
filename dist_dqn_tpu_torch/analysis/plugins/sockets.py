"""Check ``sockets``: every socket acquisition site in
dist_dqn_tpu_torch/ must bound its blocking behavior — set a timeout
nearby or carry a rationale comment (twin of
``dist_dqn_tpu/analysis/plugins/sockets.py``).

The chaos harness's whole disconnect/partition fault class turns into a
silent process wedge the moment one socket blocks forever. Wherever a
socket is CREATED or ACCEPTED (``socket.socket(``,
``socket.create_connection(``, ``.accept()``), one of the following
must hold within ``CONTEXT_LINES`` lines of the call: a ``settimeout(``
/ ``timeout=`` (the socket is bounded), or a ``# socket:`` rationale
comment explaining why unbounded blocking is safe here.

REQUIRED_SUBPACKAGES makes the coverage explicit: the check FAILS if a
listed tree goes missing rather than silently scanning nothing (real
repo only — synthetic test trees legitimately lack subpackages).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List

from dist_dqn_tpu_torch.analysis.core import AnalysisContext, Check, Finding
from dist_dqn_tpu_torch.analysis.registry import register

#: How far (in lines, both directions) evidence may sit from the call.
CONTEXT_LINES = 6

ACQUIRE = re.compile(
    r"socket\.socket\(|socket\.create_connection\(|\.accept\(\)")
EVIDENCE = re.compile(r"settimeout\(|timeout\s*=|#\s*socket:")

#: Subtrees the scan must actually see (guards against a refactor
#: moving socket code out from under the rglob): the transport-bearing
#: packages today.
REQUIRED_SUBPACKAGES = ("actors", "ingest", "serving", "telemetry")


def scan(repo_root: Path, ctx: AnalysisContext = None) -> List[str]:
    repo_root = Path(repo_root)
    if ctx is None:
        ctx = AnalysisContext(repo_root)
    failures: List[str] = []
    pkg = repo_root / "dist_dqn_tpu_torch"
    # Coverage guard only for the real repo (the lint tests scan
    # synthetic single-file trees, which legitimately lack subpackages;
    # the real repo is the one that ships this check).
    if (repo_root / "dist_dqn_tpu_torch" / "analysis" / "plugins"
            / "sockets.py").exists():
        for sub in REQUIRED_SUBPACKAGES:
            if pkg.is_dir() and not (pkg / sub).is_dir():
                failures.append(
                    f"dist_dqn_tpu_torch/{sub}/: expected subpackage missing "
                    f"— update REQUIRED_SUBPACKAGES if it moved")
    for rel in ctx.iter_py_files(("dist_dqn_tpu_torch",)):
        if rel.startswith("dist_dqn_tpu_torch/analysis/"):
            continue  # the lint layer DEFINES the patterns it hunts
        lines = ctx.lines(rel)
        for i, line in enumerate(lines):
            if not ACQUIRE.search(line):
                continue
            lo = max(0, i - CONTEXT_LINES)
            hi = min(len(lines), i + CONTEXT_LINES + 1)
            window = "\n".join(lines[lo:hi])
            if not EVIDENCE.search(window):
                failures.append(
                    f"{rel}:{i + 1}: socket acquired without a nearby "
                    f"timeout or '# socket:' rationale comment: "
                    f"{line.strip()}")
    return failures


class SocketsCheck(Check):
    name = "sockets"
    description = ("every socket acquisition bounds its blocking "
                   "(timeout nearby) or carries a '# socket:' rationale")
    rationale_tag = "socket:"

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for msg in scan(ctx.root, ctx=ctx):
            loc, _, detail = msg.partition(": ")
            rel, _, lineno = loc.partition(":")
            n = int(lineno) if lineno.isdigit() else 0
            # Key on the acquisition line's TEXT: line-stable (the
            # baseline contract) and distinct per site — a path-only
            # key would let one entry blanket every future unbounded
            # socket in the file.
            site = ctx.lines(rel)[n - 1].strip()[:80] if n else ""
            findings.append(self.finding(
                rel, n,
                detail + f" Bound the socket (settimeout) or add a "
                f"'# socket: <why unbounded blocking is safe>' comment "
                f"within {CONTEXT_LINES} lines.",
                key=f"socket:{rel}:{site}" if n else f"socket:{loc}"))
        return findings


register(SocketsCheck())
