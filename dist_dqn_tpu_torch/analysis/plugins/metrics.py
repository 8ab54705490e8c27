"""Check ``metrics``: no NEW JSON-line metric emission bypassing the
telemetry registry, and no ``dqn_*`` family undocumented in
docs/observability.md.

Twin of ``dist_dqn_tpu/analysis/plugins/metrics.py`` with the logic and
both allowlists kept: new code records through the port's registry
(``dist_dqn_tpu_torch/telemetry``), not more ad-hoc
``print(json.dumps(...))`` / ``log_fn(json.dumps(...))`` call sites
scrapers can't see; and every registered ``dqn_*`` family must appear in
docs/observability.md (the port keeps JAX's family names, so that file
is the shared contract) or carry a DOCS_ALLOWLIST rationale.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Set

from dist_dqn_tpu_torch.analysis.core import (AnalysisContext, Check,
                                              Finding, count_matches)
from dist_dqn_tpu_torch.analysis.registry import register

PATTERN = re.compile(r"(?:print|log_fn)\(json\.dumps")

#: Registry registration with a literal family name. ``\s`` spans
#: newlines, so multi-line calls are covered.
REGISTRATION = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*[\"'](dqn_[a-z0-9_]+)[\"']")
#: Canonical name constants in telemetry/collectors.py (including the
#: ``NAME = \`` + next-line-string spelling).
CONSTANT = re.compile(
    r"^[A-Z0-9_]+\s*=\s*(?:\\\s*)?[\"'](dqn_[a-z0-9_]+)[\"']", re.M)

#: dqn_* families allowed to be absent from docs/observability.md,
#: each with the reason it stays undocumented.
DOCS_ALLOWLIST = {
    # Internal plumbing of the span tracer: a scratch gauge the
    # MetricLogger uses to mirror counter-style extras; not a scrape
    # surface anyone should alert on (utils/trace.py).
    "dqn_trace_counter",
}

#: file (repo-relative, posix) -> allowed call sites. The twins of JAX's
#: allowlisted files keep JAX's counts and reasons (its entries for
#: bench.py and benchmarks/ have no twin: the port has no benchmark yet).
ALLOWLIST = {
    "dist_dqn_tpu_torch/actors/remote.py": 1,
    # The ingest_degraded alarm transitions (one line per episode edge,
    # state changes — the continuous signal is the dqn_ingest_degraded
    # gauge). +1 over JAX's 5: the tcp_address announcement, the bound
    # (host, port) of the TCP record listener that remote workers connect
    # to — a CLI output contract like serving_port, not a metric.
    "dist_dqn_tpu_torch/actors/service.py": 6,
    # The one-per-episode transport shedding alarm (the per-record
    # stream is dqn_transport_tcp_shed_total).
    "dist_dqn_tpu_torch/actors/transport.py": 1,
    "dist_dqn_tpu_torch/atari57.py": 7,
    # The telemetry_port announcement line (a CLI output contract like
    # train.py's, not a metric — the metrics themselves go through the
    # registry the flag exposes).
    "dist_dqn_tpu_torch/evaluate.py": 2,
    # The resumed_at_frames and per-save checkpoint announcement lines
    # (run-lifecycle output contracts, mirroring train.py's resume line;
    # the chaos/crash metrics go through the registry), and the one-shot
    # profile_trace announcement after the --profile-dir first-chunk
    # capture lands (a path, not a metric; chip-time metrics go through
    # the registry's dqn_program_*/dqn_chip_* families).
    "dist_dqn_tpu_torch/host_replay_loop.py": 4,
    # The serving CLI's startup announcements (serving_port + optional
    # telemetry_port) and the shutdown serving_drained line — output
    # contracts like train.py's; act metrics go through the registry
    # (dqn_serving_*).
    "dist_dqn_tpu_torch/serving/__main__.py": 3,
    # The one-per-run {"manifest": ...} provenance line (run identity,
    # not a metric stream), and the population loop's telemetry_port /
    # resumed_at_frames / profile_trace announcements and its per-chunk
    # metric row — the same output contracts as the solo loop's sites;
    # the population metrics themselves go through the registry
    # (dqn_population_*).
    "dist_dqn_tpu_torch/train.py": 15,
    "dist_dqn_tpu_torch/utils/metrics.py": 1,  # MetricLogger.flush itself
    # Port-only command-line tools. Each prints its result rows as JSON
    # lines, the output contract its caller parses; none is a metric
    # stream of a running learner.
    # The game-day runner's per-scenario verdict rows and its summary
    # (the twin of scripts/chaos_run.py, which JAX's scan does not see).
    "dist_dqn_tpu_torch/chaos/run.py": 2,
    # The capture probe's per-capture rows and its summary.
    "dist_dqn_tpu_torch/utils/capture_probe.py": 2,
    # The determinism probe's four twice-run comparisons and its
    # version line.
    "dist_dqn_tpu_torch/utils/determinism_probe.py": 5,
    # The trace reader's totals, per-grid and selected-grid rows.
    "dist_dqn_tpu_torch/utils/trace_grids.py": 3,
    # The card smoke script's per-phase report lines, its kernels line
    # and its closing result line: the contract the checker of a card
    # run reads.
    "chip_smoke.py": 59,
}

#: The port and its card smoke script (JAX also scans its benchmarks).
SCAN_ROOTS = ("dist_dqn_tpu_torch", "chip_smoke.py")


def scan(repo_root: Path, ctx: AnalysisContext = None) -> Dict[str, int]:
    """{relpath: direct-emission call-site count} over the scan roots
    (the telemetry package itself is the sanctioned emitter). Pass the
    run's shared ``ctx`` to reuse its parse cache."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    counts: Dict[str, int] = {}
    for rel in ctx.iter_py_files(SCAN_ROOTS):
        if rel.startswith("dist_dqn_tpu_torch/telemetry/"):
            continue  # the registry itself is the sanctioned emitter
        if rel.startswith("dist_dqn_tpu_torch/analysis/"):
            continue  # the lint layer DEFINES the pattern it hunts
        n = count_matches(PATTERN, ctx.source(rel))
        if n:
            counts[rel] = n
    return counts


def scan_metric_names(repo_root: Path,
                      ctx: AnalysisContext = None) -> Set[str]:
    """Every dqn_* family name the package registers or canonicalizes."""
    if ctx is None:
        ctx = AnalysisContext(Path(repo_root))
    names: Set[str] = set()
    for rel in ctx.iter_py_files(("dist_dqn_tpu_torch",)):
        names.update(REGISTRATION.findall(ctx.source(rel)))
    names.update(CONSTANT.findall(
        ctx.source("dist_dqn_tpu_torch/telemetry/collectors.py")))
    return names


def check_docs(repo_root: Path, ctx: AnalysisContext = None) -> List[str]:
    """Names registered in code but absent from docs/observability.md
    (minus the rationale'd allowlist). Whole-name match: a family that
    is merely a prefix of a documented longer name (dqn_foo vs
    dqn_foo_seconds) still counts as undocumented."""
    doc = (Path(repo_root) / "docs" / "observability.md").read_text()
    return sorted(
        n for n in scan_metric_names(repo_root, ctx=ctx)
        if not re.search(rf"{re.escape(n)}(?![a-z0-9_])", doc)
        and n not in DOCS_ALLOWLIST)


class MetricsCheck(Check):
    name = "metrics"
    description = ("metric emission goes through the telemetry registry "
                   "(no new print(json.dumps) call sites) and every "
                   "registered dqn_* family is documented in "
                   "docs/observability.md")
    rationale_tag = None  # suppression = the in-module allowlists

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        findings = []
        for rel, n in sorted(scan(ctx.root, ctx=ctx).items()):
            allowed = ALLOWLIST.get(rel, 0)
            if n > allowed:
                findings.append(self.finding(
                    rel, 0,
                    f"{n} direct JSON-metric emission call sites "
                    f"(allowlist: {allowed}). New metrics must go "
                    f"through dist_dqn_tpu_torch/telemetry (registry counters/"
                    f"gauges/histograms); see docs/observability.md.",
                    key=f"emission:{rel}"))
        for name in check_docs(ctx.root, ctx=ctx):
            findings.append(self.finding(
                "", 0,
                f"{name}: registered in dist_dqn_tpu_torch/ but missing from "
                f"the docs/observability.md naming table. Document the "
                f"family (or add it to DOCS_ALLOWLIST with a rationale).",
                key=f"undocumented:{name}"))
        return findings


register(MetricsCheck())
