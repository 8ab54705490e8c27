"""dqnlint of the port (``dist_dqn_tpu_torch/analysis/``), held case for
case against tests/test_dqnlint.py, plus:

  * parity: each of the eight framework-free checks, run by the JAX
    package on a synthetic tree under ``dist_dqn_tpu/`` and by the port
    on the same tree under ``dist_dqn_tpu_torch/``, gives equal findings
    once the package prefix is mapped (exact, no tolerance);
  * the torch counterparts of donation, mesh-axis and program_registry:
    each bites on a synthetic violation, honours its rationale comment
    and sees the port's real entry points;
  * the repairs the checks asked for in the port, each pinned.
"""
import ast
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from dist_dqn_tpu.analysis import registry as jx_registry  # noqa: E402
from dist_dqn_tpu.analysis.plugins import \
    lock_discipline as jx_lock  # noqa: E402
from dist_dqn_tpu.analysis.plugins import wire as jx_wire  # noqa: E402
from dist_dqn_tpu_torch import analysis  # noqa: E402
from dist_dqn_tpu_torch.analysis import baseline as baseline_mod  # noqa: E402
from dist_dqn_tpu_torch.analysis import check as check_cli  # noqa: E402
from dist_dqn_tpu_torch.analysis import core, registry, report  # noqa: E402
from dist_dqn_tpu_torch.analysis.plugins import (  # noqa: E402
    chaos_seams, ckpt_schema, donation, heartbeat_stages, lock_discipline,
    mesh_axis, metrics, program_registry, sockets, threads, wire)

PKG = "dist_dqn_tpu_torch"

EXPECTED_CHECKS = ("chaos-seams", "ckpt-schema", "donation",
                   "heartbeat-stages", "lock-discipline", "mesh-axis",
                   "metrics", "program_registry", "sockets", "threads",
                   "wire")


@pytest.fixture(scope="module")
def repo_results():
    """One run of every check over the repo (the CLI's shared context)."""
    return {r.check.name: r for r in analysis.run_checks(REPO)}


@pytest.fixture(scope="module")
def repo_ctx():
    return core.AnalysisContext(REPO)


# ---------------------------------------------------------------------------
# the repo passes, in-process and via the CLI
# ---------------------------------------------------------------------------

def test_plugin_discovery_finds_all_checks():
    assert registry.check_names() == sorted(EXPECTED_CHECKS)


@pytest.mark.parametrize("name", EXPECTED_CHECKS)
def test_repo_passes_check(repo_results, name):
    """Every check is green on the repo (baselined findings excepted —
    and every suppression carries its reason); no stale entry."""
    assert "baseline" not in repo_results
    r = repo_results[name]
    assert r.ok, "\n".join(f.location() + ": " + f.message
                           for f in r.findings)
    for _f, reason in r.suppressed:
        assert reason.strip()


def test_cli_all_json_artifact():
    """``python -m dist_dqn_tpu_torch.analysis --all --json`` runs every
    check in ONE process and emits JAX's findings artifact."""
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--all", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr or proc.stdout
    payload = json.loads(proc.stdout)
    assert payload["dqnlint"] == report.JSON_SCHEMA_VERSION == 1
    assert payload["ok"] is True
    assert [c["name"] for c in payload["checks"]] == list(EXPECTED_CHECKS)
    assert payload["summary"] == {"checks_run": 11, "findings": 0,
                                  "suppressed": 4, "stale_baseline": 0}
    for c in payload["checks"]:
        assert set(c) == {"name", "description", "ok", "findings",
                          "suppressed", "rationale_tag"}
        for s in c["suppressed"]:
            assert s["reason"].strip()


def test_cli_list_names_eleven_checks():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--list"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    names = [ln.split(":")[0] for ln in proc.stdout.splitlines()]
    assert names == list(EXPECTED_CHECKS)
    assert "[suppress: '# mesh-axis: <reason>']" in proc.stdout


def test_shipped_baseline_entries_all_carry_reasons():
    """The port's baseline: the four DivergenceSentinel config reads, each
    with the reason JAX's baseline gives the same read."""
    entries = baseline_mod.load_baseline(
        REPO / baseline_mod.DEFAULT_BASELINE)
    jax_entries = baseline_mod.load_baseline(
        REPO / "scripts" / "dqnlint_baseline.json")
    jax_reasons = {e["key"]: e["reason"] for e in jax_entries}
    assert sorted(e["key"] for e in entries) == [
        "DivergenceSentinel._trip:abort",
        "DivergenceSentinel._trip:forensics_dir",
        "DivergenceSentinel._trip:log_fn",
        "DivergenceSentinel.observe:explosion_factor"]
    for e in entries:
        assert e["check"] in EXPECTED_CHECKS
        assert e["path"] == f"{PKG}/telemetry/watchdog.py"
        assert e["reason"] == jax_reasons[e["key"]]


# ---------------------------------------------------------------------------
# framework: discovery context, rationale parsing, baseline, reporter
# ---------------------------------------------------------------------------

def test_context_skips_pycache_and_generated(tmp_path):
    pkg = tmp_path / PKG
    (pkg / "__pycache__").mkdir(parents=True)
    (pkg / "__pycache__" / "sneaky.py").write_text("x = 1\n")
    (pkg / "real.py").write_text("x = 1\n")
    (pkg / "gen_pb2.py").write_text("x = 1\n")
    ctx = core.AnalysisContext(tmp_path)
    assert list(ctx.iter_py_files((PKG,))) == [f"{PKG}/real.py"]


def test_context_caches_parses(tmp_path):
    (tmp_path / "m.py").write_text("a = 1\n")
    ctx = core.AnalysisContext(tmp_path)
    assert ctx.tree("m.py") is ctx.tree("m.py")
    assert ctx.source("m.py") is ctx.source("m.py")


def test_rationale_parsing_windows():
    lines = ["x = 1",
             "# lock: probe is read-only",
             "y = self._q",               # line 3: tag 1 above -> hit
             "z = 1", "z = 1", "z = 1",
             "w = self._q"]               # line 7: tag 5 above -> miss
    assert core.has_rationale(lines, 3, "lock:")
    assert not core.has_rationale(lines, 7, "lock:")
    mlines = ["# lock: always called under the caller's hold",
              "def helper(self):",
              "    pass",
              "    return self._q"]
    assert core.has_rationale(mlines, 4, "lock:", def_lineno=2)
    assert not core.has_rationale(["# lock:", "x = self._q"], 2, "lock:")


def test_baseline_rejects_reasonless_entries(tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"check": "lock-discipline", "path": "a.py", "key": "K",
         "reason": "   "}]}))
    with pytest.raises(baseline_mod.BaselineError, match="no reason"):
        baseline_mod.load_baseline(path)
    path.write_text(json.dumps({"version": 1, "entries": [
        {"check": "lock-discipline", "path": "a.py", "key": "K"}]}))
    with pytest.raises(baseline_mod.BaselineError, match="missing"):
        baseline_mod.load_baseline(path)


def test_baseline_roundtrip_suppress_and_stale(tmp_path):
    f1 = core.Finding("c1", "a.py", 3, "bad thing", key="A.m:x")
    f2 = core.Finding("c1", "a.py", 9, "other thing", key="A.m:y")
    entries = [
        {"check": "c1", "path": "a.py", "key": "A.m:x", "reason": "ok"},
        {"check": "c1", "path": "a.py", "key": "A.gone:z",
         "reason": "was fixed"},
        {"check": "c2", "path": "b.py", "key": "K",
         "reason": "check did not run"},
    ]
    active, suppressed, stale = baseline_mod.apply_baseline(
        [f1, f2], entries, checks_run=["c1"])
    assert active == [f2]
    assert suppressed == [(f1, "ok")]
    assert [s.key for s in stale] == ["stale:c1:A.gone:z"]
    path = tmp_path / "b.json"
    baseline_mod.save_baseline(path, entries)
    assert baseline_mod.load_baseline(path) == sorted(
        entries, key=lambda e: (e["check"], e["path"], e["key"]))


def test_stale_baseline_entry_fails_the_run(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"check": "heartbeat-stages", "path": "nowhere.py",
         "key": "ghost", "reason": "long fixed"}]}))
    results = analysis.run_checks(REPO, names=["heartbeat-stages"],
                                  baseline_path=path)
    stale = [r for r in results if r.check.name == "baseline"]
    assert stale and not stale[0].ok
    assert "stale baseline entry" in stale[0].findings[0].message


def test_cli_rejects_invalid_baseline(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "entries": [
        {"check": "threads", "path": "x.py", "key": "k", "reason": ""}]}))
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--check", "wire",
         "--baseline", str(bad)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "invalid baseline" in proc.stderr


def test_json_reporter_schema_with_findings():
    check = registry.get_checks(["threads"])[0]
    res = report.CheckResult(
        check=check,
        findings=[core.Finding("threads", "a.py", 2, "msg", key="k")],
        suppressed=[(core.Finding("threads", "b.py", 1, "m2", key="k2"),
                     "why")])
    payload = report.render_json([res])
    assert payload["ok"] is False
    assert payload["summary"] == {"checks_run": 1, "findings": 1,
                                  "suppressed": 1, "stale_baseline": 0}
    c = payload["checks"][0]
    assert c["findings"][0] == {"check": "threads", "path": "a.py",
                                "line": 2, "message": "msg", "key": "k"}
    assert c["suppressed"][0]["reason"] == "why"
    text = report.render_text([res])
    assert "threads: FAIL" in text and "a.py:2" in text


def test_unknown_check_name_raises():
    with pytest.raises(KeyError, match="unknown check"):
        analysis.run_checks(REPO, names=["no-such-check"])


@pytest.mark.parametrize("name", EXPECTED_CHECKS)
def test_single_check_entry_point(capsys, name):
    """``python -m dist_dqn_tpu_torch.analysis.check <name>``: the verdict
    line and exit code of JAX's ``scripts/check_*.py``."""
    assert check_cli.main([name]) == 0
    assert capsys.readouterr().out.strip() == \
        f"check_{name.replace('-', '_')}: OK"


def test_single_check_entry_point_fails_and_refuses(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis.check", "no-such-check"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "one of" in proc.stderr
    bad = tmp_path / PKG
    bad.mkdir()
    (bad / "rogue.py").write_text(
        "import threading\nthreading.Thread(target=print)\n")
    assert analysis.legacy_main("threads", "check_threads",
                                root=tmp_path) == 1


# ---------------------------------------------------------------------------
# the framework-free checks still bite (the JAX bite tests, on the port)
# ---------------------------------------------------------------------------

def test_metrics_bites_on_new_call_site(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "rogue.py").write_text("print(json.dumps({'m': 1}))\n")
    counts = metrics.scan(tmp_path)
    assert counts == {f"{PKG}/rogue.py": 1}
    assert metrics.ALLOWLIST.get(f"{PKG}/rogue.py", 0) == 0


def test_metrics_docs_drift_bites(tmp_path):
    pkg = tmp_path / PKG
    tele = pkg / "telemetry"
    tele.mkdir(parents=True)
    (tele / "collectors.py").write_text(
        'DOCUMENTED = "dqn_documented_total"\n'
        'WRAPPED = \\\n    "dqn_wrapped_but_undocumented_total"\n')
    (pkg / "loopy.py").write_text(
        'c = reg.counter(\n    "dqn_registered_elsewhere_total",\n'
        '    "help text")\n'
        'g = reg.gauge("dqn_documented", "a PREFIX of the doc name")\n')
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "observability.md").write_text(
        "only `dqn_documented_total` is in the table\n")
    assert metrics.scan_metric_names(tmp_path) == {
        "dqn_documented", "dqn_documented_total",
        "dqn_wrapped_but_undocumented_total",
        "dqn_registered_elsewhere_total"}
    assert metrics.check_docs(tmp_path) == [
        "dqn_documented", "dqn_registered_elsewhere_total",
        "dqn_wrapped_but_undocumented_total"]


def test_metrics_docs_allowlist_entries_are_real():
    names = metrics.scan_metric_names(REPO)
    for allowed in metrics.DOCS_ALLOWLIST:
        assert allowed in names


def test_metrics_allowlist_twins_keep_jax_counts():
    """Twin files keep JAX's counts, except the service's one extra,
    reasoned line; every port-only entry is a file the scan sees."""
    from dist_dqn_tpu.analysis.plugins import metrics as jx_metrics

    seen = metrics.scan(REPO)
    for rel, n in metrics.ALLOWLIST.items():
        jax_rel = rel.replace(f"{PKG}/", "dist_dqn_tpu/")
        if jax_rel in jx_metrics.ALLOWLIST:
            extra = 1 if rel == f"{PKG}/actors/service.py" else 0
            assert n == jx_metrics.ALLOWLIST[jax_rel] + extra, rel
        else:
            assert seen.get(rel) == n, (rel, seen.get(rel))


def _heartbeat_repo(tmp_path, code: str, table_rows: str, pkg=PKG):
    root = tmp_path / pkg
    root.mkdir(parents=True)
    (root / "loopy.py").write_text(code)
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "observability.md").write_text(
        "### Heartbeat stage names\n\n"
        "| stage | beaten by | stale means |\n|---|---|---|\n"
        + table_rows + "\n\n# next section\n")
    return core.AnalysisContext(tmp_path)


def test_heartbeat_stages_green_on_consistent_tree(tmp_path):
    ctx = _heartbeat_repo(
        tmp_path,
        'STAGE = "pump.loop"\n'
        'a = wd.heartbeat("fused.chunk")\n'
        'b = wd.heartbeat(STAGE)\n'
        'c = wd.heartbeat(f"collect.s{shard}")\n',
        "| `fused.chunk` | x | y |\n"
        "| `pump.loop` | x | y |\n"
        "| `collect.s{N}` | x | y |")
    assert heartbeat_stages.HeartbeatStagesCheck().run(ctx) == []


def test_heartbeat_stages_bites_on_undocumented_stage(tmp_path):
    ctx = _heartbeat_repo(
        tmp_path,
        'a = wd.heartbeat("fused.chunk")\n'
        'b = wd.heartbeat("rogue.stage")\n',
        "| `fused.chunk` | x | y |")
    findings = heartbeat_stages.HeartbeatStagesCheck().run(ctx)
    assert [f.key for f in findings] == ["undocumented-stage:rogue.stage"]
    assert findings[0].path == f"{PKG}/loopy.py"


def test_heartbeat_stages_bites_on_ghost_row(tmp_path):
    ctx = _heartbeat_repo(
        tmp_path,
        'a = wd.heartbeat("fused.chunk")\n',
        "| `fused.chunk` | x | y |\n"
        "| `removed.stage` | x | y |")
    findings = heartbeat_stages.HeartbeatStagesCheck().run(ctx)
    assert [f.key for f in findings] == ["ghost-stage:removed.stage"]
    assert findings[0].path == "docs/observability.md"


def test_heartbeat_stages_real_repo_table_is_live(repo_ctx):
    """The port's stages match the shared table, and the three a
    computed name once hid are literal call sites now."""
    stages = heartbeat_stages.scan_stages(REPO, ctx=repo_ctx)
    where = {(t, rel) for t, rel, _, _ in stages}
    assert ("fused.chunk", f"{PKG}/train.py") in where
    assert ("population.chunk", f"{PKG}/train.py") in where
    assert ("host_replay.collect", f"{PKG}/host_replay_loop.py") in where
    assert "serving.batcher" in {t for t, _ in where}
    assert any("{" in t for t, _ in where)
    assert "host_replay.collect.s{N}" in heartbeat_stages.doc_stages(REPO)


def test_threads_bites_on_anonymous_thread(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "rogue.py").write_text(
        "import threading\n"
        "t = threading.Thread(target=print, daemon=True)\n"
        "u = threading.Thread(target=print, name='ok')\n"
        "v = threading.Thread(target=print, name='ok', daemon=True)\n")
    (tmp_path / "chip_smoke.py").write_text(
        "import threading\nthreading.Thread(target=print)\n")
    assert threads.scan(tmp_path) == [
        (f"{PKG}/rogue.py", 2, ["name"]),
        (f"{PKG}/rogue.py", 3, ["daemon"]),
        ("chip_smoke.py", 2, ["name", "daemon"]),
    ]


def test_threads_bites_on_bare_thread_import(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "rogue.py").write_text(
        "from threading import Thread\n"
        "t = Thread(target=print)\n")
    assert threads.scan(tmp_path) == [
        (f"{PKG}/rogue.py", 2, ["name", "daemon"])]


def test_sockets_bites_and_accepts_evidence(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "rogue.py").write_text(
        "import socket\n"
        + "\n" * (sockets.CONTEXT_LINES + 1)
        + "s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        + "\n" * (sockets.CONTEXT_LINES + 1)
        + "c = socket.create_connection(('h', 1), timeout=2.0)\n"
        + "conn, _ = s.accept()  # socket: close() shuts the fd down\n")
    failures = sockets.scan(tmp_path)
    assert len(failures) == 1
    assert "rogue.py" in failures[0] and "socket.socket(" in failures[0]
    (pkg / "fine.py").write_text(
        "import socket\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        "s.settimeout(0.2)\n")
    assert [f for f in sockets.scan(tmp_path) if "fine.py" in f] == []


def test_sockets_required_subpackages_guard_the_real_repo(tmp_path):
    """The coverage guard fires on a repo that ships the check and lost a
    transport subpackage; synthetic trees are exempt."""
    plug = tmp_path / PKG / "analysis" / "plugins"
    plug.mkdir(parents=True)
    (plug / "sockets.py").write_text("")
    for sub in sockets.REQUIRED_SUBPACKAGES[1:]:
        (tmp_path / PKG / sub).mkdir()
    assert sockets.scan(tmp_path) == [
        f"{PKG}/actors/: expected subpackage missing — update "
        "REQUIRED_SUBPACKAGES if it moved"]


def test_wire_bites_on_header_drift(monkeypatch):
    from dist_dqn_tpu_torch.ingest import codec

    monkeypatch.setattr(codec, "WIRE_HISTORY",
                        {v: "0" * 16 for v in codec.WIRE_HISTORY})
    failures = wire.check()
    assert failures and any("bump PROTOCOL_VERSION" in f for f in failures)


def test_wire_bites_on_missing_version_entry(monkeypatch):
    from dist_dqn_tpu_torch.ingest import codec
    from dist_dqn_tpu_torch.ingest.schema import PROTOCOL_VERSION

    monkeypatch.setattr(
        codec, "WIRE_HISTORY",
        {v: d for v, d in codec.WIRE_HISTORY.items()
         if v != PROTOCOL_VERSION})
    assert any("no WIRE_HISTORY entry" in f for f in wire.check())


def test_wire_digest_covers_header_fields(monkeypatch):
    from dist_dqn_tpu_torch.ingest import codec

    base = wire.wire_digest()
    monkeypatch.setattr(codec, "WIRE_HEADER_FIELDS",
                        codec.WIRE_HEADER_FIELDS + (("extra", "I"),))
    assert wire.wire_digest() != base
    monkeypatch.undo()
    assert wire.wire_digest() == base


def test_ckpt_schema_bites_on_drift(monkeypatch):
    from dist_dqn_tpu_torch.utils import ckpt_schema as cs

    monkeypatch.setattr(cs, "SIDECAR_HISTORY",
                        {v: "0" * 16 for v in cs.SIDECAR_HISTORY})
    failures = ckpt_schema.check()
    assert failures and any("bump SIDECAR_VERSION" in f for f in failures)


def test_ckpt_schema_bites_on_missing_version_entry(monkeypatch):
    from dist_dqn_tpu_torch.utils import ckpt_schema as cs

    monkeypatch.setattr(
        cs, "SIDECAR_HISTORY",
        {v: d for v, d in cs.SIDECAR_HISTORY.items()
         if v != cs.SIDECAR_VERSION})
    assert any("no SIDECAR_HISTORY entry" in f for f in ckpt_schema.check())


def test_wire_and_sidecar_digests_equal_jax():
    """The port's wire v4 and sidecar v4 are JAX's, digest for digest."""
    from dist_dqn_tpu.ingest import codec as jx_codec
    from dist_dqn_tpu.utils import ckpt_schema as jx_cs
    from dist_dqn_tpu_torch.ingest import codec
    from dist_dqn_tpu_torch.utils import ckpt_schema as cs

    assert wire.wire_digest() == jx_wire.wire_digest() \
        == codec.WIRE_HISTORY[4] == jx_codec.WIRE_HISTORY[4] \
        == "26d5d1a9a3b4fb80"
    assert codec.WIRE_HISTORY == jx_codec.WIRE_HISTORY
    assert cs.sidecar_digest() == jx_cs.sidecar_digest() \
        == cs.SIDECAR_HISTORY[4] == jx_cs.SIDECAR_HISTORY[4] \
        == "a21f0ff7cab3aeb5"
    assert cs.SIDECAR_HISTORY == jx_cs.SIDECAR_HISTORY


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------

_LOCKED_CLASS = """\
import threading

class Tracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._window = []
        self._count = 0

    def observe(self, x):
        with self._lock:
            self._window.append(x)
            self._count += 1

    def snapshot(self):
        {snapshot_body}
"""

_REGISTRY_CLASS = """\
import threading

class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_id = {}

    def put(self, k, v):
        with self._lock:
            self._by_id[k] = v

    def drop(self, k):
        self._by_id.pop(k, None)
"""

_NESTED_CLASS = """\
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._jobs = []

    def submit(self, j):
        with self._lock:
            self._jobs.append(j)

            def later():
                return self._jobs.pop()
            return later
"""


def _write_pkg(tmp_path, body, pkg=PKG, name="mod.py"):
    root = tmp_path / pkg
    root.mkdir(parents=True, exist_ok=True)
    (root / name).write_text(body)
    return tmp_path


def _lock_rows(root):
    return {(cls, meth, attr, kind)
            for _, cls, meth, attr, _, kind in lock_discipline.scan(root)}


@pytest.mark.parametrize("body", [
    _LOCKED_CLASS.format(snapshot_body="with self._lock:\n            "
                         "return list(self._window), self._count"),
    _LOCKED_CLASS.format(snapshot_body="# lock: monitoring read, "
                         "staleness is fine\n        "
                         "return list(self._window), self._count"),
    _LOCKED_CLASS.format(
        snapshot_body="return list(self._window), self._count").replace(
        "    def snapshot(self):",
        "    # lock: only called under the caller's hold\n"
        "    def snapshot(self):"),
    "class Free:\n    def __init__(self):\n        self._events = []\n\n"
    "    def update(self, x):\n        self._events.append(x)\n",
], ids=["disciplined", "site-rationale", "method-rationale", "lock-free"])
def test_lock_discipline_quiet(tmp_path, body):
    assert lock_discipline.scan(_write_pkg(tmp_path, body)) == []


def test_lock_discipline_fires_when_a_hold_is_dropped(tmp_path):
    root = _write_pkg(tmp_path, _LOCKED_CLASS.format(
        snapshot_body="return list(self._window), self._count"))
    assert _lock_rows(root) == {("Tracker", "snapshot", "_window", "read"),
                                ("Tracker", "snapshot", "_count", "read")}


def test_lock_discipline_sees_subscript_and_mutator_writes(tmp_path):
    assert _lock_rows(_write_pkg(tmp_path, _REGISTRY_CLASS)) == {
        ("Registry", "drop", "_by_id", "write")}


def test_lock_discipline_nested_defs_are_not_held(tmp_path):
    assert {(m, a) for _, m, a, _ in _lock_rows(
        _write_pkg(tmp_path, _NESTED_CLASS))} == {("submit", "_jobs")}


def test_lock_discipline_real_repo_targets_resolved(repo_results):
    lock = repo_results["lock-discipline"]
    assert lock.ok, [f.message for f in lock.findings]
    assert len(lock.suppressed) == 4
    for f, reason in lock.suppressed:
        assert reason.strip(), f.key
        assert f.key.startswith("DivergenceSentinel.")


def test_lock_discipline_missing_target_file_fails(tmp_path):
    import shutil

    root = tmp_path / "repo"
    for rel in lock_discipline.TARGET_FILES[:2]:
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst)
    rows = lock_discipline.scan(root)
    missing = [r for r in rows if r[1] == "<missing>"]
    assert len(missing) == len(lock_discipline.TARGET_FILES) - 2
    assert list(lock_discipline.TARGET_FILES) == [
        t.replace("dist_dqn_tpu/", f"{PKG}/")
        for t in jx_lock.TARGET_FILES]


# ---------------------------------------------------------------------------
# chaos-seam drift
# ---------------------------------------------------------------------------

_PLAN = """\
SEAMS = {
    "a.send": ("drop", "delay"),
    "b.kill": ("crash",),
}
"""

_USER = """\
from dist_dqn_tpu_torch import chaos

def send():
    ev = chaos.fire("a.send")
    if ev is None:
        chaos.mark_recovered("a.send")

def kill():
    cev = chaos.fire("b.kill")
"""


def _chaos_tree(tmp_path, plan=_PLAN, user=_USER, pkg=PKG):
    root = tmp_path / pkg
    (root / "chaos").mkdir(parents=True, exist_ok=True)
    (root / "chaos" / "plan.py").write_text(plan)
    (root / "wire.py").write_text(user)
    return tmp_path


def _run_chaos(root):
    return registry.get_checks(["chaos-seams"])[0].run(
        core.AnalysisContext(root))


def test_chaos_seams_green_on_consistent_tree(tmp_path):
    assert _run_chaos(_chaos_tree(tmp_path)) == []


def test_chaos_seams_green_on_real_repo(repo_results):
    assert repo_results["chaos-seams"].findings == []


@pytest.mark.parametrize("user,keys", [
    (_USER.replace('ev = chaos.fire("a.send")\n    ', "ev = None\n    "),
     {"no-fire:a.send"}),
    (_USER.replace('chaos.mark_recovered("a.send")', "pass"),
     {"no-recovery:a.send"}),
    (_USER + '\ndef rogue():\n    chaos.fire("c.ghost")\n',
     {"unregistered-fire:c.ghost"}),
    ('"""docs say call chaos.fire("a.send") somewhere."""\n',
     {"no-fire:a.send", "no-fire:b.kill", "no-recovery:a.send"}),
], ids=["lost-fire", "lost-recovery", "unregistered", "docstring"])
def test_chaos_seam_drift_fails(tmp_path, user, keys):
    findings = _run_chaos(_chaos_tree(tmp_path, user=user))
    assert {f.key for f in findings} == keys
    for f in findings:
        if f.key == "no-fire:a.send":
            assert f.path == f"{PKG}/chaos/plan.py" and f.line == 2


def test_chaos_crash_only_seam_needs_no_recovery_anchor(tmp_path):
    findings = _run_chaos(_chaos_tree(tmp_path))
    assert not any("b.kill" in f.key for f in findings)


def test_chaos_nonliteral_seam_name_fails(tmp_path):
    user = _USER + '\ndef dyn(name):\n    chaos.fire(name)\n'
    findings = _run_chaos(_chaos_tree(tmp_path, user=user))
    assert any(f.key.startswith("nonliteral:") for f in findings)


def test_chaos_registry_extraction_matches_live_seams():
    from dist_dqn_tpu_torch.chaos.plan import SEAMS

    seams, linenos = chaos_seams.extract_seams(
        (REPO / chaos_seams.PLAN_PATH).read_text())
    assert seams == {k: tuple(v) for k, v in SEAMS.items()}
    assert set(linenos) == set(seams)


# ---------------------------------------------------------------------------
# parity: JAX's check and the port's on the same synthetic tree
# ---------------------------------------------------------------------------

def _tree_threads(root, pkg):
    p = root / pkg
    p.mkdir(parents=True)
    (p / "rogue.py").write_text(
        "import threading\nfrom threading import Thread\n"
        "t = threading.Thread(target=print, daemon=True)\n"
        "u = threading.Thread(target=print, name='ok')\n"
        "v = threading.Thread(target=print, name='ok', daemon=True)\n"
        "w = Thread(target=print)\n")
    (p / "broken.py").write_text("def f(:\n")


def _tree_sockets(root, pkg):
    p = root / pkg
    (p / "analysis").mkdir(parents=True)
    (p / "analysis" / "hunter.py").write_text("s = socket.socket()\n")
    (p / "rogue.py").write_text(
        "import socket\n" + "\n" * (sockets.CONTEXT_LINES + 1)
        + "s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)\n"
        + "\n" * (sockets.CONTEXT_LINES + 1)
        + "c = socket.create_connection(('h', 1), timeout=2.0)\n"
        + "conn, _ = s.accept()  # socket: close() shuts the fd down\n"
        + "\n" * (sockets.CONTEXT_LINES + 1)
        + "d, _ = s.accept()\n")


def _tree_metrics(root, pkg):
    p = root / pkg
    (p / "telemetry").mkdir(parents=True)
    (p / "telemetry" / "collectors.py").write_text(
        'DOC = "dqn_documented_total"\nUNDOC = "dqn_undocumented_total"\n'
        'print(json.dumps({"sanctioned": 1}))\n')
    (p / "train.py").write_text("print(json.dumps({}))\n" * 16)
    (p / "atari57.py").write_text("log_fn(json.dumps({}))\n" * 2)
    (p / "rogue.py").write_text(
        "print(json.dumps({'m': 1}))\n"
        'g = reg.gauge("dqn_trace_counter", "x")\n'
        'c = reg.counter("dqn_rogue_total", "x")\n')
    (root / "docs").mkdir()
    (root / "docs" / "observability.md").write_text(
        "| `dqn_documented_total` | x |\n")


def _tree_heartbeat(root, pkg):
    p = root / pkg
    (p / "telemetry").mkdir(parents=True)
    (p / "telemetry" / "watchdog.py").write_text(
        'hb = heartbeat("example.stage")\n')
    (p / "loopy.py").write_text(
        'STAGE = "pump.loop"\n'
        'a = wd.heartbeat("fused.chunk")\n'
        'b = wd.heartbeat(STAGE)\n'
        'c = wd.heartbeat(f"collect.s{shard}")\n'
        'd = wd.heartbeat("rogue.stage")\n'
        'e = wd.heartbeat(name)\n')
    (root / "docs").mkdir()
    (root / "docs" / "observability.md").write_text(
        "### Heartbeat stage names\n\n"
        "| stage | beaten by | stale means |\n|---|---|---|\n"
        "| `fused.chunk` | x | y |\n| `pump.loop` | x | y |\n"
        "| `collect.s{N}` | x | y |\n| `removed.stage` | x | y |\n"
        "\n# next section\n")


def _tree_chaos(root, pkg):
    _chaos_tree(root, pkg=pkg, user=_USER.replace(
        'chaos.mark_recovered("a.send")', "pass")
        + '\ndef dyn(name):\n    chaos.fire(name)\n'
        + '\ndef rogue():\n    chaos.mark_recovered("c.ghost")\n')


def _tree_lock(root, pkg):
    _write_pkg(root, _LOCKED_CLASS.format(
        snapshot_body="return list(self._window), self._count"),
        pkg=pkg, name="tracker.py")
    _write_pkg(root, _REGISTRY_CLASS + _NESTED_CLASS, pkg=pkg)


def _tree_lock_targets(root, pkg):
    (root / pkg / "replay").mkdir(parents=True)
    (root / pkg / "replay" / "staging.py").write_text(_LOCKED_CLASS.format(
        snapshot_body="return list(self._window), self._count"))


_PARITY_TREES = {
    "threads": _tree_threads, "sockets": _tree_sockets,
    "metrics": _tree_metrics, "heartbeat-stages": _tree_heartbeat,
    "chaos-seams": _tree_chaos, "lock-discipline": _tree_lock,
    "lock-discipline/targets": _tree_lock_targets,
}


def _mapped(findings, src=PKG, dst="dist_dqn_tpu"):
    return [(f.check, f.path.replace(src, dst), f.line,
             f.message.replace(src, dst), f.key.replace(src, dst))
            for f in findings]


@pytest.mark.parametrize("case", sorted(_PARITY_TREES))
def test_parity_with_jax_on_a_synthetic_tree(tmp_path, case):
    """JAX's check on the tree under dist_dqn_tpu/ and the port's on the
    same tree under dist_dqn_tpu_torch/ give equal findings after the
    package prefix is mapped — exactly."""
    name = case.split("/")[0]
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _PARITY_TREES[case](jax_root, "dist_dqn_tpu")
    _PARITY_TREES[case](port_root, PKG)
    ours = registry.get_checks([name])[0].run(
        core.AnalysisContext(port_root))
    theirs = jx_registry.get_checks([name])[0].run(
        core.AnalysisContext(jax_root))
    assert ours, "the tree must make the check bite"
    assert _mapped(ours) == [(f.check, f.path, f.line, f.message, f.key)
                             for f in theirs]


@pytest.mark.parametrize("name", ["wire", "ckpt-schema"])
def test_parity_with_jax_on_the_live_registries(monkeypatch, name):
    """The live-module checks: both clean on the shipped registries, and
    the same findings when both histories drift the same way."""
    from dist_dqn_tpu.ingest import codec as jx_codec
    from dist_dqn_tpu.utils import ckpt_schema as jx_cs
    from dist_dqn_tpu_torch.ingest import codec
    from dist_dqn_tpu_torch.utils import ckpt_schema as cs

    mod, attr = {"wire": ((codec, jx_codec), "WIRE_HISTORY"),
                 "ckpt-schema": ((cs, jx_cs), "SIDECAR_HISTORY")}[name]
    ours = registry.get_checks([name])[0]
    theirs = jx_registry.get_checks([name])[0]
    ctx = core.AnalysisContext(REPO)
    assert ours.run(ctx) == theirs.run(ctx) == []
    for m in mod:
        monkeypatch.setattr(m, attr, {v: "0" * 16 for v in getattr(m, attr)})
    got, want = ours.run(ctx), theirs.run(ctx)
    assert len(got) == 2
    assert _mapped(got) == [(f.check, f.path, f.line, f.message, f.key)
                            for f in want]


# ---------------------------------------------------------------------------
# the torch counterparts: mesh-axis, donation, program_registry
# ---------------------------------------------------------------------------

def test_mesh_axis_bites_on_direct_and_axisless_collectives(tmp_path):
    pkg = tmp_path / PKG
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "rogue.py").write_text(
        "import torch.distributed as dist\n"
        "from torch.distributed import broadcast as bc\n"
        "import torch\n"
        "def f(t, mesh, sock):\n"
        "    dist.all_reduce(t, group=mesh.group)\n"
        "    torch.distributed.barrier()\n"
        "    bc(t, src=0, group=mesh.group)\n"
        "    mesh.barrier()\n"
        "    sock.send(b'x')\n"
        "    dist.get_rank()\n")
    (pkg / "parallel" / "mesh.py").write_text(
        "import torch.distributed as dist\n"
        "def psum(t, group):\n"
        "    dist.all_reduce(t, group=group)\n"
        "    dist.all_gather_object([None], t)\n")
    rows = sorted((rel, line, msg.split(" ")[0])
                  for rel, line, msg in mesh_axis.scan(tmp_path))
    assert rows == [
        (f"{PKG}/parallel/mesh.py", 4, "all_gather_object(...)"),
        (f"{PKG}/rogue.py", 5, "direct"),
        (f"{PKG}/rogue.py", 6, "barrier(...)"),
        (f"{PKG}/rogue.py", 6, "direct"),
        (f"{PKG}/rogue.py", 7, "direct"),
    ]


def test_mesh_axis_honors_rationale(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "ok.py").write_text(
        "import torch.distributed as dist\n"
        "def f(t):\n"
        "    # mesh-axis: the default group IS the axis in this worker\n"
        "    x = 1\n"
        "    y = 2\n"
        "    dist.all_reduce(t)\n"
        "    x = 3\n"
        "    x = 4\n"
        "    x = 5\n"
        "    x = 6\n"
        "    dist.barrier()\n")
    assert [(line, msg.split(" ")[0])
            for _, line, msg in mesh_axis.scan(tmp_path)] == [
        (11, "direct"), (11, "barrier(...)")]


def test_mesh_axis_sees_the_real_collectives(repo_ctx):
    """Green by coverage: the scan sees the mesh's collectives, each with
    its group, and none outside the two sanctioned modules."""
    sites = mesh_axis.collective_sites(repo_ctx)
    by_file = {}
    for rel, _, name, has_group in sites:
        by_file.setdefault(rel, set()).add(name)
        assert has_group, (rel, name)
    assert set(by_file) == {f"{PKG}/parallel/mesh.py"}
    assert by_file[f"{PKG}/parallel/mesh.py"] == {"all_reduce",
                                                  "broadcast"}


_DONATION_SRC = """\
import numpy as np
import torch

def time_ring_add(state, obs, p):
    state.obs = torch.cat([state.obs[1:], obs[None]])
    state.obs[p] = obs
    state.size = state.size + 1

def run_chunk(carry, mask):
    carry.q = carry.q.clone()
    carry.q.index_put_((mask,), carry.q[mask])
    carry.prio = carry.prio.index_put((mask,), carry.prio[mask])

    def body(c):
        c.h = torch.where(mask, c.h, 0)
    # donation: the chunk's metrics are a fresh tensor on purpose
    carry.metrics = torch.stack([carry.metrics, carry.metrics])
    carry.frames = np.concatenate([carry.frames, carry.frames])
    carry.other = torch.cat([carry.x, carry.y])

def act(state, obs):
    state.obs = torch.cat([state.obs, obs])
"""


def test_donation_bites_on_out_of_place_rebuilds(tmp_path):
    pkg = tmp_path / PKG
    (pkg / "replay").mkdir(parents=True)
    (pkg / "replay" / "ring.py").write_text(_DONATION_SRC)
    (pkg / "envs.py").write_text(_DONATION_SRC)   # not replay/: no ring
    rows = sorted((rel, line, func, tgt)
                  for rel, line, func, tgt in donation.scan(tmp_path))
    ring = f"{PKG}/replay/ring.py"
    envs = f"{PKG}/envs.py"
    assert rows == sorted([
        (ring, 5, "time_ring_add", "state.obs"),
        (ring, 10, "run_chunk", "carry.q"),
        (ring, 12, "run_chunk", "carry.prio"),
        (ring, 15, "run_chunk", "c.h"),
        (envs, 10, "run_chunk", "carry.q"),
        (envs, 12, "run_chunk", "carry.prio"),
        (envs, 15, "run_chunk", "c.h"),
    ])


def test_donation_honors_rationale(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "loop.py").write_text(
        "import torch\n"
        "def collect_chunk(carry):\n"
        "    # donation: the pre-fill buffer is rebuilt once per run\n"
        "    carry.buf = torch.cat([carry.buf, carry.buf])\n"
        "    carry.buf2 = torch.cat([carry.buf2, carry.buf2])  "
        "# donation: test\n")
    assert donation.scan(tmp_path) == []
    findings = registry.get_checks(["donation"])[0].run(
        core.AnalysisContext(tmp_path))
    assert findings == []


def test_donation_recognizes_the_real_entry_points(repo_ctx):
    """Green by coverage: the rule looks inside the port's factories and
    its ring mutators."""
    seen = {(rel, fn.name) for rel, fn in donation.scope_functions(repo_ctx)}
    for rel, name in [
            ("replay/device.py", "time_ring_add"),
            ("replay/prioritized_device.py", "prioritized_ring_add"),
            ("replay/prioritized_device.py", "_write_priorities"),
            ("replay/sequence_device.py", "sequence_ring_add"),
            ("replay/sequence_device.py", "sequence_ring_update"),
            ("replay/host_ring.py", "add_chunk"),
            ("train_loop.py", "make_fused_train"),
            ("r2d2_loop.py", "make_r2d2_train"),
            ("population.py", "make_population_train"),
            ("host_replay_loop.py", "make_collect_chunk"),
            ("parallel/learner.py", "make_sharded_train_step")]:
        assert (f"{PKG}/{rel}", name) in seen, (rel, name)


_PROGRAM_SRC = """\
from dist_dqn_tpu_torch.telemetry import devtime

def make_fused_train(cfg):
    return None, None

init, run_chunk = make_fused_train(cfg)
step = make_scan_step(train_step)
# devtime: a test fixture, out of census scope
excused = make_sharded_train_step(step, mesh)
act = make_actor_step(num_actions)
opt = make_population_optimizer(cfg, 4)
init2, wired = make_fused_train(cfg)
prog = devtime.register_program("fused.chunk")
prog.attach_cost(lambda: census(
    wired, carry))
"""


def test_program_registry_bites_and_honors_wiring(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "loop.py").write_text(_PROGRAM_SRC)
    assert [(line, expr) for _, line, expr in
            program_registry.scan(tmp_path)] == [
        (6, "make_fused_train(cfg)"),
        (7, "make_scan_step(train_step)")]


def test_program_registry_covers_returned_and_nested_programs(tmp_path):
    pkg = tmp_path / PKG
    pkg.mkdir()
    (pkg / "factory.py").write_text(
        "def make_population_train(cfg):\n"
        "    return make_fused_train(cfg, member_hp=1)\n"
        "def steps(train_step):\n"
        "    # devtime: registered by the caller\n"
        "    return {0: make_sharded_train_step(make_scan_step(\n"
        "        train_step), None)}\n")
    assert [(line, expr.split("(")[0]) for _, line, expr in
            program_registry.scan(tmp_path)] == [(2, "make_fused_train")]


def test_program_registry_recognizes_the_real_entry_points(repo_ctx):
    """Green by coverage: the guard sees a call of every program factory
    the port has."""
    seen = {program_registry._callee(call)
            for _, _, call in program_registry.program_sites(repo_ctx)}
    assert seen == {"make_fused_train", "make_r2d2_train",
                    "make_population_train", "make_collect_chunk",
                    "make_mesh_fused_train", "make_mesh_r2d2_train",
                    "make_sharded_train_step", "make_scan_step"}
    defined = {n.name for rel in repo_ctx.iter_py_files((PKG,))
               for n in ast.walk(repo_ctx.tree(rel))
               if isinstance(n, ast.FunctionDef)}
    assert seen <= defined


# ---------------------------------------------------------------------------
# the repairs the checks asked for
# ---------------------------------------------------------------------------

def test_stager_depth_count_is_read_under_its_lock():
    """DoubleBufferedStager's ``_queued`` is written under its lock and,
    since the lock-discipline repair, read under it too: ``len()``,
    ``stage()`` and ``pop()`` wait for a holder."""
    from dist_dqn_tpu_torch.replay.staging import DoubleBufferedStager

    st = DoubleBufferedStager(depth=2, device="cpu", name="lint_probe")
    for op in (lambda: len(st), lambda: st.stage(np.zeros(3)),
               lambda: st.pop()):
        done = threading.Event()
        with st._lock:
            t = threading.Thread(target=lambda: (op(), done.set()),
                                 name="stager-probe", daemon=True)
            t.start()
            assert not done.wait(0.2), "read _queued without the lock"
        assert done.wait(5.0)
        t.join(5.0)
    assert len(st) == 0


def test_stager_two_threads_keep_count_and_order():
    """The prefetcher's shape: one thread stages while another pops."""
    from dist_dqn_tpu_torch.replay.staging import DoubleBufferedStager

    st = DoubleBufferedStager(depth=2, device="cpu", name="lint_pair")
    n, got = 200, []

    def producer():
        for k in range(n):
            while len(st) >= st.depth:
                pass
            st.stage(np.full(4, k, np.float32), aux=k)

    t = threading.Thread(target=producer, name="stager-producer",
                         daemon=True)
    t.start()
    while len(got) < n:
        if len(st):
            batch, aux = st.pop()
            assert int(batch[0]) == aux
            got.append(aux)
    t.join(10.0)
    assert got == list(range(n)) and len(st) == 0
    assert st.staged_total == n


def test_multihost_agreement_goes_through_the_mesh():
    """The agreement's all-reduce is ``Mesh.psum`` now: multihost.py
    calls no torch.distributed collective of its own."""
    src = (REPO / PKG / "actors" / "multihost.py").read_text()
    assert "mesh.psum([counters])" in src
    assert "dist.all_reduce" not in src and "import torch.distributed" \
        not in src
