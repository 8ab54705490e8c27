"""The port's flight recorder, stall watchdog, divergence sentinel and
forensics bundles (dist_dqn_tpu_torch/telemetry/flight.py, watchdog.py)
against the JAX package's: the twins of tests/test_flight_watchdog.py,
each holding the port to the JAX module on the same inputs, exactly
unless stated:

  * ring tails event for event, less ``t`` and ``thread``;
  * the file set of a forensics bundle and the keys of its
    ``reason.json``;
  * the sentinel's trip sequence on one stream of observations;
  * the ``/debug`` routes, the run manifest and the evaluate CLI's
    telemetry surface.

Two twins are sturdier than JAX's: the wedged-evacuation case waits up to
60 s and returns as soon as the bundle lands, and the recorder on/off case
pins the count of flight events per chunk instead of a ratio of wall
times. The port-only cases cover what the port adds: the emergency hook's
fence lock and the abort's hard exit 70.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.telemetry import flight as jflight
from dist_dqn_tpu.telemetry import manifest as jmanifest
from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu.telemetry import watchdog as jwatchdog
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.telemetry import flight as tflight
from dist_dqn_tpu_torch.telemetry import manifest as tmanifest
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.telemetry import watchdog as twatchdog
from dist_dqn_tpu_torch.telemetry.flight import (FlightRecorder,
                                                 NullFlightRecorder)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = lambda *_: None  # noqa: E731


@pytest.fixture(autouse=True)
def _fresh_forensics_globals(monkeypatch):
    """Each test gets fresh flight rings, no installed watchdog, fresh
    sentinels and no run manifest, in both packages (all are process
    globals)."""
    for var in ("DQN_FORENSICS_DIR", "DQN_FLIGHT_RECORDER",
                "DQN_FLIGHT_CAPACITY", "DQN_FLEET_DIR"):
        monkeypatch.delenv(var, raising=False)
    mods = (jflight, jwatchdog, jmanifest, tflight, twatchdog, tmanifest)
    for mod in mods:
        mod._reset_for_tests()
    yield
    for mod in mods:
        mod._reset_for_tests()


def _tiny(cfg_mod, **learner_overrides):
    cfg = cfg_mod.CONFIGS["cartpole"]
    return dataclasses.replace(
        cfg,
        replay=dataclasses.replace(cfg.replay, capacity=2048, min_fill=128),
        learner=dataclasses.replace(cfg.learner, **learner_overrides),
        eval_every_steps=0)


def _wait_for(predicate, timeout_s=10.0, what="condition"):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _events(recorder):
    """A tail less the wall clock and the thread name."""
    return [{k: v for k, v in e.items() if k not in ("t", "thread")}
            for e in recorder.tail()]


def _train_both(sets, lr=None, stop_fn=None, **kw):
    """The JAX fused loop and the port's on one tiny CartPole config."""
    from dist_dqn_tpu.train import train as jtrain
    from dist_dqn_tpu_torch.train import train as ttrain

    over = {} if lr is None else {"learning_rate": lr}
    jcfg = jconfig.apply_overrides(_tiny(jconfig, **over), sets)
    tcfg = tconfig.apply_overrides(_tiny(tconfig, **over), sets)
    jtrain(jcfg, log_fn=QUIET, stop_fn=stop_fn, **kw)
    ttrain(tcfg, log_fn=QUIET, stop_fn=stop_fn, device="cpu", **kw)


# -- flight recorder ----------------------------------------------------------

def test_flight_ring_wraps_and_keeps_newest():
    """The same 20 records into both rings of 8: the same newest 8 events
    in the same order, the same counts and snapshot shape."""
    rings = FlightRecorder(capacity=8), jflight.FlightRecorder(capacity=8)
    for r in rings:
        for i in range(20):
            r.record("k", f"e{i}", i=i)
    r, j = rings
    assert r.total == j.total == 20 and len(r) == len(j) == 8
    assert _events(r) == _events(j)
    tail = r.tail()
    assert [e["name"] for e in tail] == [f"e{i}" for i in range(12, 20)]
    assert r.tail(3) == tail[-3:]
    ev = tail[-1]
    assert ev["kind"] == "k" and ev["i"] == 19
    assert ev["thread"] == "MainThread" and ev["t"] > 0
    snap = json.loads(json.dumps(r.snapshot()))  # JSON-able
    assert set(snap) == set(j.snapshot())
    assert snap["total"] == 20 and len(snap["events"]) == 8


def test_null_flight_recorder_is_inert_and_env_disables(monkeypatch):
    n = NullFlightRecorder()
    n.record("k", "x", a=1)
    assert n.tail() == [] and n.total == 0 and not n.enabled
    assert n.snapshot() == jflight.NullFlightRecorder().snapshot()
    assert (tflight.ENABLE_ENV, tflight.CAPACITY_ENV) == (
        jflight.ENABLE_ENV, jflight.CAPACITY_ENV)
    monkeypatch.setenv("DQN_FLIGHT_RECORDER", "0")
    tflight._reset_for_tests()
    assert not tflight.get_flight().enabled   # --no-flight-recorder's env
    monkeypatch.delenv("DQN_FLIGHT_RECORDER")
    monkeypatch.setenv("DQN_FLIGHT_CAPACITY", "17")
    tflight._reset_for_tests()
    fr = tflight.get_flight()
    assert fr.enabled and fr.capacity == 17


def test_flight_record_overhead_microbench():
    """The per-event cost the 'about a microsecond' claim rests on: a
    generous 50µs/event bound catches an accidental O(capacity) or I/O
    regression."""
    r = FlightRecorder(capacity=1024)
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        r.record("span", "bench", dur_s=0.001)
    per_event = (time.perf_counter() - t0) / n
    assert per_event < 50e-6, f"record() costs {per_event * 1e6:.1f}µs"


def test_make_tracer_feeds_flight_ring():
    """Without a Chrome trace path the span call sites feed the flight
    ring (FlightTracer), event for event as JAX's does (less the span's
    measured duration); the inert NullTracer when the recorder is off."""
    from dist_dqn_tpu.utils.trace import make_tracer as jmake
    from dist_dqn_tpu_torch.utils.trace import (FlightTracer, NullTracer,
                                                make_tracer)

    tails = []
    for mod, make in ((tflight, make_tracer), (jflight, jmake)):
        fr = mod.configure(enabled=True, capacity=64)
        tr = make(None)
        with tr.span("work", rows=3):
            pass
        tr.instant("boom", why="test")
        tr.counter("depth", 2)
        assert not tr.enabled
        tails.append(_events(fr))
    assert isinstance(make_tracer(None), FlightTracer)
    ours, theirs = tails
    assert all(e.pop("dur_s") >= 0 for e in (ours[0], theirs[0]))
    assert ours == theirs
    assert ours[0] == {"kind": "span", "name": "work", "rows": 3}
    assert ours[2] == {"kind": "counter", "name": "depth", "value": 2.0}
    tflight.configure(enabled=False)
    assert type(make_tracer(None)) is NullTracer


def test_span_tracer_mirrors_into_the_ring(tmp_path):
    """A live SpanTracer writes its Chrome trace and mirrors every span
    and instant into the flight ring, as JAX's does."""
    from dist_dqn_tpu.utils.trace import SpanTracer as JSpanTracer
    from dist_dqn_tpu_torch.utils.trace import SpanTracer

    tails = []
    for mod, cls, name in ((tflight, SpanTracer, "t.json"),
                           (jflight, JSpanTracer, "j.json")):
        fr = mod.configure(enabled=True, capacity=64)
        tr = cls(str(tmp_path / name), registry=(
            tregistry.Registry() if cls is SpanTracer
            else jregistry.Registry()))
        with tr.span("train_step.dispatch", substeps=2):
            pass
        tr.instant("ingest_degraded", dead=1)
        tr.counter("replay_size", 5)     # a counter track only
        tr.close()
        tails.append(_events(fr))
    for tail in tails:
        tail[0].pop("dur_s")
    assert tails[0] == tails[1] == [
        {"kind": "span", "name": "train_step.dispatch", "substeps": 2},
        {"kind": "instant", "name": "ingest_degraded", "dead": 1}]
    assert json.loads((tmp_path / "t.json").read_text())[1]["name"] == \
        "train_step.dispatch"


# -- watchdog -----------------------------------------------------------------

def test_heartbeat_lifecycle_drives_healthz():
    wd = twatchdog.install_watchdog(deadline_s=0.15, poll_s=0.05,
                                    log_fn=None)
    hb = telemetry.heartbeat("test.stage")
    assert wd.healthz()[0]
    _wait_for(lambda: not wd.healthz()[0], what="stale heartbeat")
    ok, stale = wd.healthz()
    assert "test.stage" in stale
    _wait_for(lambda: telemetry.get_registry().counter(
        twatchdog.WATCHDOG_STALLS,
        labels={"stage": "test.stage"}).value >= 1, what="stall counter")
    hb.beat()
    assert wd.healthz()[0]
    # A FINISHED stage is not a stall: expire again, then close.
    _wait_for(lambda: not wd.healthz()[0], what="second expiry")
    hb.close()
    assert wd.healthz()[0]
    assert twatchdog.DEFAULT_DEADLINE_S == jwatchdog.DEFAULT_DEADLINE_S
    assert twatchdog.STARTUP_GRACE_S == jwatchdog.STARTUP_GRACE_S


def test_startup_grace_covers_the_first_compile_window():
    wd = twatchdog.install_watchdog(deadline_s=0.1, poll_s=0.05,
                                    log_fn=None)
    hb = telemetry.heartbeat("grace.stage", startup_grace_s=30.0)
    time.sleep(0.3)
    assert wd.healthz()[0]     # deadline passed, grace still covering
    hb.beat()                  # the stage proved itself: normal deadline
    _wait_for(lambda: not wd.healthz()[0], what="post-grace staleness")
    hb.close()


def test_wedged_evacuation_worker_dumps_bundle_and_flips_healthz(tmp_path):
    """A wedged EvacuationWorker produces a forensics bundle (stacks
    naming the wedged thread, a flight tail with its submit, a registry
    snapshot, the manifest) and flips /healthz to 503; un-wedged, beats
    resume and /healthz recovers. Waits up to 60 s for the bundle and
    returns as soon as it lands."""
    from dist_dqn_tpu_torch.replay.staging import (EvacuationWorker,
                                                   StreamedEvacuator)
    twatchdog.install_watchdog(forensics_dir=str(tmp_path),
                               deadline_s=0.3, poll_s=0.05, log_fn=None)
    release = threading.Event()

    def wedged_on_slice(tree, lo, hi):
        release.wait(timeout=120)  # the injected hang

    evac = StreamedEvacuator(num_slices=2, name="wedge")
    worker = EvacuationWorker(evac, wedged_on_slice, name="wedge")
    server = telemetry.start_server(0)
    url = f"http://127.0.0.1:{server.port}/healthz"
    try:
        worker.submit({"obs": torch.zeros((8, 2, 4)),
                       "action": torch.zeros((8, 2), dtype=torch.int32)})
        # Bundles rename from "*.writing" only when complete.
        done = lambda: [b for b in os.listdir(tmp_path)  # noqa: E731
                        if b.endswith("watchdog_stall")]
        _wait_for(lambda: done(), timeout_s=60, what="forensics bundle")
        bundle = tmp_path / done()[0]
        reason = json.loads((bundle / "reason.json").read_text())
        assert "evac.wedge" in reason["detail"]["stale"]
        stacks = (bundle / "stacks.txt").read_text()
        assert "evac-wedge" in stacks          # the wedged thread BY NAME
        assert "wedged_on_slice" in stacks     # parked exactly here
        names = [e["name"] for e in json.loads(
            (bundle / "flight.json").read_text())["events"]]
        assert "evac.wedge.submit" in names
        registry_dump = json.loads((bundle / "registry.json").read_text())
        assert any(k.startswith("dqn_") for k in registry_dump)
        man = json.loads((bundle / "manifest.json").read_text())
        assert man["schema_version"] == tmanifest.SCHEMA_VERSION
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(url, timeout=10)
        assert exc_info.value.code == 503
        body = json.loads(exc_info.value.read())
        assert "evac.wedge" in body["stale_stages_age_s"]
        assert twatchdog.get_watchdog().bundle_errors == []
        release.set()

        def healthy():
            # 503 until the released worker beats again (urlopen raises
            # on it): keep polling for the 200, up to the wait's bound.
            try:
                return urllib.request.urlopen(url, timeout=10).status == 200
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
                return False

        _wait_for(healthy, timeout_s=60, what="healthz recovery")
        assert "evac.wedge.drained" in [
            e["name"] for e in tflight.get_flight().tail()]
    finally:
        release.set()
        worker.close()
        server.close()
    # A closed worker deregisters its stage: no post-run false stall.
    assert "evac.wedge" not in twatchdog.get_watchdog().stages()


def test_bundle_file_set_and_reason_keys_match_jax(tmp_path):
    """One bundle from each package for the same trigger and detail: the
    same files and the same ``reason.json`` keys, each counted under its
    trigger in the registry it was given."""
    detail = {"stale": {"x": 1.5}, "newly_stale": ["x"]}
    regs = tregistry.Registry(), jregistry.Registry()
    paths = [mod.dump_forensics(str(tmp_path / name), "watchdog_stall",
                                detail=detail, registry=reg, log_fn=None)
             for mod, name, reg in ((twatchdog, "t", regs[0]),
                                    (jwatchdog, "j", regs[1]))]
    files = [sorted(os.listdir(p)) for p in paths]
    assert files[0] == files[1] == ["flight.json", "manifest.json",
                                    "reason.json", "registry.json",
                                    "stacks.txt"]
    reasons = [json.loads(open(os.path.join(p, "reason.json")).read())
               for p in paths]
    assert set(reasons[0]) == set(reasons[1])
    assert reasons[0]["detail"] == reasons[1]["detail"] == detail
    assert os.path.basename(paths[0]).endswith("_watchdog_stall")
    key = "dqn_forensics_bundles_total{trigger=watchdog_stall}"
    assert regs[0].snapshot()[key]["value"] == \
        regs[1].snapshot()[key]["value"] == 1
    assert not [d for d in os.listdir(tmp_path / "t")
                if d.endswith(".writing")]


def test_debug_routes_serve_stacks_flight_config():
    """``/debug/flight`` serves the ring's snapshot as JAX's does, event
    for event less ``t`` and ``thread``, beside the stacks and config
    routes; /healthz without a watchdog stays the static ok."""
    from dist_dqn_tpu.telemetry import server as jserver

    for mod in (tflight, jflight):
        mod.get_flight().record("chunk", "dbg_marker", x=1)
    for mod in (tmanifest, jmanifest):
        mod.set_run_manifest({"schema_version": 1, "git_sha": "abc"})
    servers = telemetry.start_server(0), jserver.start_server(0)
    try:
        ours, theirs = (f"http://127.0.0.1:{s.port}" for s in servers)
        stacks = urllib.request.urlopen(ours + "/debug/stacks").read() \
            .decode()
        assert "MainThread" in stacks and "telemetry-http" in stacks
        flights = [json.loads(urllib.request.urlopen(b + "/debug/flight")
                              .read()) for b in (ours, theirs)]
        for fl in flights:
            for e in fl["events"]:
                del e["t"], e["thread"]
        assert flights[0] == flights[1]
        assert flights[0]["events"] == [
            {"kind": "chunk", "name": "dbg_marker", "x": 1}]
        cfgd = json.loads(urllib.request.urlopen(ours + "/debug/config")
                          .read())
        assert cfgd == {"schema_version": 1, "git_sha": "abc"}
        assert urllib.request.urlopen(ours + "/healthz").read() == b"ok\n"
    finally:
        for s in servers:
            s.close()


# -- divergence sentinel ------------------------------------------------------

_STREAM = [dict(loss=0.5, grad_norm=1.0, step=1),
           dict(loss=float("nan"), step=2),
           dict(loss=float("nan"), step=3),
           dict(grad_norm=float("inf"), step=4),
           dict(param_checksum=2.0, step=5),
           dict(param_checksum=3.0, step=6),
           dict(param_checksum=1e9, step=7),
           dict(param_checksum=float("-inf"), step=8),
           dict(loss=0.1, step=9)]


def test_sentinel_nonfinite_trips_once_and_dumps(tmp_path):
    """One stream of observations through both sentinels: the same trip
    sequence, one bundle and one counted trip per signal (latched)."""
    seqs, sentinels = [], []
    for mod, name in ((twatchdog, "t"), (jwatchdog, "j")):
        reg = (tregistry.Registry() if mod is twatchdog
               else jregistry.Registry())
        s = mod.DivergenceSentinel(forensics_dir=str(tmp_path / name),
                                   log_fn=None, registry=reg)
        seqs.append([s.observe(**o) for o in _STREAM])
        sentinels.append((s, reg))
    assert seqs[0] == seqs[1] == [
        None, "loss_nonfinite", "loss_nonfinite", "grad_norm_nonfinite",
        None, None, "param_checksum_explosion", "param_checksum_nonfinite",
        None]
    (s, reg), (js, jreg) = sentinels
    assert s.tripped == js.tripped
    for sig in ("loss_nonfinite", "grad_norm_nonfinite"):
        key = f"dqn_divergence_trips_total{{signal={sig}}}"
        assert reg.snapshot()[key]["value"] == \
            jreg.snapshot()[key]["value"] == 1
    # <date>_<time>_pid<P>_<seq>_<reason>: the reasons, in both packages.
    bundles = sorted(b.split("_", 4)[-1] for b in os.listdir(tmp_path / "t"))
    assert bundles == sorted(b.split("_", 4)[-1]
                             for b in os.listdir(tmp_path / "j"))
    assert bundles == ["divergence_grad_norm_nonfinite",
                       "divergence_loss_nonfinite",
                       "divergence_param_checksum_explosion",
                       "divergence_param_checksum_nonfinite"]
    assert len(bundles) == 4 and s.bundles and not s.bundle_errors


def test_sentinel_checksum_explosion(tmp_path):
    s = twatchdog.DivergenceSentinel(forensics_dir=str(tmp_path),
                                     explosion_factor=1e4, log_fn=None)
    assert s.observe(param_checksum=2.0) is None
    assert s.observe(param_checksum=3.0) is None
    assert s.observe(param_checksum=1e9) == "param_checksum_explosion"
    reason = json.loads(
        (tmp_path / os.listdir(tmp_path)[0] / "reason.json").read_text())
    assert reason["reason"] == "divergence_param_checksum_explosion"
    # The failed-write record: a bundle under an unwritable path is
    # counted on the sentinel, never swallowed silently.
    bad = twatchdog.DivergenceSentinel(
        forensics_dir=str(tmp_path / "file"), log_fn=None)
    (tmp_path / "file").write_text("not a directory")
    assert bad.observe(loss=float("nan")) == "loss_nonfinite"
    assert bad.bundles == [] and len(bad.bundle_errors) == 1
    assert any(e["name"] == "bundle_failed"
               for e in tflight.get_flight().tail())


def test_nan_loss_injection_produces_bundle(tmp_path):
    """An injected NaN loss (an absurd learning rate) trips the sentinel
    wired into both fused loops: the same trigger in both bundles, the
    trip counted in each registry snapshot, and the armed sentinel's
    latch flips the port's /healthz to 503."""
    twatchdog.install_sentinel(forensics_dir=str(tmp_path / "t"),
                               log_fn=QUIET)
    jwatchdog.install_sentinel(forensics_dir=str(tmp_path / "j"),
                               log_fn=QUIET)
    _train_both([], lr=1e30, total_env_steps=3_000, chunk_iters=50)
    reasons = []
    for name in ("t", "j"):
        bundles = [b for b in os.listdir(tmp_path / name)
                   if "divergence" in b]
        assert bundles, f"{name}: NaN/Inf loss never tripped the sentinel"
        bundle = tmp_path / name / bundles[0]
        reasons.append(json.loads((bundle / "reason.json").read_text()))
        dump = json.loads((bundle / "registry.json").read_text())
        assert any(k.startswith(twatchdog.DIVERGENCE_TRIPS) for k in dump)
        man = json.loads((bundle / "manifest.json").read_text())
        assert man["schema_version"] == tmanifest.SCHEMA_VERSION
    assert reasons[0]["reason"] == reasons[1]["reason"] == \
        "divergence_loss_nonfinite"
    server = telemetry.start_server(0)
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=10)
        assert exc_info.value.code == 503
        assert json.loads(exc_info.value.read())["diverged"] == [
            "loss_nonfinite"]
    finally:
        server.close()


# -- the recorder off the per-step path ---------------------------------------

def test_cartpole_smoke_rate_within_noise_of_recorder_off():
    """The recorder is on the per-chunk path, not the per-env-step one:
    a fused run records exactly one flight event per chunk, as JAX's
    loop does, whatever the chunk's length; with the recorder off it
    records none."""
    counts = {}
    for chunk_iters in (25, 50):
        for mod in (tflight, jflight):
            mod.configure(enabled=True)
        _train_both([], total_env_steps=1600, chunk_iters=chunk_iters)
        chunks = 1600 // (chunk_iters * 16)
        for name, mod in (("t", tflight), ("j", jflight)):
            tail = mod.get_flight().tail()
            assert [e["name"] for e in tail] == ["fused.chunk"] * chunks
            counts[name, chunk_iters] = len(tail)
        assert all(math.isfinite(e["loss"])
                   for e in tflight.get_flight().tail())
    assert counts[("t", 25)] == counts[("j", 25)] == 4
    assert counts[("t", 50)] == counts[("j", 50)] == 2
    tflight.configure(enabled=False)
    from dist_dqn_tpu_torch.train import train as ttrain
    ttrain(_tiny(tconfig), total_env_steps=800, chunk_iters=50,
           log_fn=QUIET, device="cpu")
    assert tflight.get_flight().total == 0


# -- the emergency hook and the abort -----------------------------------------

def test_emergency_hook_saves_a_state_at_a_fence(tmp_path):
    """The fused loop's ``fused.checkpoint`` hook: between chunks it
    saves the learner (restorable, equal to the loop's own final save at
    the same fence); while the loop holds its fence lock the hook times
    out and ``run_emergency_hooks`` logs it ``completed: false``."""
    from dist_dqn_tpu_torch.train import train as ttrain
    from dist_dqn_tpu_torch.utils.checkpoint import _torch_load

    lines, seen = [], {}

    def stop_fn(row):
        # Between chunks: the loop is past its fence.
        twatchdog.run_emergency_hooks(timeout_s=30, log_fn=lines.append)
        seen["frames"] = row["env_frames"]
        return row["env_frames"] >= 1600

    ckpt = tmp_path / "ckpt"
    carry, _ = ttrain(_tiny(tconfig), total_env_steps=3200, chunk_iters=50,
                      log_fn=QUIET, device="cpu", checkpoint_dir=str(ckpt),
                      save_every_frames=100_000, stop_fn=stop_fn)
    assert [json.loads(x)["completed"] for x in lines] == [True, True]
    saved = _torch_load(str(ckpt / "emergency_learner.pt"))["learner"]
    final = dict(carry.learner.net.state_dict())
    got = saved["net"]
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k], v), k
    assert "fused.checkpoint" not in twatchdog._emergency_hooks

    fence = twatchdog.FenceLock()
    from dist_dqn_tpu_torch.utils.checkpoint import save_emergency
    twatchdog.register_emergency_hook(
        "held", lambda: save_emergency(str(tmp_path / "never.pt"),
                                       lambda: {"x": torch.ones(2)}, fence,
                                       0.2))
    lines.clear()
    with fence.held():
        twatchdog.run_emergency_hooks(timeout_s=5, log_fn=lines.append)
    row = json.loads(lines[0])
    assert row["emergency_hook"] == "held" and not row["completed"]
    assert row["error"].startswith("TimeoutError")
    assert not (tmp_path / "never.pt").exists()


_ABORT = r"""
import signal, sys, time
sys.path.insert(0, {repo!r})
from dist_dqn_tpu_torch.telemetry import watchdog
# The main thread 'in C code': a SIGTERM handler that never gets to run.
signal.signal(signal.SIGTERM, signal.SIG_IGN)
watchdog.register_emergency_hook("probe", lambda: print("hook ran",
                                                       flush=True))
wd = watchdog.install_watchdog(forensics_dir={bundles!r}, deadline_s=0.2,
                               poll_s=0.05, abort=True,
                               log_fn=lambda s: print(s, flush=True))
wd.abort_grace_s = 0.5
hb = watchdog.heartbeat("wedged.stage")
time.sleep(30)
print("not reached", flush=True)
"""


def test_watchdog_abort_hard_exits_70_past_the_grace(tmp_path):
    """``--watchdog-abort`` with a main thread that never runs its SIGTERM
    handler: the bundle, the emergency hook, then the hard exit 70 after
    the grace (JAX's code)."""
    script = _ABORT.format(repo=REPO, bundles=str(tmp_path / "f"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 70, proc.stdout + proc.stderr
    assert time.monotonic() - t0 < 20
    out = proc.stdout
    assert "hook ran" in out and "not reached" not in out
    assert json.loads([x for x in out.splitlines()
                       if "emergency_hook" in x][0])["completed"] is True
    assert [b for b in os.listdir(tmp_path / "f")
            if b.endswith("watchdog_stall")]


# -- manifest + evaluate CLI surface -----------------------------------------

def test_build_manifest_fields_and_config_hash():
    m = tmanifest.build_manifest(tconfig.CONFIGS["cartpole"],
                                 argv=["prog", "-x"])
    jm = jmanifest.build_manifest(jconfig.CONFIGS["cartpole"],
                                  argv=["prog", "-x"])
    assert m["schema_version"] == jm["schema_version"] == \
        tmanifest.SCHEMA_VERSION
    assert m["config_name"] == "cartpole" and m["argv"] == ["prog", "-x"]
    assert m["config_hash"] == jm["config_hash"]
    assert len(m["config_hash"]) == 16
    assert m["versions"]["python"] and m["versions"]["numpy"]
    assert m["git_sha"] is None or len(m["git_sha"]) == 40
    assert tmanifest.build_manifest(
        tconfig.CONFIGS["atari"])["config_hash"] != m["config_hash"]
    tmanifest.set_run_manifest(m)
    assert tmanifest.get_run_manifest()["config_name"] == "cartpole"


def test_evaluate_cli_serves_telemetry(tmp_path):
    """The port's evaluate CLI announces its scrape port, joins the fleet
    as an eval-role member while it plays, and dumps an exit snapshot."""
    from dist_dqn_tpu_torch.train import train as ttrain

    ckpt_dir = tmp_path / "ckpt"
    ttrain(_tiny(tconfig), total_env_steps=300, chunk_iters=50,
           checkpoint_dir=str(ckpt_dir), log_fn=QUIET, device="cpu")
    snap = tmp_path / "eval_snapshot.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "dist_dqn_tpu_torch.evaluate",
         "--config", "cartpole", "--checkpoint-dir", str(ckpt_dir),
         "--episodes", "1", "--device", "cpu", "--telemetry-port", "0",
         "--telemetry-snapshot", str(snap),
         "--fleet-dir", str(tmp_path / "fleet")],
        capture_output=True, text=True, timeout=280, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    assert any("telemetry_port" in r for r in rows)
    assert any("eval_return" in r for r in rows)
    json.loads(snap.read_text())
    # The descriptor went with the run.
    assert os.listdir(tmp_path / "fleet") == []
