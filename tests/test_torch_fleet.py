"""The port's fleet plane (dist_dqn_tpu_torch/telemetry/fleet.py) against
the JAX package's (dist_dqn_tpu/telemetry/fleet.py): the twins of the
non-slow tests of tests/test_fleet.py, each holding the port to the JAX
module on the same inputs.

  * the endpoint registry: descriptor keys, atomic writes, lifecycle
    removal, live-collision refusal, aggregator-only removal of a dead
    member's descriptor;
  * federation: ``merge_expositions`` byte for byte on the same pages, a
    member killed between sweeps degrading to labeled staleness while the
    fleet scrape stays 200, the forensics and profile fan-outs naming
    every member, ``/fleet/status`` with the JAX rollup's keys;
  * experience lineage: the stamps survive the port's plain, dedup and
    batched-shm wire bit for bit, encoded as the JAX codec encodes them,
    and the three runtimes share one histogram constructor.

The live demo runs the real ``python -m dist_dqn_tpu_torch.telemetry.fleet``
CLI against two telemetry servers. Everything here is stdlib + numpy on
both sides; nothing imports torch but the profile fan-out's capture.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dist_dqn_tpu import ingest as jingest
from dist_dqn_tpu.telemetry import collectors as jcollectors
from dist_dqn_tpu.telemetry import fleet as jfleet
from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu.telemetry import server as jserver
from dist_dqn_tpu_torch import ingest
from dist_dqn_tpu_torch.telemetry import collectors as tmc
from dist_dqn_tpu_torch.telemetry import fleet
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.telemetry.registry import Registry
from dist_dqn_tpu_torch.telemetry.server import TelemetryServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(url: str, timeout: float = 3.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        assert resp.status == 200
        return resp.read()


def _dead_pid() -> int:
    """A pid that is definitely not running (spawned, exited, reaped)."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def _dead_descriptor(tmp_path) -> dict:
    dead = {"schema_version": 1, "role": "actor", "pid": _dead_pid(),
            "host": "127.0.0.1", "port": 1,  # nothing listens there
            "hostname": socket.gethostname(), "labels": {},
            "start_time": 2.0, "manifest_hash": None}
    (tmp_path / f"actor-{dead['pid']}.json").write_text(json.dumps(dead))
    return dead


# ---------------------------------------------------------------------------
# Endpoint registry
# ---------------------------------------------------------------------------

def test_register_endpoint_noop_without_fleet_dir(monkeypatch):
    monkeypatch.delenv(fleet.FLEET_ENV, raising=False)
    assert fleet.FLEET_ENV == jfleet.FLEET_ENV
    assert fleet.register_endpoint("learner", 1234) is None
    assert jfleet.register_endpoint("learner", 1234) is None


def test_register_endpoint_descriptor_and_removal(tmp_path):
    """The descriptor has the JAX descriptor's keys and values (less the
    start time) for the same call, written without tmp litter, and goes
    with ``close()`` (idempotent)."""
    (tmp_path / "jax").mkdir()
    reg = fleet.register_endpoint(
        "actor", 4321, labels={"actor_id": "7"}, fleet_dir=str(tmp_path))
    jreg = jfleet.register_endpoint(
        "actor", 4321, labels={"actor_id": "7"},
        fleet_dir=str(tmp_path / "jax"))
    path = tmp_path / f"actor-{os.getpid()}.json"
    assert reg is not None and reg.path == str(path)
    desc = json.loads(path.read_text())
    want = json.loads(open(jreg.path).read())
    jreg.close()
    assert set(desc) == set(want)
    for key in set(want) - {"start_time", "manifest_hash"}:
        assert desc[key] == want[key], key
    assert desc["role"] == "actor" and desc["pid"] == os.getpid()
    assert desc["port"] == 4321 and desc["labels"] == {"actor_id": "7"}
    assert desc["hostname"] == socket.gethostname()
    assert not list(tmp_path.glob("*.tmp.*")), "no torn tmp litter"
    reg.close()
    assert not path.exists()
    reg.close()  # idempotent


def test_register_endpoint_refuses_live_collision(tmp_path):
    """Same role+pid, another endpoint, a live claimant: refused, as JAX
    refuses; the same identity again is a refresh."""
    first = fleet.register_endpoint("learner", 1111,
                                    fleet_dir=str(tmp_path))
    try:
        with pytest.raises(fleet.FleetRegistrationError):
            fleet.register_endpoint("learner", 2222,
                                    fleet_dir=str(tmp_path))
        # The JAX registry reads the port's descriptor the same way.
        with pytest.raises(jfleet.FleetRegistrationError):
            jfleet.register_endpoint("learner", 2222,
                                     fleet_dir=str(tmp_path))
        again = fleet.register_endpoint("learner", 1111,
                                        fleet_dir=str(tmp_path))
        assert again is not None
        again.close()
    finally:
        first.close()


def test_register_endpoint_reclaims_dead_pid_slot(tmp_path):
    path = tmp_path / f"eval-{os.getpid()}.json"
    stale = {"schema_version": 1, "role": "eval", "pid": _dead_pid(),
             "host": "127.0.0.1", "port": 9999,
             "hostname": socket.gethostname(), "labels": {},
             "start_time": 1.0, "manifest_hash": None}
    path.write_text(json.dumps(stale))
    reg = fleet.register_endpoint("eval", 1234, fleet_dir=str(tmp_path))
    try:
        assert json.loads(path.read_text())["port"] == 1234
    finally:
        reg.close()


def test_dead_member_gc_is_aggregator_only(tmp_path):
    """A crashed local member stays ``dead`` in the rollup; its descriptor
    survives a live peer's registration and goes at the aggregator's
    ``DEAD_GC_SWEEPS``-th sweep, the JAX count."""
    assert fleet.DEAD_GC_SWEEPS == jfleet.DEAD_GC_SWEEPS
    dead = _dead_descriptor(tmp_path)
    dead_path = tmp_path / f"actor-{dead['pid']}.json"
    peer = fleet.register_endpoint("learner", 1234,
                                   fleet_dir=str(tmp_path))
    assert dead_path.exists(), "a live peer never removes another's slot"
    agg = fleet.FleetAggregator(str(tmp_path), scrape_timeout_s=0.3)
    for i in range(fleet.DEAD_GC_SWEEPS):
        agg.sweep_once()
        assert dead_path.exists() == (i < fleet.DEAD_GC_SWEEPS - 1)
    st = agg.status()
    name = f"actor-{dead['pid']}"
    assert st["members"][name]["state"] == "dead"
    assert any("dead" in a for a in st["alerts"])
    assert st["ingest_degraded"] is True
    agg.sweep_once()
    assert agg.status()["members"][name]["state"] == "dead"
    peer.close()


# ---------------------------------------------------------------------------
# Federation
# ---------------------------------------------------------------------------

_PAGE_A = ("# HELP dqn_x things\n# TYPE dqn_x counter\n"
           "dqn_x 3\n"
           "# HELP dqn_h lat\n# TYPE dqn_h histogram\n"
           'dqn_h_bucket{le="1"} 2\ndqn_h_bucket{le="+Inf"} 2\n'
           "dqn_h_sum 0.5\ndqn_h_count 2\n")
_PAGE_B = '# HELP dqn_x things\n# TYPE dqn_x counter\ndqn_x{k="v w"} 5\n'


def _filled(reg_mod):
    reg = reg_mod.Registry()
    reg.counter("dqn_a_total", "a", {"k": 'q"uote'}).inc(3)
    reg.gauge("dqn_g", "g").set(-1.5)
    reg.histogram("dqn_lat_seconds", "h", {"loop": "apex"}).observe(0.2)
    return reg


def test_merge_expositions_labels_every_sample_line():
    """Byte for byte the JAX merge on the same pages: the hand-written
    pages of JAX's test and each package's rendering of one registry."""
    from dist_dqn_tpu.telemetry.exposition import render_prometheus as jr
    from dist_dqn_tpu_torch.telemetry.exposition import \
        render_prometheus as tr

    pages = [{"text": _PAGE_A, "labels": {"process": "learner-1",
                                          "role": "learner"}},
             {"text": _PAGE_B, "labels": {"process": "actor-2",
                                          "role": "actor"}},
             {"text": tr(_filled(tregistry)),
              "labels": {"process": "eval-3", "role": "eval"}},
             {"text": jr(_filled(jregistry)), "labels": {}}]
    out = fleet.merge_expositions(pages)
    assert out == jfleet.merge_expositions(pages)
    assert out.count("# HELP dqn_x") == 1 and out.count("# TYPE dqn_x") == 1
    assert 'dqn_x{process="learner-1",role="learner"} 3' in out
    assert 'dqn_x{k="v w",process="actor-2",role="actor"} 5' in out
    assert ('dqn_h_bucket{le="+Inf",process="learner-1",role="learner"} 2'
            in out)
    assert out.index("# TYPE dqn_h") < out.index("dqn_h_bucket")


def test_killed_member_degrades_to_stale_and_scrape_stays_200(tmp_path):
    reg_a, reg_b = Registry(), Registry()
    reg_a.counter("dqn_alpha_total", "a").inc(7)
    reg_b.counter("dqn_beta_total", "b").inc(9)
    srv_a = TelemetryServer(registry=reg_a)
    srv_b = TelemetryServer(registry=reg_b)
    ra = fleet.register_endpoint("learner", srv_a.port,
                                 fleet_dir=str(tmp_path))
    rb = fleet.register_endpoint("actor", srv_b.port,
                                 fleet_dir=str(tmp_path))
    agg = fleet.FleetAggregator(str(tmp_path), scrape_timeout_s=1.0)
    pane = fleet.FleetServer(agg)
    pid = os.getpid()
    try:
        agg.sweep_once()
        assert agg.status()["counts"] == {"live": 2, "stale": 0, "dead": 0}
        merged = _get(f"http://127.0.0.1:{pane.port}/metrics").decode()
        assert f'dqn_alpha_total{{process="learner-{pid}"' in merged
        assert f'dqn_beta_total{{process="actor-{pid}"' in merged

        srv_b.close()  # the mid-run kill (the pid, this process, lives on)
        agg.sweep_once()
        st = agg.status()
        assert st["counts"] == {"live": 1, "stale": 1, "dead": 0}
        assert st["members"][f"actor-{pid}"]["state"] == "stale"
        assert st["members"][f"actor-{pid}"]["staleness_s"] >= 0

        merged = _get(f"http://127.0.0.1:{pane.port}/metrics").decode()
        assert "dqn_beta_total" in merged
        assert (f'dqn_fleet_member_up{{process="actor-{pid}",'
                f'role="actor"}} 0') in merged
        assert (f'dqn_fleet_member_up{{process="learner-{pid}",'
                f'role="learner"}} 1') in merged
        assert "dqn_fleet_sweeps_total 2" in merged
        body = json.loads(_get(f"http://127.0.0.1:{pane.port}/fleet/status"))
        assert body["members"][f"actor-{pid}"]["state"] == "stale"
        assert _get(f"http://127.0.0.1:{pane.port}/healthz") == b"ok\n"
    finally:
        pane.close()
        srv_a.close()
        ra.close()
        rb.close()


def test_fleet_status_keys_match_jax(tmp_path):
    """``/fleet/status`` of both aggregators over one fleet dir (a live
    member, a dead one): the same top-level and per-member keys, states,
    counts and degradation, and an unhealthy member's 503 detail carried
    verbatim in both."""
    from dist_dqn_tpu_torch.telemetry import watchdog as twatchdog

    srv = TelemetryServer(registry=Registry())
    ra = fleet.register_endpoint("learner", srv.port,
                                 fleet_dir=str(tmp_path))
    dead = _dead_descriptor(tmp_path)
    twatchdog.register_health_probe("fleet_test", lambda: {"why": "x"})
    try:
        ours = fleet.FleetAggregator(str(tmp_path), scrape_timeout_s=1.0)
        theirs = jfleet.FleetAggregator(str(tmp_path), scrape_timeout_s=1.0)
        ours.sweep_once()
        theirs.sweep_once()
        got, want = ours.status(), theirs.status()
    finally:
        twatchdog.unregister_health_probe("fleet_test")
        srv.close()
        ra.close()
    assert set(got) == set(want)
    assert set(got["members"]) == set(want["members"]) == {
        f"learner-{os.getpid()}", f"actor-{dead['pid']}"}
    for name, row in got["members"].items():
        assert set(row) == set(want["members"][name]), name
        for key in ("state", "healthy", "role", "port", "health_detail"):
            assert row.get(key) == want["members"][name].get(key), key
    live = got["members"][f"learner-{os.getpid()}"]
    assert live["health_detail"] == {"status": "unhealthy",
                                     "fleet_test": {"why": "x"}}
    for key in ("counts", "ingest_degraded", "alerts", "schema_version"):
        assert got[key] == want[key], key


def test_forensics_names_every_member(tmp_path):
    srv = TelemetryServer(registry=Registry())
    ra = fleet.register_endpoint("learner", srv.port,
                                 fleet_dir=str(tmp_path))
    dead = _dead_descriptor(tmp_path)
    agg = fleet.FleetAggregator(str(tmp_path), scrape_timeout_s=0.3)
    try:
        agg.sweep_once()
        bundle = agg.forensics()
        assert set(bundle["members"]) == {f"learner-{os.getpid()}",
                                          f"actor-{dead['pid']}"}
        live = bundle["members"][f"learner-{os.getpid()}"]
        assert live["state"] == "live"
        assert "MainThread" in live["stacks"]
        # The port's /debug/flight serves the ring's snapshot.
        assert set(live["flight"]) == {"capacity", "total", "events"}
        assert bundle["members"][f"actor-{dead['pid']}"] == {
            "state": "dead"}
    finally:
        srv.close()
        ra.close()


def test_fleet_profile_fans_out_with_dead_member(tmp_path, monkeypatch):
    """``/fleet/profile`` fans the capture out to every live member's
    ``/debug/profile``: the live member's torch.profiler trace lands, the
    dead one is named by its state. The port's fan-out allows each
    request ``seconds + QUIET_TIMEOUT_S + scrape_timeout_s`` (a capture
    first waits at the member's launch gate)."""
    from dist_dqn_tpu_torch.telemetry import devtime

    monkeypatch.setenv(devtime.FORENSICS_ENV, str(tmp_path / "traces"))
    srv = TelemetryServer(registry=Registry())
    (tmp_path / "fleet").mkdir()
    ra = fleet.register_endpoint("learner", srv.port,
                                 fleet_dir=str(tmp_path / "fleet"))
    dead = _dead_descriptor(tmp_path / "fleet")
    agg = fleet.FleetAggregator(str(tmp_path / "fleet"),
                                scrape_timeout_s=15.0)
    pane = fleet.FleetServer(agg)
    try:
        agg.sweep_once()
        body = json.loads(_get(
            f"http://127.0.0.1:{pane.port}/fleet/profile?seconds=0",
            timeout=60.0))
        members = body["members"]
        assert set(members) == {f"learner-{os.getpid()}",
                                f"actor-{dead['pid']}"}
        assert members[f"actor-{dead['pid']}"] == {"state": "dead"}
        live = members[f"learner-{os.getpid()}"]
        assert live["state"] == "live" and live["role"] == "learner"
        assert "error" not in live, live
        assert os.path.isdir(live["trace_dir"])
    finally:
        pane.close()
        srv.close()
        ra.close()


def test_fleet_pane_federates_lineage_families(tmp_path):
    reg = Registry()
    age_h, stale_h = tmc.lineage_histograms("host_replay", reg)
    age_h.observe_many([0.2, 1.5])
    stale_h.observe_many([3, 40])
    srv = TelemetryServer(registry=reg)
    handle = fleet.register_endpoint("learner", srv.port,
                                     fleet_dir=str(tmp_path))
    agg = fleet.FleetAggregator(str(tmp_path), scrape_timeout_s=1.0)
    try:
        agg.sweep_once()
        merged = agg.render_metrics()
        assert ('dqn_replay_sample_age_seconds_bucket{'
                'le="0.5",loop="host_replay",'
                f'process="learner-{os.getpid()}",role="learner"}} 1'
                ) in merged
        assert "dqn_replay_sample_staleness_versions_count" in merged
    finally:
        srv.close()
        handle.close()


# ---------------------------------------------------------------------------
# Experience lineage on the port's wire
# ---------------------------------------------------------------------------

_LANES, _H, _W, _FS = 3, 8, 6, 4
_BIRTH = 1722470400.129883  # an exact f64 so bit-survival is checkable
_VER = 0xDEADBEEF


def _arrays(rng, lanes=_LANES):
    nxt = rng.integers(0, 256, (lanes, _H, _W, _FS)).astype(np.uint8)
    return {"obs": nxt.copy(), "reward":
            rng.normal(size=lanes).astype(np.float32),
            "terminated": np.zeros(lanes, np.uint8),
            "truncated": np.zeros(lanes, np.uint8), "next_obs": nxt}


def test_lineage_survives_plain_roundtrip():
    """The port's stamped record is the JAX codec's, byte for byte, and
    decodes to the same stamps in both packages."""
    schema = ingest.step_schema((_H, _W, _FS), np.uint8, _LANES)
    jschema = jingest.step_schema((_H, _W, _FS), np.uint8, _LANES)
    enc, jenc = ingest.StepEncoder(schema), jingest.StepEncoder(jschema)
    arrays = _arrays(np.random.default_rng(0))
    payload = bytes(enc.encode_step(arrays, actor=0, t=1, birth_time=_BIRTH,
                                    params_version=_VER))
    assert payload == bytes(jenc.encode_step(
        arrays, actor=0, t=1, birth_time=_BIRTH, params_version=_VER))
    for dec in (ingest.StepDecoder(schema), jingest.StepDecoder(jschema)):
        _, meta = dec.decode(payload)
        assert meta["birth_time"] == _BIRTH
        assert meta["params_version"] == _VER
    _, meta2 = ingest.StepDecoder(schema).decode(bytes(enc.encode_step(
        _arrays(np.random.default_rng(1)), actor=0, t=2)))
    assert "birth_time" not in meta2


def _stacked_step(rng, prev_nxt):
    frame = rng.integers(0, 256, (_LANES, _H, _W, 1)).astype(np.uint8)
    nxt = np.concatenate([prev_nxt[:, :, :, 1:], frame], axis=3)
    return {"obs": nxt.copy(),
            "reward": rng.normal(size=_LANES).astype(np.float32),
            "terminated": np.zeros(_LANES, np.uint8),
            "truncated": np.zeros(_LANES, np.uint8),
            "next_obs": nxt}, nxt


def test_lineage_survives_dedup_roundtrip_canon_and_general():
    schema = ingest.step_schema((_H, _W, _FS), np.uint8, _LANES)
    jschema = jingest.step_schema((_H, _W, _FS), np.uint8, _LANES)
    enc = ingest.DedupStepEncoder(schema, _FS)
    jenc = jingest.DedupStepEncoder(jschema, _FS)
    dec = ingest.DedupStepDecoder(schema, _FS, t0=0)
    rng = np.random.default_rng(1)
    nxt = rng.integers(0, 256, (_LANES, _H, _W, _FS)).astype(np.uint8)
    kinds = set()
    for t in range(6):
        arrays, nxt = _stacked_step(rng, nxt)
        kw = dict(actor=0, t=t + 1, birth_time=_BIRTH + t,
                  params_version=_VER - t)
        payload = bytes(enc.encode_step(arrays, **kw))
        assert payload == bytes(jenc.encode_step(arrays, **kw))
        hdr = ingest.peek_header(payload)
        kinds.add(bool(hdr["flags"] & ingest.FLAG_DEDUP_CANON))
        out, meta = dec.decode(payload)
        assert meta["birth_time"] == _BIRTH + t
        assert meta["params_version"] == _VER - t
        assert np.array_equal(out["obs"], arrays["obs"])
    assert kinds == {False, True}, "both record kinds exercised"


def test_lineage_survives_batched_shm_roundtrip():
    schema = ingest.step_schema((_H, _W, _FS), np.uint8, _LANES)
    enc = ingest.StepEncoder(schema)
    dec = ingest.StepDecoder(schema)
    rng = np.random.default_rng(2)
    payloads = [bytes(enc.encode_step(_arrays(rng), actor=0, t=t + 1,
                                      birth_time=_BIRTH + t,
                                      params_version=_VER - t))
                for t in range(4)]
    from dist_dqn_tpu_torch.ingest.shm_ring import batch_bytes
    ring = ingest.ShmSlotRing(f"t_tfleet_lineage_{os.getpid()}",
                              slot_size=batch_bytes(
                                  [len(p) for p in payloads]),
                              nslots=2, create=True)
    try:
        assert ring.push_batch(payloads)
        for t in range(4):
            got = ring.pop()
            assert got is not None
            _, meta = dec.decode(got)
            assert meta["birth_time"] == _BIRTH + t
            assert meta["params_version"] == _VER - t
    finally:
        ring.close()
        ring.unlink()


def test_reply_lineage_roundtrip():
    action = np.arange(_LANES, dtype=np.int32)
    payload = ingest.encode_reply(action, actor=1, t=5, params_version=_VER)
    assert payload == jingest.encode_reply(action, actor=1, t=5,
                                           params_version=_VER)
    out, _, _, hdr = ingest.decode_reply(payload)
    assert np.array_equal(out, action)
    assert hdr["params_version"] == _VER
    _, _, _, hdr2 = ingest.decode_reply(ingest.encode_reply(action, actor=1,
                                                            t=6))
    assert "params_version" not in hdr2


def test_lineage_family_parity_fused_vs_host_replay_vs_apex():
    reg = Registry()
    rows = {loop: tmc.lineage_histograms(loop, reg)
            for loop in ("fused", "host_replay", "apex")}
    names = {(a.name, s.name) for a, s in rows.values()}
    assert names == {(tmc.REPLAY_SAMPLE_AGE, tmc.REPLAY_SAMPLE_STALENESS)}
    bounds = {(a.bounds, s.bounds) for a, s in rows.values()}
    assert len(bounds) == 1, "bucket layouts must not drift apart"
    jrows = {loop: jcollectors.lineage_histograms(loop, jregistry.Registry())
             for loop in rows}
    for loop in rows:
        assert [h.bounds for h in rows[loop]] == [
            h.bounds for h in jrows[loop]]
    table = tmc.FusedLineageTable(Registry())
    table.on_chunk(10.0, window_chunks=2, now=100.0)
    table.on_chunk(12.0, window_chunks=2, now=101.0)
    assert table._age.name == tmc.REPLAY_SAMPLE_AGE
    assert table._age.count == 3
    assert table._staleness.count == 3


# ---------------------------------------------------------------------------
# The live demo: the real CLI against real telemetry servers
# ---------------------------------------------------------------------------

def test_fleet_cli_live_demo(tmp_path):
    """Two telemetry servers (one of each package, so the pane federates
    either) + the port's ``python -m`` aggregator CLI: one merged scrape
    with per-process labels, a rollup counting both live, the forensics
    pull naming both, and a clean SIGTERM exit."""
    reg_l, reg_a = Registry(), jregistry.Registry()
    reg_l.counter("dqn_demo_learner_total", "x").inc(1)
    reg_a.counter("dqn_demo_actor_total", "x").inc(2)
    srv_l = TelemetryServer(registry=reg_l)
    srv_a = jserver.TelemetryServer(registry=reg_a)
    rl = fleet.register_endpoint("learner", srv_l.port,
                                 fleet_dir=str(tmp_path))
    ra = jfleet.register_endpoint("actor", srv_a.port,
                                  fleet_dir=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.telemetry.fleet",
         "--fleet-dir", str(tmp_path), "--port", "0",
         "--sweep-interval", "0.2", "--scrape-timeout", "1.0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    pid = os.getpid()
    try:
        port = json.loads(proc.stdout.readline())["fleet_port"]
        deadline = time.time() + 20.0
        status = {}
        while time.time() < deadline:
            status = json.loads(
                _get(f"http://127.0.0.1:{port}/fleet/status"))
            if status.get("counts", {}).get("live") == 2:
                break
            time.sleep(0.1)
        assert status["counts"]["live"] == 2, status
        assert not status["ingest_degraded"]
        merged = _get(f"http://127.0.0.1:{port}/metrics").decode()
        assert (f'dqn_demo_learner_total{{process="learner-{pid}"'
                f',role="learner"}} 1') in merged
        assert (f'dqn_demo_actor_total{{process="actor-{pid}"'
                f',role="actor"}} 2') in merged
        bundle = json.loads(_get(f"http://127.0.0.1:{port}/fleet/forensics"))
        assert set(bundle["members"]) == {f"learner-{pid}", f"actor-{pid}"}
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        srv_l.close()
        srv_a.close()
        rl.close()
        ra.close()
    assert proc.returncode in (0, 128 + signal.SIGTERM)
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=2)
