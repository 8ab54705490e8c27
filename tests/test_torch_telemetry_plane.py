"""The port's telemetry plane (dist_dqn_tpu_torch/telemetry/ and
utils/metrics.py) against the JAX package's: every metric name and bucket
tuple, the collector helpers, ``MetricLogger``'s rows and registry mirror,
the exit-flush lifecycle (twins of tests/test_lifecycle.py), the run
manifest's config hash, and the telemetry server's bodies. Every
comparison is exact: the same explicit inputs give byte-equal text or
equal snapshots in both packages."""
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.telemetry import collectors as jcollectors
from dist_dqn_tpu.telemetry import manifest as jmanifest
from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu.telemetry import server as jserver
from dist_dqn_tpu.telemetry import watchdog as jwatchdog
from dist_dqn_tpu.utils import metrics as jmetrics
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.telemetry import collectors as tcollectors
from dist_dqn_tpu_torch.telemetry import lifecycle
from dist_dqn_tpu_torch.telemetry import manifest as tmanifest
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.telemetry import server as tserver
from dist_dqn_tpu_torch.telemetry import watchdog as twatchdog
from dist_dqn_tpu_torch.utils import metrics as tmetrics


def _snap_text(reg) -> str:
    """A registry's snapshot as sorted JSON text (NaN compares equal)."""
    return json.dumps(reg.snapshot(), sort_keys=True)


# -- collectors ---------------------------------------------------------------

def _constants(mod):
    return {k: getattr(mod, k) for k in dir(mod)
            if k.isupper() and not k.startswith("_")}


def test_every_collector_name_and_bucket_tuple_is_the_jax_one():
    jax_c, port_c = _constants(jcollectors), _constants(tcollectors)
    assert jax_c == port_c
    # Names and the bucket tuples both: the whole set is there.
    assert len(port_c) == 98
    assert all(isinstance(v, (str, tuple)) for v in port_c.values())


def _lineage_ops(collectors, registry_mod):
    reg = registry_mod.Registry()
    table = collectors.FusedLineageTable(reg)
    for i, now in enumerate((100.0, 101.5, 103.0, 110.0)):
        table.on_chunk(grad_steps_total=40.0 * i, window_chunks=3, now=now)
    age, stale = collectors.lineage_histograms("apex", reg)
    items = {"lineage_birth_time": np.array([90.0, 99.5, 120.0]),
             "lineage_params_version": np.array([3, 7, 12])}
    assert collectors.observe_sample_lineage(items, 10, age, stale,
                                             now=100.0)
    assert not collectors.observe_sample_lineage({}, 10, age, stale,
                                                 now=100.0)
    size, cap, occ = collectors.replay_gauges("host", reg)
    size.set(7)
    cap.set(16)
    occ.set(7 / 16)
    quantiles = [collectors.histogram_quantile(h, q)
                 for h in (age, stale) for q in (0.0, 0.5, 0.9, 1.0)]
    empty = reg.histogram("dqn_empty_seconds", "never observed")
    quantiles.append(collectors.histogram_quantile(empty, 0.5))
    return reg, quantiles


def test_lineage_replay_gauge_and_quantile_helpers_equal_jax():
    jreg, jq = _lineage_ops(jcollectors, jregistry)
    treg, tq = _lineage_ops(tcollectors, tregistry)
    assert _snap_text(treg) == _snap_text(jreg)
    assert json.dumps(tq) == json.dumps(jq)     # NaN for the empty one


class _Ring:
    """The slot shape and cursor of a device ring, as both packages'
    ``observe_device_ring`` read them."""

    def __init__(self, slots, lanes, size):
        self.action = np.zeros((slots, lanes), np.int32)
        self.size = size


class _PerState:
    def __init__(self, ring, max_priority):
        self.ring = ring
        self.max_priority = max_priority


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_observe_device_ring_equals_jax(per):
    """The port reads no device scalar: a prioritized ring's max priority
    comes in as the host value the chunk's stacked read fetched."""
    ring = _Ring(64, 8, 40)
    jreg, treg = jregistry.Registry(), tregistry.Registry()
    state = _PerState(ring, np.float32(3.25)) if per else ring
    assert jcollectors.observe_device_ring(state, jreg) == (40, 64)
    assert tcollectors.observe_device_ring(
        state, treg, max_priority=3.25 if per else None) == (40, 64)
    assert _snap_text(treg) == _snap_text(jreg)


# -- MetricLogger ----------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t


def _logger_run(metrics_mod, registry_mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(metrics_mod, "time", clock)
    reg = registry_mod.Registry()
    # A counter already owns dqn_ring_dropped: the mirror of that key
    # stands down instead of crashing the flush.
    reg.counter("dqn_ring_dropped", "a non-gauge family")
    rows = []
    log = metrics_mod.MetricLogger(log_fn=rows.append, num_chips=2,
                                   registry=reg)
    log.record(env_steps=0, grad_steps=0)
    clock.t += 10.0
    log.record(env_steps=4000, grad_steps=123, replay_size=512.0,
               loss=0.123456789, ring_dropped=3.0, note="text")
    log.flush()
    clock.t += 5.0
    log.record(env_steps=6000, grad_steps=200, eval_return=42.5)
    log.flush()
    clock.t += 60.0          # the window went quiet: rates read 0
    log.flush()
    return rows, reg


def test_metric_logger_rows_and_registry_equal_jax(monkeypatch):
    jrows, jreg = _logger_run(jmetrics, jregistry, monkeypatch)
    trows, treg = _logger_run(tmetrics, tregistry, monkeypatch)
    assert trows == jrows
    assert _snap_text(treg) == _snap_text(jreg)
    assert json.loads(trows[0])["env_steps_per_sec_per_chip"] == 200.0
    assert json.loads(trows[-1])["grad_steps_per_sec"] == 0.0


def test_metric_logger_rows_are_the_service_rate_logger_rows(monkeypatch):
    """The service's log rows keep the keys and values the port's
    stand-in logger printed before MetricLogger replaced it: one chip,
    windowed rates rounded to 2 places, extras since the last flush."""
    clock = _Clock()
    monkeypatch.setattr(tmetrics, "time", clock)
    rows = []
    log = tmetrics.MetricLogger(log_fn=rows.append,
                                registry=tregistry.Registry())
    log.record(env_steps=100, grad_steps=4)
    clock.t += 2.0
    log.record(env_steps=700, grad_steps=10, replay_size=600.0, loss=0.5,
               actor_restarts=0.0, ring_dropped=0.0)
    want = {"env_steps_per_sec_per_chip": 300.0, "grad_steps_per_sec": 3.0,
            "replay_size": 600.0, "loss": 0.5, "actor_restarts": 0.0,
            "ring_dropped": 0.0}
    assert log.flush() == want
    assert json.loads(rows[0]) == want
    # The extras went with that row; the rates stay.
    assert log.flush() == {"env_steps_per_sec_per_chip": 300.0,
                           "grad_steps_per_sec": 3.0}


def test_rate_tracker_decay_equals_jax():
    for mod in (jmetrics, tmetrics):
        rt = mod.RateTracker(window_s=30.0)
        rt.update(0, now=0.0)
        rt.update(300, now=10.0)
        assert rt.rate(now=39.0) == pytest.approx(30.0)
        assert rt.rate(now=40.0) == 0.0
        rt.update(330, now=41.0)
        assert rt.rate(now=41.0) > 0.0


# -- lifecycle (twins of tests/test_lifecycle.py) --------------------------

def test_run_callbacks_is_once_only_and_ordered():
    lifecycle._reset_for_tests()
    try:
        calls = []
        lifecycle.on_exit(lambda: calls.append("a"))
        lifecycle.on_exit(lambda: calls.append("b"))
        lifecycle._run_callbacks()
        assert calls == ["a", "b"]
        lifecycle._run_callbacks()
        assert calls == ["a", "b"]
    finally:
        lifecycle._reset_for_tests()


def test_late_registration_after_flush_does_not_retrigger():
    lifecycle._reset_for_tests()
    try:
        calls = []
        lifecycle._run_callbacks()
        lifecycle.on_exit(lambda: calls.append("late"))
        lifecycle._run_callbacks()
        assert calls == []
    finally:
        lifecycle._reset_for_tests()


def test_off_exit_deregisters():
    lifecycle._reset_for_tests()
    try:
        calls = []
        fn = lambda: calls.append("x")  # noqa: E731
        lifecycle.on_exit(fn)
        lifecycle.off_exit(fn)
        lifecycle._run_callbacks()
        assert calls == []
        lifecycle.off_exit(fn)
    finally:
        lifecycle._reset_for_tests()


def _run_child(code: str, sig=None, timeout=30):
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    if sig is None:
        proc.wait(timeout=timeout)
        return proc
    line = proc.stdout.readline()
    assert line.strip() == "ready", f"child never became ready: {line!r}"
    proc.send_signal(sig)
    proc.wait(timeout=timeout)
    return proc


def test_sigterm_flushes_once_then_exits_128_plus_signum(tmp_path):
    out = tmp_path / "flushes.txt"
    code = (
        "from dist_dqn_tpu_torch.telemetry import lifecycle\n"
        "lifecycle.on_exit(lambda: open(%r, 'a').write('flush\\n'))\n"
        "print('ready', flush=True)\n"
        "import time; time.sleep(60)\n" % str(out))
    proc = _run_child(code, sig=signal.SIGTERM)
    assert proc.returncode == 128 + signal.SIGTERM
    assert out.read_text() == "flush\n"


def test_sigterm_chains_preexisting_handler_after_flush(tmp_path):
    out = tmp_path / "order.txt"
    code = (
        "import os, signal, time\n"
        "def prev(signum, frame):\n"
        "    open(%r, 'a').write('prev\\n')\n"
        "    os._exit(7)\n"
        "signal.signal(signal.SIGTERM, prev)\n"
        "from dist_dqn_tpu_torch.telemetry import lifecycle\n"
        "lifecycle.on_exit(lambda: open(%r, 'a').write('flush\\n'))\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n" % (str(out), str(out)))
    proc = _run_child(code, sig=signal.SIGTERM)
    assert proc.returncode == 7
    assert out.read_text() == "flush\nprev\n"


def test_normal_exit_flushes_via_atexit(tmp_path):
    out = tmp_path / "flushes.txt"
    code = (
        "from dist_dqn_tpu_torch.telemetry import lifecycle\n"
        "lifecycle.on_exit(lambda: open(%r, 'a').write('flush\\n'))\n"
        % str(out))
    proc = _run_child(code)
    assert proc.returncode == 0
    assert out.read_text() == "flush\n"


def test_snapshot_from_env_names_each_process(tmp_path):
    """``DQN_TELEMETRY_SNAPSHOT`` with ``{pid}``/``{tag}``: the file of a
    SIGTERM'd torch-free process, as spawned actors write theirs."""
    template = str(tmp_path / "snap_{tag}_{pid}.json")
    code = (
        "import os, sys, time\n"
        "os.environ['DQN_TELEMETRY_SNAPSHOT'] = %r\n"
        "from dist_dqn_tpu_torch import telemetry\n"
        "path = telemetry.maybe_install_snapshot_from_env(tag='actor3')\n"
        "telemetry.get_registry().counter('dqn_exit_total').inc(3)\n"
        "assert 'torch' not in sys.modules\n"
        "print('ready', flush=True)\n"
        "time.sleep(60)\n" % template)
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "ready"
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=30)
    path = tmp_path / f"snap_actor3_{proc.pid}.json"
    assert json.loads(path.read_text())["dqn_exit_total"]["value"] == 3


# -- manifest -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_config_hash_equals_jax_for_every_preset(name):
    assert sorted(tconfig.CONFIGS) == sorted(jconfig.CONFIGS)
    want = jmanifest.config_fingerprint(jconfig.CONFIGS[name])
    got = tmanifest.config_fingerprint(tconfig.CONFIGS[name])
    assert got["config_hash"] == want["config_hash"]
    assert got["config_name"] == want["config_name"] == name
    assert got["config"] == want["config"]


def test_module_version_never_imports():
    code = (
        "import sys\n"
        "from dist_dqn_tpu_torch.telemetry import manifest\n"
        "man = manifest.build_manifest(argv=['x'])\n"
        "assert 'torch' not in sys.modules, 'manifest imported torch'\n"
        "assert man['versions']['torch'] is None\n"
        "assert 'sqlite3' not in sys.modules\n"
        "assert manifest._module_version('sqlite3') is None\n"
        "assert 'sqlite3' not in sys.modules\n"
        "import torch\n"
        "assert manifest.build_manifest()['versions']['torch'] == "
        "torch.__version__\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_annotate_installs_a_manifest(monkeypatch):
    monkeypatch.setattr(tmanifest, "_run_manifest", None)
    tmanifest.annotate_manifest("chaos_plan", {"faults": []})
    man = tmanifest.get_run_manifest()
    assert man["chaos_plan"] == {"faults": []}
    assert set(man) >= {"schema_version", "git_sha", "versions", "argv"}


# -- the server ------------------------------------------------------------

def _fill(reg, collectors):
    reg.counter(collectors.GRAD_STEPS, "learner grad steps taken").inc(40)
    reg.gauge(collectors.REPLAY_SIZE, "replay items currently held",
              {"store": "device"}).set(320)
    h = reg.histogram(collectors.GRAD_LATENCY, "per-grad-step share")
    for v in (0.001, 0.02, 0.3):
        h.observe(v)
    reg.histogram(collectors.DISPATCH_FANIN, "rows",
                  buckets=collectors.FANIN_BUCKETS).observe(12)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.fixture
def twin_telemetry_servers(monkeypatch):
    """Both packages' servers over the same registry contents and the
    same run manifest, with no health probe registered."""
    jwatchdog._reset_for_tests()
    saved = dict(twatchdog._health_probes)
    twatchdog._health_probes.clear()
    man = jmanifest.build_manifest(jconfig.CONFIGS["apex"], argv=["x"])
    monkeypatch.setattr(jmanifest, "_run_manifest", dict(man))
    monkeypatch.setattr(tmanifest, "_run_manifest", dict(man))
    jreg, treg = jregistry.Registry(), tregistry.Registry()
    _fill(jreg, jcollectors)
    _fill(treg, tcollectors)
    js = jserver.start_server(0, registry=jreg)
    ts = tserver.start_server(0, registry=treg)
    yield (f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ts.port}",
           man)
    js.close()
    ts.close()
    jwatchdog._reset_for_tests()
    twatchdog._health_probes.update(saved)


@pytest.mark.parametrize("path", ["/metrics", "/", "/metrics.json",
                                  "/healthz", "/debug/config"])
def test_server_bodies_are_byte_equal_to_jax(twin_telemetry_servers, path):
    jurl, turl, man = twin_telemetry_servers
    want, got = _get(jurl + path), _get(turl + path)
    assert got == want
    assert got[0] == 200
    if path == "/debug/config":
        assert json.loads(got[2])["config_hash"] == man["config_hash"]


@pytest.mark.parametrize("path,item", [("/debug/flight", "A10c"),
                                       ("/debug/profile?seconds=1", "A10b")])
def test_unported_debug_endpoints_answer_501(twin_telemetry_servers, path,
                                             item, tmp_path, monkeypatch):
    """Both debug endpoints the port once answered 501 are ported.
    ``/debug/flight`` (A10c) serves JAX's body for the same recorded
    events: the ring's capacity and total and its events in order, equal
    less each event's ``t`` and ``thread``. ``/debug/profile`` (A10b)
    captures: JSON with the JAX endpoint's keys, its ``trace_dir`` in the
    forensics dir holding a loadable trace, and 409 while another capture
    runs."""
    from dist_dqn_tpu.telemetry import flight as jflight
    from dist_dqn_tpu_torch.telemetry import devtime
    from dist_dqn_tpu_torch.telemetry import flight as tflight

    _, turl, _ = twin_telemetry_servers
    if item == "A10b":
        monkeypatch.setenv(devtime.FORENSICS_ENV, str(tmp_path))
        status, ctype, body = _get(turl + path)
        assert status == 200 and ctype == "application/json", body
        out = json.loads(body)
        assert set(out) == {"trace_dir", "seconds", "capture_wall_s",
                            "files"}
        assert out["seconds"] == 1.0 and out["capture_wall_s"] >= 1.0
        assert os.path.dirname(out["trace_dir"]) == str(tmp_path)
        with open(os.path.join(out["trace_dir"], "trace.json")) as f:
            assert "traceEvents" in json.load(f)
        with devtime._profile_lock:
            status, _, body = _get(turl + "/debug/profile?seconds=0")
        assert status == 409 and json.loads(body)["error"] == "busy"
        return
    jurl, turl, _ = twin_telemetry_servers
    bodies = []
    try:
        for mod, url in ((jflight, jurl), (tflight, turl)):
            fr = mod.configure(enabled=True, capacity=4)
            for i in range(6):
                fr.record("queue", f"evac.host_replay.{i}", slices=i)
            fr.record("chunk", "fused.chunk", frames=640, loss=0.25)
            status, ctype, body = _get(url + path)
            assert status == 200 and ctype == "application/json", body
            out = json.loads(body)
            for e in out["events"]:
                assert e.pop("thread") and e.pop("t") > 0
            bodies.append(out)
    finally:
        jflight._reset_for_tests()
        tflight._reset_for_tests()
    assert bodies[0] == bodies[1]
    assert bodies[1]["capacity"] == 4 and bodies[1]["total"] == 7
    assert [e["name"] for e in bodies[1]["events"]] == [
        "evac.host_replay.3", "evac.host_replay.4", "evac.host_replay.5",
        "fused.chunk"]


def test_stacks_name_the_threads_and_unknown_paths_404(
        twin_telemetry_servers):
    _, turl, _ = twin_telemetry_servers
    status, ctype, body = _get(turl + "/debug/stacks")
    assert status == 200 and ctype == "text/plain"
    assert "--- thread 'telemetry-http'" in body.decode()
    assert "--- thread 'MainThread'" in body.decode()
    assert _get(turl + "/nope")[0] == 404


def test_healthz_flips_with_a_probe_like_jax(twin_telemetry_servers):
    jurl, turl, _ = twin_telemetry_servers
    probe = lambda: {"p99_latency_s": 0.5}  # noqa: E731
    jwatchdog.register_health_probe("slo", probe)
    twatchdog.register_health_probe("slo", probe)
    try:
        want, got = _get(jurl + "/healthz"), _get(turl + "/healthz")
        assert got == want and got[0] == 503
    finally:
        jwatchdog.unregister_health_probe("slo")
        twatchdog.unregister_health_probe("slo")


def test_server_close_releases_the_port():
    srv = tserver.start_server(0, registry=tregistry.Registry())
    port = srv.port
    assert _get(f"http://127.0.0.1:{port}/healthz")[0] == 200
    srv.close()
    time.sleep(0.05)
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=5)
