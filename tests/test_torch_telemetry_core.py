"""The port's telemetry core (dist_dqn_tpu_torch/telemetry/) against the
JAX package's: the same counter, gauge and histogram operations render
byte-equal Prometheus text and equal JSON snapshots in both packages,
``/healthz`` bodies are byte-equal with the same health probe registered
in each, the serving metric names are the JAX names, and the heartbeat
is the no-op twin until a watchdog can be installed."""
import json
import math

import pytest

from dist_dqn_tpu.telemetry import collectors as jcollectors
from dist_dqn_tpu.telemetry import exposition as jexposition
from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu.telemetry import server as jserver
from dist_dqn_tpu.telemetry import watchdog as jwatchdog
from dist_dqn_tpu_torch import telemetry
from dist_dqn_tpu_torch.telemetry import collectors as tcollectors
from dist_dqn_tpu_torch.telemetry import exposition as texposition
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from dist_dqn_tpu_torch.telemetry import server as tserver
from dist_dqn_tpu_torch.telemetry import watchdog as twatchdog

SERVING_NAMES = ("SERVING_REQUESTS", "SERVING_SHED", "SERVING_QUEUE_DEPTH",
                 "SERVING_LATENCY", "SERVING_BATCH_FANIN",
                 "SERVING_DISPATCHES", "SERVING_RELOADS",
                 "SERVING_POLICY_VERSION", "SERVING_SLO_BREACHES")


def _serving_ops(reg, collectors):
    """The serving tier's instruments, driven the way a short serving run
    drives them (two tenants, shed requests, a reload, a breach)."""
    reg.counter(collectors.SERVING_REQUESTS, "act requests served",
                {"policy": "default"}).inc(3)
    reg.counter(collectors.SERVING_REQUESTS, "act requests served",
                {"policy": "shadow"}).inc()
    reg.counter(collectors.SERVING_SHED, "requests shed").inc(2)
    depth = reg.gauge(collectors.SERVING_QUEUE_DEPTH, "queued")
    depth.set(7)
    depth.dec(2)
    lat = reg.histogram(collectors.SERVING_LATENCY, "admission -> split")
    for v in (0.00005, 0.0021, 0.0021, 0.3, 75.0):
        lat.observe(v)
    lat.observe_many([0.001, 0.02, 1e-7])
    fan = reg.histogram(collectors.SERVING_BATCH_FANIN, "rows",
                        buckets=collectors.FANIN_BUCKETS)
    for v in (1, 3, 8, 256, 9000):
        fan.observe(v)
    reg.counter(collectors.SERVING_DISPATCHES, "dispatched").inc(4)
    reg.counter(collectors.SERVING_RELOADS, "swaps",
                {"policy": "default"}).inc()
    reg.gauge(collectors.SERVING_POLICY_VERSION, "version",
              {"policy": "default"}).set(2)
    reg.counter(collectors.SERVING_SLO_BREACHES, "flips",
                {"slo": "p99_latency"}).inc()


def _edge_ops(reg, collectors):
    """Formatting edges: float and huge values, +/-Inf and NaN gauges,
    label escaping, help escaping, an empty help, no observations."""
    reg.gauge("g_float", "a float").set(0.1 + 0.2)
    reg.gauge("g_huge", "big").set(3e15)
    reg.gauge("g_inf", "").set(float("inf"))
    reg.gauge("g_ninf", "neg").set(-float("inf"))
    reg.gauge("g_nan", "nan").set(float("nan"))
    reg.counter("c_labels_total", 'quote " and \\ back\nslash',
                {"path": 'a"b\\c\nd', "z": "1", "a": "2"}).inc(1.5)
    reg.histogram("h_empty_seconds", "never observed")


@pytest.mark.parametrize("ops", [_serving_ops, _edge_ops],
                         ids=["serving", "edges"])
def test_exposition_text_and_snapshot_equal_jax(ops, tmp_path):
    jreg, treg = jregistry.Registry(), tregistry.Registry()
    ops(jreg, jcollectors)
    ops(treg, tcollectors)
    jtext = jexposition.render_prometheus(jreg).encode()
    ttext = texposition.render_prometheus(treg).encode()
    assert ttext == jtext
    jsnap, tsnap = jexposition.snapshot(jreg), texposition.snapshot(treg)
    # NaN != NaN: compare the JSON text, where both are "NaN".
    assert json.dumps(tsnap, sort_keys=True) == json.dumps(jsnap,
                                                           sort_keys=True)
    jexposition.write_snapshot(str(tmp_path / "j.json"), jreg)
    texposition.write_snapshot(str(tmp_path / "t.json"), treg)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert texposition.CONTENT_TYPE == jexposition.CONTENT_TYPE


def test_serving_metric_names_are_the_jax_names():
    for name in SERVING_NAMES:
        assert getattr(tcollectors, name) == getattr(jcollectors, name)
    assert tcollectors.FANIN_BUCKETS == jcollectors.FANIN_BUCKETS
    assert tregistry.DEFAULT_BUCKETS == jregistry.DEFAULT_BUCKETS


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_registry_refusals_and_null_twin(pkg):
    reg_mod = jregistry if pkg == "jax" else tregistry
    reg = reg_mod.Registry()
    c = reg.counter("x_total", "x", {"a": "1"})
    assert reg.counter("x_total", "other help", {"a": "1"}) is c
    with pytest.raises(ValueError, match="cannot decrease"):
        c.inc(-1)
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x_total", "x", {"a": "1"})
    with pytest.raises(ValueError, match="strictly ascending"):
        reg.histogram("h_seconds", "h", buckets=(1.0, 1.0))
    null = reg_mod.NullRegistry()
    inst = null.histogram("h_seconds")
    inst.observe(1.0)
    inst.inc()
    inst.set(3)
    assert null.snapshot() == {} and null.collect() == {}
    assert inst.cumulative_buckets() == [(math.inf, 0)]


@pytest.fixture
def fresh_health():
    """No JAX watchdog installed, an unarmed JAX sentinel and no probes in
    either package, before and after."""
    jwatchdog._reset_for_tests()
    saved = dict(twatchdog._health_probes)
    twatchdog._health_probes.clear()
    yield
    jwatchdog._reset_for_tests()
    twatchdog._health_probes.clear()
    twatchdog._health_probes.update(saved)


def _breach():
    return {"p99_latency_s": 0.012345, "slo_p99_latency_s": 0.01}


def _broken():
    raise RuntimeError("probe blew up")


@pytest.mark.parametrize("probes", [
    {}, {"serving_slo.1": lambda: None}, {"serving_slo.1": _breach},
    {"serving_slo.1": _breach, "b_probe": _broken,
     "c_ok": lambda: None}],
    ids=["none", "healthy", "breached", "breached_and_broken"])
def test_healthz_body_equals_jax(fresh_health, probes):
    for name, probe in probes.items():
        jwatchdog.register_health_probe(name, probe)
        telemetry.register_health_probe(name, probe)
    assert tserver.healthz_body() == jserver.healthz_body()
    assert telemetry.health_state() == jwatchdog.health_state()
    for name in probes:
        jwatchdog.unregister_health_probe(name)
        telemetry.unregister_health_probe(name)
    assert tserver.healthz_body() == (200, b"ok\n") == jserver.healthz_body()


def test_heartbeat_is_the_null_twin_without_a_watchdog():
    hb = telemetry.heartbeat("serving.batcher")
    assert hb is twatchdog.NULL_HEARTBEAT
    assert jwatchdog.heartbeat("serving.batcher") is jwatchdog.NULL_HEARTBEAT
    hb.beat()
    hb.close()
    assert not hb.expired and hb.age() == 0.0
    # A live heartbeat keeps the JAX semantics: the startup grace holds
    # until the first beat.
    for mod in (jwatchdog, twatchdog):
        beat = mod.Heartbeat("stage", deadline_s=5.0, startup_grace_s=10.0)
        assert beat.limit() == 15.0 and not beat.expired
        beat.beat()
        assert beat.limit() == 5.0
