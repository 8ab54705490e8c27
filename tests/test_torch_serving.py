"""The port's serving tier (dist_dqn_tpu_torch/serving/) on the CPU, twin
of tests/test_serving.py, over real HTTP on ephemeral ports.

Covers: the serving equivalence pin (greedy served actions bit-identical
to ``make_actor_step`` on the restored net at epsilon 0, on the same
padded bucket, across fan-ins 1, 3 and a full bucket), routing and
validation, atomic hot-reload under load (one version per dispatch,
versions never going back, every dispatch's actions those of its
version's net) and the isolation of a resident snapshot from a later
reload, queue-full shedding with Retry-After, the SLO probes on
/healthz, the CLI with its graceful SIGTERM drain and its refused flags,
the model store's start/registration race, and against the JAX package:
greedy actions from the same weights and the wire in both directions.
C8: a host-replay (host_loop-kind) checkpoint directory evaluates and
serves.

The checkpoint twins of tests/test_serving.py (the LATEST pointer, the
presence probe, save failures, evaluate --wait-for-checkpoint) live in
tests/test_torch_checkpoint.py and tests/test_torch_evaluate.py.
"""
from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.actors.act_dispatch import pack_act_rows
from dist_dqn_tpu_torch.actors.transport import decode_arrays, encode_arrays
from dist_dqn_tpu_torch.agents.dqn import make_actor_step, make_learner
from dist_dqn_tpu_torch.models import build_network
from dist_dqn_tpu_torch.serving import (QueueFullError, ServingClient,
                                        ServingError, UnknownPolicyError,
                                        build_server)
from dist_dqn_tpu_torch.serving.model_store import ModelStore
from dist_dqn_tpu_torch.telemetry import watchdog as tm_watchdog
from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

CFG = tconfig.CONFIGS["cartpole"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = lambda *_: None  # noqa: E731
ACT = make_actor_step(2)

#: Each test's wall-clock limit in seconds (default 60), enforced by
#: ``_time_limit``; module fixtures are set up outside it.
TIME_LIMIT_S = {
    "test_hot_reload_atomic_under_load": 90,
    "test_cli_end_to_end": 120,
    "test_cli_sigterm_during_checkpoint_wait_exits_zero": 120,
    "test_greedy_actions_equal_the_jax_server": 120,
    "test_wire_is_the_jax_wire": 120,
    "test_host_replay_checkpoint_evaluates_and_serves": 120,
    "test_cli_refuses_unported_flags_with_the_reason": 120,
    "test_cli_telemetry_flags_serve_and_snapshot": 120,
}


@pytest.fixture(autouse=True)
def _time_limit(request):
    """Fail a test that runs past its limit instead of hanging the run."""
    limit = TIME_LIMIT_S.get(request.node.originalname, 60)

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its {limit} s "
                           "limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _obs(rows: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((rows, 4)).astype(np.float32)


def _net(seed: int):
    return build_network(CFG.network, 2, (4,), device="cpu", seed=seed)


def _save(directory: str, step: int, net) -> None:
    """A learner-kind checkpoint of ``net`` at ``step``."""
    TrainCheckpointer(directory).save(step, make_learner(CFG.learner,
                                                         net)[0](net))


def greedy_on_bucket(net, obs: np.ndarray, bucket: int) -> np.ndarray:
    """The act step at epsilon 0 on ``obs`` zero-padded to ``bucket``
    rows, as the batcher packs it; the first ``len(obs)`` actions."""
    padded, eps, _, total = pack_act_rows([obs], [0.0])
    padded = np.concatenate(
        [padded, np.zeros((bucket - padded.shape[0],) + obs.shape[1:],
                          obs.dtype)])
    acts = ACT(net, torch.from_numpy(padded), torch.Generator(),
               torch.zeros(bucket))
    return acts.numpy().astype(np.int32)[:total]


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Two nets of other seeds and a step-100 checkpoint of the first."""
    net1, net2 = _net(0), _net(7)
    directory = str(tmp_path_factory.mktemp("serving_ckpt"))
    _save(directory, 100, net1)
    return SimpleNamespace(net1=net1, net2=net2, dir=directory)


@pytest.fixture(scope="module")
def server(stack):
    srv = build_server(CFG, {"default": stack.dir}, device="cpu",
                       max_rows=8, max_wait_ms=25.0, queue_limit=64,
                       poll_interval_s=3600.0, log_fn=QUIET)
    yield srv
    srv.close()


def test_equivalence_pin(stack, server):
    """Greedy serving == make_actor_step on the restored net at epsilon
    0, bit for bit, on the same padded bucket, across fan-ins 1, 3 and a
    full bucket."""
    from dist_dqn_tpu_torch.evaluate import _restore_latest

    frames, net = _restore_latest(stack.dir, _net(3))
    assert frames == 100
    obs = _obs(8)
    cl = ServingClient(server.address)
    try:
        # Fan-in 1, partial bucket (5 rows -> bucket 8, 3 pad rows).
        r = cl.act(obs[:5], greedy=True)
        assert r.version == 1 and r.step == 100 and r.fanin_rows == 5
        np.testing.assert_array_equal(r.actions,
                                      greedy_on_bucket(net, obs[:5], 8))
        # Full bucket: 8 rows == max_rows, zero padding.
        r = cl.act(obs, greedy=True)
        assert r.fanin_rows == 8
        np.testing.assert_array_equal(r.actions,
                                      greedy_on_bucket(net, obs, 8))
    finally:
        cl.close()

    # Fan-in 3: three concurrent 1-row requests coalesce into ONE
    # dispatch (25ms max-wait window) of bucket 4, in arrival order.
    clients = [ServingClient(server.address) for _ in range(3)]
    barrier = threading.Barrier(3)
    results = [None] * 3

    def one(i):
        barrier.wait()
        results[i] = clients[i].act(obs[i:i + 1], greedy=True)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for c in clients:
        c.close()
    assert all(r is not None for r in results)
    assert max(r.fanin_requests for r in results) == 3
    assert all(r.version == 1 for r in results)
    served = [int(r.actions[0]) for r in results]
    # Some arrival order's padded bucket gives every served row.
    refs = []
    for order in itertools.permutations(range(3)):
        acts = greedy_on_bucket(net, obs[list(order)], 4)
        refs.append([int(acts[order.index(i)]) for i in range(3)])
    assert served in refs


def test_routing_and_validation(server):
    cl = ServingClient(server.address)
    try:
        with pytest.raises(UnknownPolicyError):
            cl.act(_obs(1), policy="nope", greedy=True)
        with pytest.raises(ServingError, match="HTTP 400"):
            cl.act(_obs(1), epsilon=2.0)
        with pytest.raises(ServingError, match="HTTP 400"):
            cl.act(np.zeros((1, 5), np.float32), greedy=True)
        with pytest.raises(ServingError, match="HTTP 400"):
            cl.act(_obs(9), greedy=True)        # rows > max_batch_rows
        with pytest.raises(ServingError, match="HTTP 400"):
            cl.act(_obs(1).astype(np.float64), greedy=True)
        pols = cl.policies()
        assert pols["default"]["step"] == 100
        assert isinstance(pols["default"]["param_checksum"], float)
        status, body = cl.healthz()
        assert status == 200 and body == b"ok\n"
        # Epsilon 1 explores every row; the tenant default is greedy.
        r = cl.act(_obs(8, seed=2), epsilon=1.0)
        assert r.actions.shape == (8,) and set(r.actions) <= {0, 1}
    finally:
        cl.close()


def _spy_dispatches(srv):
    """Record every dispatch: (version, padded obs, served actions)."""
    batcher = srv.batcher
    real = batcher._dispatch_inner
    log = []

    def spy(batch):
        real(batch)
        if all(p.result is not None for p in batch):
            obs_cat, _, _, total = pack_act_rows(
                [p.obs for p in batch], [p.epsilon for p in batch])
            log.append(({p.result.version for p in batch}, obs_cat, total,
                        np.concatenate([p.result.actions for p in batch])))

    batcher._dispatch_inner = spy
    return log


def test_hot_reload_atomic_under_load(stack, tmp_path):
    """A reload under concurrent load: every dispatch acts on ONE version,
    its actions are bit-equal to that version's net on the same padded
    bucket, every response's (version, step) header agrees, and no
    client ever sees a version go back."""
    directory = str(tmp_path / "reload_ckpt")
    _save(directory, 100, stack.net1)
    # Rows where the two nets disagree, so a cross-version action cannot
    # masquerade as the right one.
    pool = _obs(64, seed=5)
    differ = np.nonzero(greedy_on_bucket(stack.net1, pool, 64)
                        != greedy_on_bucket(stack.net2, pool, 64))[0]
    assert len(differ) >= 3
    obs = pool[differ[:3]]

    srv = build_server(CFG, {"default": directory}, device="cpu",
                       max_rows=8, max_wait_ms=2.0, queue_limit=64,
                       poll_interval_s=0.1, log_fn=QUIET)
    dispatches = _spy_dispatches(srv)
    seen, errors = {}, []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer(i):
        cl = ServingClient(srv.address)
        try:
            while not stop.is_set():
                r = cl.act(obs, greedy=True)
                with lock:
                    seen.setdefault(i, []).append((r.version, r.step))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            cl.close()

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.4)                # v1 traffic
        _save(directory, 200, stack.net2)
        deadline = time.time() + 10.0
        while time.time() < deadline:
            with lock:
                if any(v == 2 for rows in seen.values() for v, _ in rows):
                    break
            time.sleep(0.05)
        time.sleep(0.2)                # v2 traffic
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        srv.close()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    for rows in seen.values():
        versions = [v for v, _ in rows]
        assert versions == sorted(versions), "a version went back"
        assert all(step == {1: 100, 2: 200}[v] for v, step in rows)
    assert {v for rows in seen.values() for v, _ in rows} == {1, 2}
    nets = {1: stack.net1, 2: stack.net2}
    for versions, obs_cat, total, actions in dispatches:
        assert len(versions) == 1, f"mixed-version dispatch {versions}"
        (version,) = versions
        want = ACT(nets[version], torch.from_numpy(obs_cat),
                   torch.Generator(), torch.zeros(obs_cat.shape[0]))
        np.testing.assert_array_equal(actions,
                                      want.numpy().astype(np.int32)[:total])


def test_hot_reload_never_writes_a_resident_snapshot(stack, tmp_path):
    """``restore_params`` loads in place: a reload must go into a module
    of its own, never into the template or the snapshot being served."""
    directory = str(tmp_path / "isolation")
    _save(directory, 100, stack.net1)
    template = _net(11)
    before_template = {k: v.clone() for k, v in
                       template.state_dict().items()}
    store = ModelStore(template, poll_interval_s=3600.0, log_fn=QUIET)
    try:
        snap1 = store.add_policy("default", directory)
        held = {k: v.clone() for k, v in snap1.params.state_dict().items()}
        _save(directory, 200, stack.net2)
        assert store.poll_once() == ["default"]
        snap2 = store.snapshot("default")
        assert (snap2.version, snap2.step) == (2, 200)
        assert snap2.params is not snap1.params is not template
        for k, v in snap1.params.state_dict().items():
            assert torch.equal(v, held[k]), k
            assert torch.equal(v, stack.net1.state_dict()[k]), k
        for k, v in snap2.params.state_dict().items():
            assert torch.equal(v, stack.net2.state_dict()[k]), k
        for k, v in template.state_dict().items():
            assert torch.equal(v, before_template[k]), k
        assert store.poll_once() == []        # nothing newer
    finally:
        store.close()


def test_queue_full_shedding(stack):
    """Past queue_limit queued requests, admission sheds with 429 +
    Retry-After instead of queueing unboundedly; no request fails."""
    srv = build_server(CFG, {"default": stack.dir}, device="cpu",
                       max_rows=16, max_wait_ms=400.0, queue_limit=2,
                       poll_interval_s=3600.0, log_fn=QUIET)
    statuses, retry_afters, oks = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(10)
    body = encode_arrays({"obs": _obs(1)}, meta={"greedy": True})

    def one():
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        try:
            barrier.wait()
            conn.request("POST", "/v1/act", body=body)
            resp = conn.getresponse()
            payload = resp.read()
            with lock:
                statuses.append(resp.status)
                if resp.status == 429:
                    retry_afters.append((resp.getheader("Retry-After"),
                                         json.loads(payload)))
                elif resp.status == 200:
                    oks.append(decode_arrays(payload)[1])
        finally:
            conn.close()

    threads = [threading.Thread(target=one) for _ in range(10)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        srv.close()
    assert len(statuses) == 10 and set(statuses) <= {200, 429}, statuses
    assert len(oks) >= 2, "admitted requests must still be answered"
    assert retry_afters, "overload must shed, not queue unboundedly"
    for header, payload in retry_afters:
        assert int(header) >= 1 and payload["retry_after_s"] > 0
    # The typed client surfaces the same shed as QueueFullError.
    assert issubclass(QueueFullError, ServingError)


def test_slo_breach_flips_healthz(stack):
    """An impossible p99 SLO breaches after min_samples requests and
    flips /healthz to 503 on the serving surface and in health_state;
    closing the server unregisters the probe."""
    srv = build_server(CFG, {"default": stack.dir}, device="cpu",
                       max_rows=4, max_wait_ms=1.0, queue_limit=64,
                       slo_p99_ms=0.0001,  # 100ns: unmeetable
                       poll_interval_s=3600.0, log_fn=QUIET)
    cl = ServingClient(srv.address)
    try:
        for _ in range(25):  # past the tracker's min_samples window
            cl.act(_obs(1), greedy=True)
        status, body = cl.healthz()
        assert status == 503
        detail = json.loads(body.decode())
        assert detail["status"] == "unhealthy"
        slo_keys = [k for k in detail if k.startswith("serving_slo")]
        assert slo_keys
        assert "p99_latency_s" in detail[slo_keys[0]]
        ok, state = tm_watchdog.health_state()
        assert not ok and any(k.startswith("serving_slo") for k in state)
    finally:
        cl.close()
        srv.close()
    ok, _ = tm_watchdog.health_state()
    assert ok, "closing the server must unregister the SLO probe"


def test_slo_queue_depth_probe_unit():
    """Queue-depth SLO dimension + transition-counted breaches."""
    from dist_dqn_tpu_torch.serving import SloTracker

    tracker = SloTracker(queue_depth=3)
    depth = [0]
    tracker.attach_queue_depth(lambda: depth[0])
    assert tracker.probe() is None
    depth[0] = 5
    detail = tracker.probe()
    assert detail == {"queue_depth": 5, "slo_queue_depth": 3}
    assert tracker.probe() is not None  # still breached; counted once
    depth[0] = 1
    assert tracker.probe() is None


@pytest.mark.parametrize("case", ["latency", "depth", "both", "few"])
def test_slo_probe_equals_jax(case, monkeypatch):
    """The same latencies and queue depths give the same probe dicts."""
    from dist_dqn_tpu.serving import SloTracker as JaxSlo
    from dist_dqn_tpu_torch.serving import SloTracker as TorchSlo

    lat = {"latency": 0.01, "depth": 0.0, "both": 0.002, "few": 0.01}[case]
    qd = {"latency": 0, "depth": 4, "both": 2, "few": 0}[case]
    samples = np.random.default_rng(3).exponential(
        0.004, 10 if case == "few" else 300)
    depths = [0, 3, 9, 1, 5]
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    out = []
    for cls in (JaxSlo, TorchSlo):
        tracker = cls(p99_latency_s=lat, queue_depth=qd)
        it = iter(depths)
        tracker.attach_queue_depth(lambda it=it: next(it))
        probes = []
        for i, s in enumerate(samples):
            tracker.observe(float(s))
            if i % 60 == 59 or i == len(samples) - 1:
                probes.append(tracker.probe())
        out.append((probes, tracker.p99()))
    assert out[0] == out[1]


def test_cli_end_to_end(stack):
    """python -m dist_dqn_tpu_torch.serving serves a run dir on an
    ephemeral port, exposes /healthz and /metrics, and drains cleanly on
    SIGTERM with rc 0."""
    env = {k: v for k, v in os.environ.items() if k != "DQN_CHAOS_PLAN"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.serving",
         "--config", "cartpole", "--checkpoint-dir", stack.dir,
         "--device", "cpu", "--port", "0", "--max-batch-rows", "2",
         "--max-wait-ms", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    port, rows = None, []
    try:
        deadline = time.time() + 90
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            try:
                row = json.loads(line)
            except ValueError:
                continue
            rows.append(row)
            if "serving_port" in row:
                port = row["serving_port"]
                assert row["policies"]["default"]["step"] == 100
                assert row["max_batch_rows"] == 2 and row["batching"]
                break
        assert port, f"CLI never announced serving_port: {rows}"
        assert any(r.get("serving_warmup_buckets") == 2 for r in rows)
        cl = ServingClient(f"127.0.0.1:{port}")
        try:
            r = cl.act(_obs(2), greedy=True)
            assert r.actions.shape == (2,) and r.version == 1
            assert cl.healthz()[0] == 200
            status, text = cl._get("/metrics")
            assert status == 200
            assert b"dqn_serving_requests_total{policy=\"default\"} 1" \
                in text
        finally:
            cl.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    assert proc.returncode == 0, out
    tail = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert tail and tail[-1]["serving_drained"] is True


def test_cli_sigterm_during_checkpoint_wait_exits_zero(tmp_path):
    """A server waiting for its first checkpoint exits 0 on SIGTERM."""
    env = {k: v for k, v in os.environ.items() if k != "DQN_CHAOS_PLAN"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.serving",
         "--config", "cartpole", "--checkpoint-dir", str(tmp_path),
         "--device", "cpu", "--wait-for-checkpoint", "300"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    try:
        line = proc.stdout.readline()      # the first "# waiting" line
        assert "waiting for checkpoint" in line, line
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out
    assert "terminated during checkpoint wait" in out


@pytest.mark.parametrize("argv,env", [
    (["--fleet-dir", "fleet"], None),
    (["--forensics-dir", "forensics"], None),
    (["--watchdog-deadline-s", "60"], None),
    ([], json.dumps({"seed": 3, "events": [
        {"seam": "serving.dispatch", "fault": "exception", "at_hit": 2,
         "args": {}}]})),
], ids=["fleet_dir", "forensics_dir", "watchdog_deadline_s",
        "chaos_plan"])
def test_cli_refuses_unported_flags_with_the_reason(argv, env, tmp_path,
                                                    stack):
    """The flags and the variable the port once refused, now run: the
    chaos plan in ``DQN_CHAOS_PLAN`` arms the CLI (its second dispatch
    fails as injected: the request answers a structured 500 naming the
    seam, and the next one 200, the trip recovered); ``--fleet-dir``
    announces the act server (no telemetry port) as a ``serving`` member
    while the CLI serves, and the descriptor goes at SIGTERM;
    ``--forensics-dir`` arms the watchdog, whose sweeper thread and
    ``serving.batcher`` heartbeat show on the telemetry endpoint's
    ``/debug/stacks`` and the act server's ``/metrics`` while ``/healthz``
    stays 200 and no bundle is written; a ``--watchdog-deadline-s``
    without it arms nothing (JAX's CLI)."""
    argv = [str(tmp_path / a) if a in ("fleet", "forensics") else a
            for a in argv]
    fleet_case = bool(argv) and argv[0] == "--fleet-dir"
    if not fleet_case:
        argv += ["--telemetry-port", "0"]
    penv = {k: v for k, v in os.environ.items()
            if k not in ("DQN_CHAOS_PLAN", "DQN_FLEET_DIR",
                         "DQN_FORENSICS_DIR")}
    if env is not None:
        penv["DQN_CHAOS_PLAN"] = env
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.serving",
         "--config", "cartpole", "--checkpoint-dir", stack.dir,
         "--device", "cpu", "--port", "0", "--max-batch-rows", "2",
         "--max-wait-ms", "1", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=penv)
    try:
        ports = {}
        while "serving_port" not in ports:
            line = proc.stdout.readline()
            assert line, f"CLI ended early: {ports}"
            if line.startswith("{"):
                ports.update(json.loads(line))
        base = f"http://127.0.0.1:{ports['serving_port']}"
        import urllib.request
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
        armed = argv[0] == "--forensics-dir"
        if env is not None:
            from dist_dqn_tpu_torch.serving import ServingClient
            from dist_dqn_tpu_torch.serving.types import ServingError

            client = ServingClient(f"127.0.0.1:{ports['serving_port']}")
            obs = np.zeros((1, 4), np.float32)
            assert client.act(obs).actions.shape == (1,)
            with pytest.raises(ServingError,
                               match=r"HTTP 500: .*ChaosInjectedError.*"
                                     r"serving\.dispatch"):
                client.act(obs)
            assert client.act(obs).actions.shape == (1,)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['telemetry_port']}"
                    "/metrics", timeout=10) as r:
                body = r.read().decode()
            assert ('dqn_chaos_injected_total{fault="exception",'
                    'seam="serving.dispatch"} 1') in body, body
            assert 'dqn_recovery_seconds_count{seam="serving.dispatch"} 1' \
                in body
        if not fleet_case:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{ports['telemetry_port']}"
                    "/debug/stacks", timeout=10) as r:
                stacks = r.read().decode()
            assert ("'telemetry-watchdog'" in stacks) == armed
        if armed:
            def swept():
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=10) as r:
                    return ('dqn_watchdog_heartbeat_age_seconds{stage='
                            '"serving.batcher"}') in r.read().decode()
            deadline = time.monotonic() + 20
            while not swept():
                assert time.monotonic() < deadline, "no watchdog sweep"
                time.sleep(0.2)
        if fleet_case:
            desc = json.loads((tmp_path / "fleet" / f"serving-{proc.pid}"
                               ".json").read_text())
            assert desc["role"] == "serving"
            assert desc["port"] == ports["serving_port"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, out
    assert "serving_drained" in out
    if fleet_case:
        assert os.listdir(tmp_path / "fleet") == []
    if argv[0] == "--forensics-dir":
        assert not (tmp_path / "forensics").exists() or not os.listdir(
            tmp_path / "forensics")
    if env is not None:
        # The CLI's injector logs each injection on its stdout.
        assert ('{"chaos_injected": {"seam": "serving.dispatch", '
                '"fault": "exception", "hit": 2') in out


@pytest.mark.parametrize("argv", [
    ["--telemetry-port", "0"],
    ["--telemetry-port", "0", "--telemetry-host", "0.0.0.0"],
    ["--telemetry-port", "0", "--telemetry-snapshot", "SNAPSHOT"],
], ids=["telemetry_port", "telemetry_host", "telemetry_snapshot"])
def test_cli_telemetry_flags_serve_and_snapshot(argv, stack, tmp_path):
    """The telemetry flags the port once refused: ``--telemetry-port``
    serves the registry on an endpoint of its own (the serving families
    included), ``--telemetry-host`` binds it on every interface, and
    ``--telemetry-snapshot`` writes the registry at SIGTERM, with the
    keys the live endpoint served, though the CLI's own SIGTERM handler
    was installed after the dump's."""
    snap = tmp_path / "snap.json"
    argv = [str(snap) if a == "SNAPSHOT" else a for a in argv]
    env = {k: v for k, v in os.environ.items() if k != "DQN_CHAOS_PLAN"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.serving",
         "--config", "cartpole", "--checkpoint-dir", stack.dir,
         "--device", "cpu", "--port", "0", "--max-batch-rows", "2",
         "--max-wait-ms", "1", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)
    try:
        ports = {}
        while "serving_port" not in ports:
            line = proc.stdout.readline()
            assert line, f"CLI ended early: {ports}"
            if line.startswith("{"):
                ports.update(json.loads(line))
        cl = ServingClient(f"127.0.0.1:{ports['serving_port']}")
        try:
            cl.act(_obs(2), greedy=True)
        finally:
            cl.close()
        base = f"127.0.0.1:{ports['telemetry_port']}"
        conn = http.client.HTTPConnection(base, timeout=10)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.request("GET", "/metrics.json")
        live = json.loads(conn.getresponse().read())
        conn.close()
        assert 'dqn_serving_requests_total{policy="default"} 1' in text
        assert live['dqn_serving_requests_total{policy=default}'][
            "value"] == 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    assert proc.returncode == 0, out
    if "--telemetry-snapshot" in argv:
        dumped = json.loads(snap.read_text())
        assert set(dumped) == set(live)
        assert dumped["dqn_serving_requests_total{policy=default}"][
            "value"] == 1


def test_serving_needs_a_card_unless_cpu_is_asked(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_server(CFG, {"default": stack.dir}, log_fn=QUIET)


def test_recurrent_configs_are_refused(stack):
    with pytest.raises(ValueError, match="feed-forward only"):
        build_server(tconfig.CONFIGS["r2d2"], {"default": stack.dir},
                     device="cpu", log_fn=QUIET)


def test_host_env_probe_swaps_in_the_mlp_torso(tmp_path):
    """``host_env`` takes the net's shape from a host env: a non-pixel
    one swaps the config's torso for the MLP, as the train CLI does."""
    cfg = tconfig.CONFIGS["apex"]
    mlp = dataclasses.replace(cfg.network, torso="mlp",
                              compute_dtype="float32")
    net = build_network(mlp, 2, (4,), device="cpu", seed=0)
    d = str(tmp_path / "apex_cartpole")
    TrainCheckpointer(d).save(10, make_learner(cfg.learner, net)[0](net))
    srv = build_server(cfg, {"default": d}, host_env="CartPole-v1",
                       device="cpu", max_rows=4, log_fn=QUIET)
    cl = ServingClient(srv.address)
    try:
        r = cl.act(_obs(3), greedy=True)
        np.testing.assert_array_equal(r.actions,
                                      greedy_on_bucket(net, _obs(3), 4))
    finally:
        cl.close()
        srv.close()


def test_model_store_start_vs_registration_race():
    """ModelStore.start() walks a copy of the entries taken under the
    store lock while add_policy mutates them from another thread (the
    twin of the JAX regression test: iterating the live dict raised
    "dictionary changed size during iteration")."""

    class _Gauge:
        def set(self, v):
            pass

    class _Reg:
        def gauge(self, *a, **k):
            return _Gauge()

        counter = gauge

    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _trial in range(30):
            store = ModelStore(example_params=None,
                               poll_interval_s=60.0, log_fn=None)
            store._reg = _Reg()
            store._tm_version.clear()
            for i in range(3000):
                store._entries[str(i)] = SimpleNamespace(
                    policy_id=str(i),
                    snapshot=SimpleNamespace(version=1))
            stop = threading.Event()

            def register_late(store=store, stop=stop):
                i = 3000
                while not stop.is_set():
                    with store._lock:   # what add_policy does
                        store._entries[str(i)] = SimpleNamespace(
                            policy_id=str(i), snapshot=None)
                    i += 1

            t = threading.Thread(target=register_late,
                                 name="late-registrar", daemon=True)
            t.start()
            try:
                store.start()
            finally:
                stop.set()
                t.join(timeout=10)
                store.close()
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old_interval)


# --------------------------------------------------------------------------
# Against the JAX package.
# --------------------------------------------------------------------------

#: Q-values of the two packages agree within this, relative to
#: max(1, |Q|); a row whose JAX top-2 gap is within twice that is not
#: compared (either action is right to that precision).
Q_RTOL = 1e-5
CROSS_ROWS = 64


@pytest.fixture(scope="module")
def twin_servers(tmp_path_factory):
    """The JAX server on a JAX checkpoint and the port's server on the
    same flax params converted with ``from_flax``."""
    from dist_dqn_tpu.agents.dqn import make_learner as jax_learner
    from dist_dqn_tpu.envs import make_jax_env
    from dist_dqn_tpu.models import build_network as jax_build
    from dist_dqn_tpu.serving import build_server as jax_build_server
    from dist_dqn_tpu.utils.checkpoint import \
        TrainCheckpointer as JaxCheckpointer
    from dist_dqn_tpu_torch.utils.params import from_flax
    from torch_parity import to_numpy_tree

    jcfg = jconfig.CONFIGS["cartpole"]
    env = make_jax_env(jcfg.env_name)
    jnet = jax_build(jcfg.network, env.num_actions)
    init, _ = jax_learner(jnet, jcfg.learner)
    state = init(jax.random.PRNGKey(0),
                 jnp.zeros(env.observation_shape, env.observation_dtype))
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt = JaxCheckpointer(jdir, save_every_frames=1)
    jckpt.save(100, state)
    jckpt.wait()
    jckpt.close()
    net = _net(5)
    net.load_state_dict(from_flax(to_numpy_tree(state.params), net))
    tdir = str(tmp_path_factory.mktemp("torch_ckpt"))
    _save(tdir, 100, net)
    kw = dict(max_rows=CROSS_ROWS, max_wait_ms=1.0, queue_limit=64,
              poll_interval_s=3600.0, log_fn=QUIET)
    # The JAX server compiles each bucket at its first request instead
    # of the whole ladder up front: this test uses two of them.
    jsrv = jax_build_server(jcfg, {"default": jdir}, compile_warmup=False,
                            **kw)
    tsrv = build_server(CFG, {"default": tdir}, device="cpu", **kw)
    yield SimpleNamespace(jnet=jnet, params=state.params, net=net,
                          jsrv=jsrv, tsrv=tsrv)
    jsrv.close()
    tsrv.close()


def test_greedy_actions_equal_the_jax_server(twin_servers):
    from dist_dqn_tpu.serving import ServingClient as JaxClient

    s = twin_servers
    obs = _obs(CROSS_ROWS, seed=2024)    # fixed before any comparison
    jq = np.asarray(s.jnet.apply(s.params, jnp.asarray(obs),
                                 method=s.jnet.q_values))
    with torch.no_grad():
        tq = s.net.q_values(torch.from_numpy(obs)).numpy()
    bound = Q_RTOL * np.maximum(1.0, np.abs(jq))
    assert np.all(np.abs(tq - jq) <= bound)
    top2 = np.sort(jq, axis=-1)
    compared = (top2[:, -1] - top2[:, -2]) > 2 * bound.max(axis=-1)
    # With this seed no row is excluded: the smallest JAX top-2 gap is
    # 0.016, the largest |dQ| between the packages 4.8e-7.
    excluded = int((~compared).sum())
    assert excluded == 0, f"{excluded} of {CROSS_ROWS} rows within tolerance"
    jcl, tcl = JaxClient(s.jsrv.address), ServingClient(s.tsrv.address)
    try:
        ja = jcl.act(obs, greedy=True).actions
        ta = tcl.act(obs, greedy=True).actions
    finally:
        jcl.close()
        tcl.close()
    np.testing.assert_array_equal(ta[compared], ja[compared])
    np.testing.assert_array_equal(ta, greedy_on_bucket(s.net, obs,
                                                       CROSS_ROWS))


def test_wire_is_the_jax_wire(twin_servers):
    """Each package's client talks to the other package's server, and
    the two servers answer one body with the same meta keys and arrays."""
    from dist_dqn_tpu.actors.transport import \
        decode_arrays as jax_decode
    from dist_dqn_tpu.serving import ServingClient as JaxClient
    from dist_dqn_tpu.serving import UnknownPolicyError as JaxUnknown

    s = twin_servers
    obs = _obs(3, seed=9)
    for client_cls, unknown, srv in ((JaxClient, JaxUnknown, s.tsrv),
                                     (ServingClient, UnknownPolicyError,
                                      s.jsrv)):
        cl = client_cls(srv.address)
        try:
            r = cl.act(obs, greedy=True)
            assert r.actions.shape == (3,) and r.version == 1
            assert r.step == 100 and r.policy_id == "default"
            assert cl.policies()["default"]["step"] == 100
            assert cl.healthz() == (200, b"ok\n")
            with pytest.raises(unknown):
                cl.act(obs, policy="nope")
        finally:
            cl.close()
    body = encode_arrays({"obs": obs}, meta={"greedy": True,
                                             "policy": "default"})
    answers = []
    for srv in (s.jsrv, s.tsrv):
        conn = http.client.HTTPConnection(srv.host, srv.port, timeout=30)
        try:
            conn.request("POST", "/v1/act", body=body)
            resp = conn.getresponse()
            assert resp.status == 200
            assert resp.getheader("Content-Type") == \
                "application/octet-stream"
            answers.append(resp.read())
        finally:
            conn.close()
    (ja, jmeta), (ta, tmeta) = (jax_decode(a) for a in answers)
    assert sorted(tmeta) == sorted(jmeta)
    assert {k: (v.dtype, v.shape) for k, v in ta.items()} == \
        {k: (v.dtype, v.shape) for k, v in ja.items()}
    assert decode_arrays(answers[0])[1].keys() == jmeta.keys()


# --------------------------------------------------------------------------
# C8: host_loop-kind directories restore like carry-kind ones.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [None, "learner", "carry", "host_loop"])
def test_ckpt_prefix_matches_jax(kind, tmp_path):
    """evaluate.py and the model store restore under ``params_prefix``,
    which must place the learner where JAX's ``_ckpt_prefix`` does."""
    from dist_dqn_tpu.evaluate import _ckpt_prefix as jax_prefix
    from dist_dqn_tpu_torch.utils.checkpoint import (params_prefix,
                                                     record_checkpoint_kind)

    if kind is not None:
        record_checkpoint_kind(str(tmp_path), kind)
    assert params_prefix(str(tmp_path)) == jax_prefix(str(tmp_path))


def test_host_replay_checkpoint_evaluates_and_serves(tmp_path):
    """A ``--runtime host-replay`` run saves its learner one level down
    (host_loop-kind): evaluate and the serving model store restore it."""
    from dist_dqn_tpu_torch.evaluate import evaluate_checkpoint
    from dist_dqn_tpu_torch.host_replay_loop import run_host_replay

    cfg = tconfig.apply_overrides(CFG, [
        "network.mlp_features=(16,)", "replay.capacity=1024",
        "replay.min_fill=64", "learner.batch_size=16", "actor.num_envs=4",
        "eval_every_steps=0"])
    d = str(tmp_path / "host_replay")
    out = run_host_replay(cfg, total_env_steps=800, chunk_iters=50,
                          log_fn=QUIET, checkpoint_dir=d,
                          save_every_frames=400, device="cpu")
    assert open(os.path.join(d, "CHECKPOINT_KIND")).read() == "host_loop"
    ev = evaluate_checkpoint(cfg, d, episodes=1, device="cpu")
    assert ev["frames"] == out["env_steps"] and ev["eval_return"] >= 1.0
    srv = build_server(cfg, {"default": d}, device="cpu", max_rows=4,
                       poll_interval_s=3600.0, log_fn=QUIET)
    cl = ServingClient(srv.address)
    try:
        r = cl.act(_obs(4), greedy=True)
        assert r.step == out["env_steps"]
        np.testing.assert_array_equal(
            r.actions, greedy_on_bucket(out["learner"].net, _obs(4), 4))
    finally:
        cl.close()
        srv.close()
