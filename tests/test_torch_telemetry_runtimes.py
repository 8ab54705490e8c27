"""The telemetry plane through the port's runtimes, against the JAX
package's: the fused loop, host replay, the Ape-X service and serving each
export the JAX runtime's metric families, as (name, kind, label keys), at
a small size, exactly (the watchdog's and flight recorder's families
included, from a sweep of each package's watchdog at every chunk of the
fused loop); the chip-time plane's program table,
ledger and spans included (both packages' program registries are fresh
too); counters that count the same thing in both packages hold the same
value. The CLIs'
``--telemetry-port 0`` serves ``/metrics`` while the run lives,
``--telemetry-snapshot`` writes the live snapshot's keys at SIGTERM, and
the feeders count their ring-full retries."""
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.telemetry import devtime as jdevtime
from dist_dqn_tpu.telemetry import registry as jregistry
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.telemetry import devtime as tdevtime
from dist_dqn_tpu_torch.telemetry import registry as tregistry
from torch_telemetry_workers import families

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = lambda *_: None  # noqa: E731

#: Families whose writers the port does not have yet: none.
UNPORTED_FAMILIES = set()


def _sig(fams) -> set:
    return {(n, k, tuple(ls)) for n, k, ls in fams}


def _assert_same_families(jreg, treg):
    want = {f for f in _sig(families(jreg))
            if f[0] not in UNPORTED_FAMILIES}
    got = _sig(families(treg))
    assert got == want, (sorted(want - got), sorted(got - want))


@pytest.fixture
def fresh_registries(monkeypatch):
    """Fresh process registries in both packages for one runtime run, and
    fresh program registries recording into them."""
    jreg, treg = jregistry.Registry(), tregistry.Registry()
    monkeypatch.setattr(jregistry, "_default_registry", jreg)
    monkeypatch.setattr(tregistry, "_default_registry", treg)
    monkeypatch.setattr(jdevtime, "_program_registry",
                        jdevtime.ProgramRegistry(jreg))
    monkeypatch.setattr(tdevtime, "_program_registry",
                        tdevtime.ProgramRegistry(treg))
    return jreg, treg


def _value(reg, key):
    return reg.snapshot()[key]["value"]


_FUSED = ["replay.capacity=2048", "replay.min_fill=128",
          "eval_every_steps=0", "network.mlp_features=(32,)",
          "learner.batch_size=16", "actor.num_envs=8"]


@pytest.mark.parametrize("per", [False, True], ids=["uniform", "per"])
def test_fused_cartpole_exports_the_jax_families(fresh_registries, per,
                                                monkeypatch):
    """The twin of tests/test_telemetry.py's CartPole train smoke: the
    same families, and the same env steps, grad steps and device replay
    occupancy (the cadence is the JAX loop's). Each package's watchdog
    (installed, not swept by a thread) is swept once a chunk while the
    loop's heartbeat is registered, so its families are held too."""
    from dist_dqn_tpu.telemetry import watchdog as jwatchdog
    from dist_dqn_tpu.train import train as jtrain
    from dist_dqn_tpu_torch.telemetry import watchdog as twatchdog
    from dist_dqn_tpu_torch.train import train as ttrain

    jreg, treg = fresh_registries
    sets = [*_FUSED, f"replay.prioritized={str(per).lower()}"]
    for mod in (jwatchdog, twatchdog):
        monkeypatch.setattr(mod, "_watchdog", mod.Watchdog(
            start=False, log_fn=None))

    def sweep(mod):
        def stop_fn(row):
            assert mod._watchdog.check() == {}
            return False
        return stop_fn

    jtrain(jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], sets),
           total_env_steps=1600, chunk_iters=50, log_fn=QUIET,
           stop_fn=sweep(jwatchdog))
    ttrain(tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], sets),
           total_env_steps=1600, chunk_iters=50, log_fn=QUIET,
           device="cpu", stop_fn=sweep(twatchdog))
    _assert_same_families(jreg, treg)
    assert _value(treg, 'dqn_watchdog_stalls_total{stage=fused.chunk}') \
        == _value(jreg, 'dqn_watchdog_stalls_total{stage=fused.chunk}') \
        == 0
    for key in ("dqn_env_steps_total", "dqn_grad_steps_total",
                "dqn_replay_size{store=device}",
                "dqn_replay_capacity{store=device}",
                "dqn_learner_train_batch_size{loop=fused}",
                "dqn_program_dispatches_total{loop=fused,"
                "program=fused.chunk}"):
        assert _value(treg, key) == _value(jreg, key), key
    assert _value(treg, "dqn_env_steps_total") == 1600
    snap = treg.snapshot()
    assert snap["dqn_chunk_seconds"]["count"] == 4
    assert snap["dqn_replay_sample_age_seconds{loop=fused}"]["count"] > 0
    if per:
        assert _value(treg, "dqn_replay_max_priority{store=device}") >= 1.0


def test_fused_population_exports_the_jax_families(fresh_registries):
    from dist_dqn_tpu.train import train as jtrain
    from dist_dqn_tpu_torch.train import train as ttrain

    jreg, treg = fresh_registries
    sets = [*_FUSED, "population.size=2",
            'population.spec_json={"epsilon": [0.05, 0.2]}']
    jtrain(jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], sets),
           total_env_steps=800, chunk_iters=50, log_fn=QUIET)
    ttrain(tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], sets),
           total_env_steps=800, chunk_iters=50, log_fn=QUIET,
           device="cpu")
    _assert_same_families(jreg, treg)
    for key in ("dqn_env_steps_total", "dqn_grad_steps_total",
                "dqn_population_size{loop=fused}",
                "dqn_program_dispatches_total{loop=fused,"
                "program=population.chunk}"):
        assert _value(treg, key) == _value(jreg, key), key
    assert _value(treg, "dqn_env_steps_total") == 2 * 800


_HOST_REPLAY = ["network.mlp_features=(32,)", "replay.capacity=4096",
                "replay.min_fill=64", "learner.batch_size=16",
                "actor.num_envs=8", "eval_every_steps=0"]


@pytest.mark.parametrize("kw", [dict(prioritized=True),
                                dict(prioritized=False, pipeline=False,
                                     prefetch=False)],
                         ids=["per_pipelined", "uniform_serial"])
def test_host_replay_exports_the_jax_families(fresh_registries, kw,
                                              tmp_path):
    from dist_dqn_tpu import host_replay_loop as jhrl
    from dist_dqn_tpu_torch import host_replay_loop as thrl

    jreg, treg = fresh_registries
    common = dict(total_env_steps=800, chunk_iters=50, log_fn=QUIET, **kw)
    jout = jhrl.run_host_replay(
        jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], _HOST_REPLAY),
        checkpoint_dir=str(tmp_path / "j"), **common)
    tout = thrl.run_host_replay(
        tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], _HOST_REPLAY),
        checkpoint_dir=str(tmp_path / "t"), device="cpu", **common)
    _assert_same_families(jreg, treg)
    assert tout["grad_steps"] == jout["grad_steps"]
    for key in ("dqn_replay_size{store=host_ring}",
                "dqn_replay_capacity{store=host_ring}",
                "dqn_replay_added_total{store=host_ring}",
                "dqn_host_replay_d2h_bytes_total{loop=host_replay}",
                "dqn_checkpoint_shards_saved{loop=host_replay}",
                "dqn_program_dispatches_total{loop=host_replay,"
                "program=host_replay.train_step}",
                "dqn_program_dispatches_total{loop=host_replay,"
                "program=host_replay.collect}"):
        assert _value(treg, key) == _value(jreg, key), key
    assert _value(treg, "dqn_host_replay_d2h_bytes_total{loop=host_replay}"
                  ) == tout["d2h_bytes_total"]
    if kw["prioritized"]:
        assert _value(treg, "dqn_host_replay_prio_writeback_rows_total"
                      "{loop=host_replay}") == tout["prio_writeback_rows"]


def _service_run(pkg: str, trace_path=None) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_telemetry_workers.py"), pkg,
         *([str(trace_path)] if trace_path else [])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_apex_service_exports_the_jax_families(tmp_path):
    """One actor process, 800 CartPole steps, each package's service in a
    process of its own with a host-loop trace (the span and trace-counter
    families); the port's counters equal its own summary, and its program
    table's dispatches its device-call counts."""
    jout = _service_run("jax", tmp_path / "j.json")
    tout = _service_run("torch", tmp_path / "t.json")
    want = {f for f in _sig(jout["families"])
            if f[0] not in UNPORTED_FAMILIES}
    got = _sig(tout["families"])
    assert got == want, (sorted(want - got), sorted(got - want))
    s, v = tout["summary"], tout["values"]
    assert v["dqn_env_steps_total"] == s["env_steps"] == 800
    assert v["dqn_grad_steps_total"] == s["grad_steps"]
    assert v["dqn_replay_size{store=host}"] == s["replay_size"]
    assert sum(val for key, val in v.items()
               if key.startswith("dqn_ingest_records_total")) == \
        sum(s["records_by_shard"].values())
    for kind, n in s["device_calls"].items():
        assert v[f"dqn_service_device_calls_total{{call={kind}}}"] == n
        prog = "apex.train_step" if kind == "train" else f"apex.{kind}"
        assert s["programs"][prog]["dispatches"] == n
        assert v["dqn_program_dispatches_total{loop=apex,program="
                 f"{prog}}}"] == n
    assert v["dqn_service_ingest_passes_total"] == s["ingest_passes"]
    assert v["dqn_episodes_completed_total"] == s["episodes_completed"]


def test_serving_exports_the_jax_families(fresh_registries, tmp_path):
    """Both packages' servers on a checkpoint each, after one act request
    and one /metrics scrape."""
    import jax.numpy as jnp

    from dist_dqn_tpu.agents.dqn import make_learner as jax_learner
    from dist_dqn_tpu.envs import make_jax_env
    from dist_dqn_tpu.models import build_network as jax_build
    from dist_dqn_tpu.serving import ServingClient as JaxClient
    from dist_dqn_tpu.serving import build_server as jax_build_server
    from dist_dqn_tpu.utils.checkpoint import \
        TrainCheckpointer as JaxCheckpointer
    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.serving import ServingClient, build_server
    from dist_dqn_tpu_torch.utils.checkpoint import TrainCheckpointer

    jreg, treg = fresh_registries
    jcfg = jconfig.CONFIGS["cartpole"]
    env = make_jax_env(jcfg.env_name)
    jnet = jax_build(jcfg.network, env.num_actions)
    state = jax_learner(jnet, jcfg.learner)[0](
        jax.random.PRNGKey(0),
        jnp.zeros(env.observation_shape, env.observation_dtype))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt = JaxCheckpointer(jdir, save_every_frames=1)
    jckpt.save(100, state)
    jckpt.wait()
    jckpt.close()
    tcfg = tconfig.CONFIGS["cartpole"]
    net = build_network(tcfg.network, 2, (4,), device="cpu", seed=0)
    TrainCheckpointer(tdir).save(100, make_learner(tcfg.learner, net)[0](
        net))
    kw = dict(max_rows=4, max_wait_ms=1.0, queue_limit=64,
              poll_interval_s=3600.0, log_fn=QUIET)
    jsrv = jax_build_server(jcfg, {"default": jdir}, compile_warmup=False,
                            **kw)
    tsrv = build_server(tcfg, {"default": tdir}, device="cpu", **kw)
    obs = np.zeros((2, 4), np.float32)
    try:
        for client in (JaxClient(jsrv.address), ServingClient(tsrv.address)):
            try:
                client.act(obs, greedy=True)
                client._get("/metrics")
            finally:
                client.close()
    finally:
        jsrv.close()
        tsrv.close()
    _assert_same_families(jreg, treg)
    assert _value(treg, "dqn_serving_requests_total{policy=default}") == \
        _value(jreg, "dqn_serving_requests_total{policy=default}") == 1
    assert _value(treg, "dqn_program_dispatches_total{loop=serving,"
                  "program=serving.act}") == 1


# -- the CLIs -------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


_CLI_TINY = ["--device", "cpu", "--chunk-iters", "50",
             "--eval-every-steps", "0",
             "--set", "network.mlp_features=(16,)",
             "--set", "replay.capacity=4096", "--set", "replay.min_fill=64",
             "--set", "learner.batch_size=16", "--set", "actor.num_envs=8"]


@pytest.mark.parametrize("runtime", ["fused", "host-replay"])
def test_train_cli_serves_metrics_and_snapshots_at_sigterm(runtime,
                                                           tmp_path):
    """``--telemetry-port 0``: the port row follows the manifest row,
    ``/metrics`` and ``/debug/config`` answer while chunks run (the config
    hash is the manifest line's), and SIGTERM writes the
    ``--telemetry-snapshot`` file with the live snapshot's keys."""
    snap = tmp_path / "snap.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
         "cartpole", "--runtime", runtime, "--total-env-steps",
         "100000000", *_CLI_TINY, "--telemetry-port", "0",
         "--telemetry-snapshot", str(snap)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        while not any(line.startswith('{"env_frames"') for line in lines):
            line = proc.stdout.readline()
            assert line, "".join(lines) + proc.stderr.read()[-3000:]
            lines.append(line)
        rows = [json.loads(line) for line in lines if line.startswith("{")]
        manifest = rows[0]["manifest"]
        port = rows[1]["telemetry_port"]
        assert b"dqn_replay_size" in _get(port, "/metrics")
        config = json.loads(_get(port, "/debug/config"))
        assert config["config_hash"] == manifest["config_hash"]
        assert b"telemetry-http" in _get(port, "/debug/stacks")
        live = json.loads(_get(port, "/metrics.json"))
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
    assert proc.returncode == 128 + signal.SIGTERM
    dumped = json.loads(snap.read_text())
    assert set(dumped) == set(live)
    assert dumped["dqn_replay_size{store=device}" if runtime == "fused"
                  else "dqn_replay_size{store=host_ring}"]["value"] > 0


def test_remote_worker_serves_metrics_and_snapshots_from_env(tmp_path):
    """The remote worker's ``--telemetry-port 0`` serves its registry
    while it retries a connect, and ``DQN_TELEMETRY_SNAPSHOT`` dumps it
    per process at exit; the worker stays torch-free."""
    stop = tmp_path / "stop"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["DQN_TELEMETRY_SNAPSHOT"] = str(tmp_path / "snap_{tag}_{pid}.json")
    code = ("import runpy, sys\n"
            "sys.argv = ['remote', *sys.argv[1:]]\n"
            "try:\n"
            "    runpy.run_module('dist_dqn_tpu_torch.actors.remote',"
            " run_name='__main__')\n"
            "finally:\n"
            "    print('TORCH', 'torch' in sys.modules, flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--address", "127.0.0.1:1",
         "--actor-id", "3", "--env", "CartPole-v1", "--num-envs", "2",
         "--stop-file", str(stop), "--max-reconnect-failures", "1000",
         "--telemetry-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = json.loads(proc.stdout.readline())["telemetry_port"]
        # The worker registers its series once its env is built.
        deadline = time.time() + 60
        text = ""
        while "dqn_actor_reconnects_total" not in text \
                and time.time() < deadline:
            time.sleep(0.05)
            text = _get(port, "/metrics").decode()
        assert 'dqn_actor_env_steps_total{actor="3"} 0' in text
        assert 'dqn_actor_reconnects_total{actor="3"} 0' in text
        stop.write_text("stop")
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "TORCH False" in out
    dumped = json.loads((tmp_path / f"snap_remote3_{proc.pid}.json"
                         ).read_text())
    assert dumped['dqn_actor_env_steps_total{actor=3}']["value"] == 0


def test_feeder_counts_records_and_ring_full_retries(tmp_path):
    """A zero-copy feeder against a ring nobody drains: it counts every
    record it published and every push the full ring refused."""
    from dist_dqn_tpu_torch import ingest
    from dist_dqn_tpu_torch.actors.feeder import run_feeder
    from dist_dqn_tpu_torch.actors.transport import ShmMailbox, shm_dir
    from dist_dqn_tpu_torch.telemetry import get_registry

    run = f"tel{os.getpid()}"
    os.makedirs(shm_dir() / run, exist_ok=True)
    ring = ingest.ShmSlotRing(f"req_{run}_zc_5", slot_size=1 << 16,
                              nslots=4, create=True)
    box = ShmMailbox(f"{run}/act_5", max_size=1 << 16, create=True)
    box.write(b"hello", version=1)      # the hello's reply
    stop = tmp_path / "stop"
    reg = get_registry()
    full = reg.counter("dqn_feeder_ring_full_total",
                       "push attempts refused by a full ring",
                       {"actor": "5"})
    records = reg.counter("dqn_feeder_records_total",
                          "records pushed into the shm ring",
                          {"actor": "5"})
    full0, records0 = full.value, records.value
    t = threading.Thread(target=run_feeder, args=(
        5, "feeder:vector", 2, 0, f"req_{run}", f"{run}/act_5", str(stop)),
        kwargs=dict(transport="zerocopy"), daemon=True)
    t.start()
    try:
        deadline = time.time() + 30
        while full.value - full0 < 3 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        stop.write_text("stop")
        t.join(timeout=30)
        ring.close()
        ring.unlink()
        box.unlink()
        shutil.rmtree(shm_dir() / run, ignore_errors=True)
    assert not t.is_alive()
    assert full.value - full0 >= 3
    # The hello took one slot; the step records filled the other three.
    assert records.value - records0 == 3
