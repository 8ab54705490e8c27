"""Remote (TCP) actors on the port's Ape-X service, after the JAX
package's tests/test_remote_actors.py:

* mixed local and remote actor processes, and remote R2D2 actors, end to
  end on the CPU (their ``slow`` JAX twins at a smaller size): every id
  sends records, nothing is dropped, shed, corrupt or rejected;
* a reconnect over real TCP re-hellos: the lanes, the partial episode and
  the recurrent carry reset, and replies follow the new connection;
* malformed and misrouted records are rejected at the record boundary
  (the JAX test's cases, plus a hello refusal that NACKs the peer);
* ``--remote-actor-mode external``: the train CLI waits for a worker
  started with ``python -m dist_dqn_tpu_torch.actors.remote``.

Every listener binds port 0 (the tests run under xdist).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import ingest as tingest
from dist_dqn_tpu_torch.actors import actor as tactor
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.actors.transport import (PROTO_MISMATCH_NACK_KIND,
                                                 TcpRecordClient,
                                                 decode_arrays,
                                                 encode_arrays)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FF = ["network.torso=mlp", "network.mlp_features=(32,)", "network.hidden=0",
       "network.dueling=false", "network.compute_dtype=float32",
       "replay.capacity=4096", "replay.min_fill=150",
       "learner.batch_size=16", "learner.n_step=2"]
_R2D2 = ["network.torso=mlp", "network.mlp_features=(32,)",
         "network.hidden=0", "network.lstm_size=16", "network.dueling=false",
         "network.compute_dtype=float32", "network.lstm_dtype=float32",
         "replay.capacity=2048", "replay.min_fill=64", "replay.burn_in=2",
         "replay.unroll_length=6", "replay.sequence_stride=3",
         "learner.batch_size=16", "learner.n_step=2"]


def _assert_clean(result, ids):
    assert result["ring_dropped"] == 0 and result["bad_records"] == 0
    assert result["tcp_backpressure"] == 0
    assert result["tcp_corrupt_frames"] == 0
    assert result["tcp_shed_records"] == 0
    assert result["hello_rejects"] == 0 and result["actor_restarts"] == 0
    assert set(result["records_by_actor"]) == {str(i) for i in ids}
    assert all(n > 10 for n in result["records_by_actor"].values())


@pytest.mark.parametrize("actor_priorities", [True, False])
def test_apex_mixed_local_and_remote_actors(actor_priorities):
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["apex"], _FF)
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=1,
                                    envs_per_actor=4, total_env_steps=1500,
                                    inserts_per_grad_step=32,
                                    num_remote_actors=2,
                                    actor_priorities=actor_priorities)
    logs = []
    result = tservice.run_apex(cfg, rt, log_fn=logs.append, device="cpu")
    assert result["env_steps"] >= 1500
    assert result["grad_steps"] >= 5
    _assert_clean(result, (0, 1, 2))
    assert result["ingest_bytes"]["tcp"] > 0
    # The listener of locally spawned remote actors is loopback only.
    address = [json.loads(s)["tcp_address"] for s in logs
               if "tcp_address" in s]
    assert address and address[0][0] == "127.0.0.1"
    assert result["assembler"] == ("python" if actor_priorities
                                   else "native")


def test_apex_remote_r2d2_actors():
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["r2d2"], _R2D2)
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=0,
                                    envs_per_actor=4, total_env_steps=1000,
                                    inserts_per_grad_step=16,
                                    num_remote_actors=2)
    result = tservice.run_apex(cfg, rt, log_fn=lambda s: None, device="cpu")
    assert result["env_steps"] >= 1000
    assert result["grad_steps"] >= 3
    assert result["replay_size"] > 30
    _assert_clean(result, (0, 1))


def _poll(svc, client, timeout=10.0):
    """Serve one pass of the service until the client's reply arrives."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if svc._drain_transports():
            svc._flush_act_queue()
            return client.read_reply()
        time.sleep(0.005)
    raise AssertionError("no record reached the service")


def test_reconnect_resets_lanes_and_carry_and_reroutes_replies():
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["r2d2"], _R2D2)
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=1,
                                    envs_per_actor=2, total_env_steps=100,
                                    num_remote_actors=1,
                                    spawn_remote_actors=False)
    svc = tservice.ApexLearnerService(cfg, rt, log_fn=lambda s: None,
                                      device="cpu")
    from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
    try:
        env = make_host_env("CartPole-v1", 2, seed=3)
        obs = env.reset()
        schema = tingest.step_schema(obs.shape[1:], obs.dtype, 2)
        enc = tingest.StepEncoder(schema)
        hello = encode_arrays({"obs": obs}, tactor._hello_meta(
            1, 0, "zerocopy", schema))
        first = TcpRecordClient(svc.tcp_address, max_stall_s=20)
        first.push(hello)
        reply = _poll(svc, first)
        t = 0
        for _ in range(5):
            actions, _, _, hdr = tingest.decode_reply(reply)
            obs, t, payload = tactor._step_and_encode_zc(
                env, actions, enc, 1, t, hdr["shard"], None, None)
            first.push(payload)
            reply = _poll(svc, first)
        asm = svc.assemblers[1]
        assert all(len(lane.obs) == 5 for lane in asm.lanes)
        assert svc._carry[1] is not None and np.abs(svc._carry[1][0]).sum()
        conn_before = svc._actor_conn[1]
        first.close()
        # The worker comes back on a new connection with a fresh hello.
        second = TcpRecordClient(svc.tcp_address, max_stall_s=20)
        second.push(encode_arrays({"obs": obs}, tactor._hello_meta(
            1, t, "zerocopy", schema)))
        deadline = time.time() + 10
        while not svc._drain_transports() and time.time() < deadline:
            time.sleep(0.005)
        assert svc._actor_conn[1] != conn_before
        assert all(len(lane.obs) == 0 for lane in svc.assemblers[1].lanes)
        assert 1 not in svc._ep_accum
        assert svc._carry[1] is None
        svc._flush_act_queue()
        np.testing.assert_array_equal(svc._carry[1][0].shape, (2, 16))
        actions, _, _, hdr = tingest.decode_reply(second.read_reply())
        assert hdr["t"] == t and actions.shape == (2,)
        second.close()
    finally:
        svc.shutdown()


def test_service_rejects_malformed_and_misrouted_records():
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["apex"], [
        "network.torso=mlp", "network.mlp_features=(16,)", "network.hidden=0",
        "network.dueling=false", "network.compute_dtype=float32",
        "replay.capacity=256", "replay.min_fill=32", "learner.batch_size=8"])
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=1,
                                    envs_per_actor=2, total_env_steps=100,
                                    num_remote_actors=1,
                                    spawn_remote_actors=False)
    svc = tservice.ApexLearnerService(cfg, rt, log_fn=lambda s: None,
                                      device="cpu")
    try:
        # A TCP record claiming a local actor id.
        hello = encode_arrays({"obs": np.zeros((2, 4), np.float32)},
                              {"kind": "hello", "actor": 0, "t": 0})
        with pytest.raises(ValueError, match="out-of-range"):
            svc._handle_record(hello, conn_id=7)
        # A step record before any hello.
        step = encode_arrays(
            {"obs": np.zeros((2, 4), np.float32),
             "reward": np.zeros((2,), np.float32),
             "terminated": np.zeros((2,), np.uint8),
             "truncated": np.zeros((2,), np.uint8),
             "next_obs": np.zeros((2, 4), np.float32)},
            {"kind": "step", "actor": 1, "t": 5})
        with pytest.raises(ValueError, match="before hello"):
            svc._handle_record(step, conn_id=7)
        hello_ok = encode_arrays({"obs": np.zeros((2, 4), np.float32)},
                                 {"kind": "hello", "actor": 1, "t": 0})
        svc._handle_record(hello_ok, conn_id=7)
        # A mismatched obs spec dies at the record boundary.
        for bad_obs in (np.zeros((2, 5), np.float32),
                        np.zeros((2, 4), np.float64)):
            bad = encode_arrays({"obs": bad_obs},
                                {"kind": "hello", "actor": 1, "t": 1})
            with pytest.raises(ValueError, match="does not match"):
                svc._handle_record(bad, conn_id=7)
        # Over real TCP: a drifted protocol version is NACKed and counted
        # as one bad record, never a service error.
        client = TcpRecordClient(svc.tcp_address, max_stall_s=20)
        client.push(encode_arrays({"obs": np.zeros((2, 4), np.float32)},
                                  {"kind": "hello", "actor": 1, "t": 0,
                                   "proto": 999, "transport": "zerocopy"}))
        deadline = time.time() + 10
        while not svc._drain_transports() and time.time() < deadline:
            time.sleep(0.005)
        _, meta = decode_arrays(client.read_reply())
        assert meta["kind"] == PROTO_MISMATCH_NACK_KIND
        assert "wire protocol 999" in meta["detail"]
        assert svc.bad_records == 1 and svc.hello_rejects == 1
        client.close()
    finally:
        svc.shutdown()


def test_remote_actor_mode_external_with_the_remote_entry(tmp_path):
    """The train CLI listens on an ephemeral port (``--tcp-port 0``) and
    waits; a worker from ``python -m dist_dqn_tpu_torch.actors.remote``
    connects to the logged address and feeds the run to its end. Every
    wait has a time limit, and both processes are killed on the way out."""
    import queue
    import threading

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    err = open(tmp_path / "train.err", "w")
    train = subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", "--config",
         "cartpole", "--runtime", "apex", "--device", "cpu",
         "--num-actors", "0", "--num-remote-actors", "1",
         "--remote-actor-mode", "external", "--tcp-port", "0",
         "--envs-per-actor", "4", "--total-env-steps", "800",
         "--set", "network.mlp_features=(16,)", "--set",
         "replay.min_fill=128", "--set", "learner.batch_size=16"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    lines: "queue.Queue" = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in train.stdout],
        daemon=True)
    reader.start()
    stop = tmp_path / "stop"
    worker = None
    try:
        out, deadline = [], time.time() + 120
        while not any("tcp_address" in line for line in out):
            assert time.time() < deadline and train.poll() is None, \
                (tmp_path / "train.err").read_text()[-3000:]
            try:
                out.append(lines.get(timeout=1))
            except queue.Empty:
                pass
        host, port = json.loads(out[-1])["tcp_address"]
        assert host == "0.0.0.0"
        worker = subprocess.Popen(
            [sys.executable, "-m", "dist_dqn_tpu_torch.actors.remote",
             "--address", f"127.0.0.1:{port}", "--actor-id", "0",
             "--env", "CartPole-v1", "--num-envs", "4",
             "--stop-file", str(stop), "--max-reconnect-failures", "3"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        assert train.wait(timeout=180) == 0, \
            (tmp_path / "train.err").read_text()[-3000:]
        reader.join(timeout=30)
        while not lines.empty():
            out.append(lines.get())
        summary = json.loads(out[-1])
        assert summary["env_steps"] >= 800 and summary["grad_steps"] > 0
        assert summary["records_by_actor"].keys() == {"0"}
        assert summary["ingest_bytes"]["tcp"] > 0
        stop.write_text("stop")
        _, worker_err = worker.communicate(timeout=60)
        assert worker.returncode == 0, worker_err[-3000:]
    finally:
        for p in (train, worker):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        err.close()


def _apex_service_entry(cfg, rt, summary_path, log_path):
    """Spawn target: run the learner service on the CPU to completion,
    mirroring its log stream and final summary to files the parent can
    read. Module-level so the spawn context can pickle it."""
    def _log(s):
        with open(log_path, "a") as fh:
            fh.write(str(s) + "\n")

    out = tservice.run_apex(cfg, rt, log_fn=_log, device="cpu")
    with open(summary_path, "w") as fh:
        json.dump({k: v for k, v in out.items()
                   if isinstance(v, (int, float, str, type(None)))}, fh)


@pytest.mark.slow
@pytest.mark.chaos
def test_learner_kill_restart_actors_reattach(tmp_path):
    """Twin of tests/test_remote_actors.py:237: kill -9 the Ape-X learner
    mid-run with LIVE external remote actors, restart it against the same
    checkpoint dir and TCP port, and require (a) the restarted learner
    resumes from the killed run's last completed checkpoint, (b) the SAME
    actor processes — never restarted — re-attach via reconnect +
    re-hello and feed it to completion, and (c) the env-steps trajectory
    continues from the resume point instead of restarting at zero."""
    import dataclasses
    import multiprocessing as mp
    import socket

    from dist_dqn_tpu_torch.utils.checkpoint import read_latest_pointer

    cfg = tconfig.apply_overrides(tconfig.CONFIGS["apex"], _FF)
    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    probe.bind(("127.0.0.1", 0))     # socket: bound+closed immediately
    port = probe.getsockname()[1]
    probe.close()
    ckpt_dir = str(tmp_path / "ckpt")
    stop_path = str(tmp_path / "stop_actors")
    rt = tservice.ApexRuntimeConfig(
        host_env="CartPole-v1", num_actors=0, envs_per_actor=4,
        total_env_steps=10 ** 9,      # run 1 ends by kill, not target
        inserts_per_grad_step=32, log_every_s=0.5,
        tcp_port=port, num_remote_actors=2, spawn_remote_actors=False,
        checkpoint_dir=ckpt_dir, save_every_steps=400)

    ctx = mp.get_context("spawn")
    actors = [
        ctx.Process(
            target=tactor.run_remote_actor,
            args=(i, "CartPole-v1", 4, 1000 + 7 * i,
                  ("127.0.0.1", port), stop_path),
            kwargs=dict(max_consecutive_failures=2000,
                        reconnect_backoff_s=0.05),
            name=f"test-remote-actor-{i}", daemon=True)
        for i in range(2)]
    svc1 = ctx.Process(
        target=_apex_service_entry,
        args=(cfg, rt, str(tmp_path / "s1.json"), str(tmp_path / "s1.log")),
        name="test-apex-learner-1", daemon=False)
    svc2 = None
    try:
        svc1.start()
        for a in actors:
            a.start()
        deadline = time.time() + 300
        ptr = None
        while time.time() < deadline:
            ptr = read_latest_pointer(ckpt_dir)
            if ptr is not None:
                break
            assert svc1.is_alive(), "learner died before first save"
            time.sleep(0.2)
        assert ptr is not None, "no checkpoint within 300s"
        svc1.kill()
        svc1.join(30)
        assert not os.path.exists(tmp_path / "s1.json")
        assert all(a.is_alive() for a in actors)

        rt2 = dataclasses.replace(
            rt, total_env_steps=int(ptr["step"]) + 2000)
        svc2 = ctx.Process(
            target=_apex_service_entry,
            args=(cfg, rt2, str(tmp_path / "s2.json"),
                  str(tmp_path / "s2.log")),
            name="test-apex-learner-2", daemon=False)
        svc2.start()
        svc2.join(300)
        assert svc2.exitcode == 0, "restarted learner did not finish"

        with open(tmp_path / "s2.json") as fh:
            summary = json.load(fh)
        log2 = (tmp_path / "s2.log").read_text()
        resumed = [json.loads(ln)["resumed_at_env_steps"]
                   for ln in log2.splitlines()
                   if "resumed_at_env_steps" in ln]
        assert resumed and resumed[0] >= int(ptr["step"])
        assert summary["env_steps"] >= rt2.total_env_steps
        assert summary["grad_steps"] > 0
        assert all(a.is_alive() for a in actors)
    finally:
        with open(stop_path, "w") as fh:
            fh.write("stop")
        for p in ([svc1] + ([svc2] if svc2 is not None else [])):
            if p.is_alive():
                p.kill()
                p.join(10)
        for a in actors:
            a.join(60)
            if a.is_alive():
                a.terminate()
