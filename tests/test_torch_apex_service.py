"""The port's Ape-X service (dist_dqn_tpu_torch/actors/service.py) and its
``--runtime apex`` CLI, against the JAX package's:

* the CLI prints the JAX CLI's lines for the flags the runtime ignores,
  word for word, and builds the same ``ApexRuntimeConfig`` from the same
  flags (both services stubbed);
* the service's constructor refusals carry the JAX service's text, and
  every option the port leaves out raises "not ported yet" naming its
  ROADMAP.md item, before any shared-memory segment exists, also beside
  the distributed options (several learner devices or replay shards),
  which run (tests/test_torch_apex_distributed.py); the options ported
  since (remote actors, the legacy wire, the learner-side bootstrap,
  replay snapshots, a recurrent config) build their paths and leave
  nothing behind;
* a short end-to-end run on the CPU (one actor process) through the CLI,
  in a subprocess with a time limit, holds the JAX package's plumbing
  invariants (tests/test_apex_integration.py:34-44): steps flowed, the
  replay filled, the learner stepped, nothing dropped; one act dispatch
  per ingest pass, and the frame-stack dedup wire on synthstack;
* the actor-side modules import no torch, and a spawned actor process
  loads none;
* (slow, as the JAX file is) the split learns CartPole.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.actors import service as tservice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Stub:
    """Stands in for a service: records its configs, runs nothing."""

    seen = []

    def __init__(self, cfg, rt, **_):
        _Stub.seen.append((cfg, rt))

    def run(self):
        return {"stub": True}


def _comment_lines(text):
    return [line for line in text.splitlines() if line.startswith("#")]


_CLI_CASES = {
    "cartpole_mlp_swap": ["--config", "cartpole", "--runtime", "apex"],
    "pong_full": ["--config", "apex", "--runtime", "apex", "--host-env",
                  "pong", "--device-sampling", "--num-actors", "8",
                  "--envs-per-actor", "8", "--total-env-steps", "4000",
                  "--save-every-frames", "1000", "--eval-every-steps",
                  "0", "--checkpoint-dir", "CKPT", "--profile-dir", "PROF",
                  "--no-wire-dedup", "--shm-batch", "4"],
    "ignored_flags": ["--config", "apex", "--runtime", "apex", "--host-env",
                      "breakout", "--stop-at-return", "5",
                      "--no-double-buffer", "--no-pipeline", "--per",
                      "--prefetch-depth", "3", "--mesh-devices", "2",
                      "--actor-dtype", "bfloat16", "--eval-every-steps",
                      "500", "--population", "2"],
    # Flags once refused, since ported (the distributed ones in
    # tests/test_torch_apex_distributed.py).
    "unported_flags_reach_the_config": [
        "--config", "apex", "--runtime", "apex", "--learner-devices", "2",
        "--ingest-shards", "2", "--shard-sampling", "--no-actor-priorities",
        "--tcp-port", "0", "--num-remote-actors", "1",
        "--remote-actor-mode", "external", "--transport", "legacy",
        "--checkpoint-replay"],
}


@pytest.mark.parametrize("case", list(_CLI_CASES))
def test_apex_cli_lines_and_config_match_jax(case, monkeypatch, capsys,
                                             tmp_path):
    import dist_dqn_tpu.actors.service as jservice
    from dist_dqn_tpu import train as jtrain
    from dist_dqn_tpu_torch import train as ttrain

    argv = [str(tmp_path / a) if a in ("CKPT", "PROF") else a
            for a in _CLI_CASES[case]]
    jax_rt = []
    monkeypatch.setattr(jservice, "run_apex",
                        lambda cfg, rt, **_: jax_rt.append((cfg, rt)) or {})
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--platform", "cpu"])
    jtrain.main()
    want = _comment_lines(capsys.readouterr().out)
    _Stub.seen = []
    monkeypatch.setattr(tservice, "ApexLearnerService", _Stub)
    ttrain.main([*argv, "--device", "cpu"])
    got = _comment_lines(capsys.readouterr().out)
    assert got == want
    (jcfg, jrt), = jax_rt
    (tcfg, trt), = _Stub.seen
    assert dataclasses.asdict(trt) == dataclasses.asdict(jrt)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_fused_cli_prints_the_apex_flags_line(monkeypatch, capsys):
    """Apex-only flags under the fused runtime: the JAX CLI's line."""
    from dist_dqn_tpu import train as jtrain
    from dist_dqn_tpu_torch import train as ttrain

    flags = ["--config", "cartpole", "--no-wire-dedup", "--shm-batch", "2",
             "--total-env-steps", "100"]
    monkeypatch.setattr(jtrain, "train", lambda *a, **k: (None, []))
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--platform", "cpu"])
    jtrain.main()
    want = _comment_lines(capsys.readouterr().out)
    monkeypatch.setattr(ttrain, "train", lambda *a, **k: (None, []))
    ttrain.main([*flags, "--device", "cpu"])
    got = _comment_lines(capsys.readouterr().out)
    assert got == want and any("--runtime apex only" in g for g in got)


def _tiny_cfg(name="cartpole"):
    return tconfig.apply_overrides(tconfig.CONFIGS[name], [
        "network.torso=mlp", "network.mlp_features=(16,)", "network.hidden=0",
        "network.compute_dtype=float32", "replay.capacity=1024",
        "replay.min_fill=64", "learner.batch_size=16"])


_VALUE_ERRORS = {
    "zero_shards": dict(ingest_shards=0),
    "zero_shm_batch": dict(shm_batch=0),
    "shard_sampling_one_shard": dict(shard_sampling=True),
    "legacy_device_sampling": dict(transport="legacy", device_sampling=True),
    "device_and_shard_sampling": dict(ingest_shards=2, shard_sampling=True,
                                      device_sampling=True),
    "shards_without_attribution": dict(ingest_shards=2,
                                       actor_priorities=False),
}


@pytest.mark.parametrize("case", list(_VALUE_ERRORS))
def test_constructor_refusals_match_jax_word_for_word(case):
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors.service import ApexLearnerService as JService
    from dist_dqn_tpu.actors.service import ApexRuntimeConfig as JRt

    kw = _VALUE_ERRORS[case]
    jlog, tlog = [], []
    with pytest.raises(ValueError) as want:
        JService(jconfig.CONFIGS["cartpole"], JRt(**kw), log_fn=jlog.append)
    with pytest.raises(ValueError) as got:
        tservice.ApexLearnerService(_tiny_cfg(),
                                    tservice.ApexRuntimeConfig(**kw),
                                    log_fn=tlog.append, device="cpu")
    assert str(got.value) == str(want.value)
    assert tlog == jlog


# The options once refused beside ``trace_path`` (ROADMAP.md A10b), since
# ported: the distributed options (A6c), the telemetry endpoint (A10a) and
# the host-loop trace itself. Each case runs the service with its option
# and ``trace_path`` (one actor, two beside two shards, 800 CartPole
# steps, in a process of its own: the learner ranks join a process group)
# and writes a trace.
_UNPORTED = {
    "learner_devices": dict(learner_devices=2),
    "ingest_shards": dict(ingest_shards=2, shard_sampling=True,
                          num_actors=2),
    "trace_path": {},
    "telemetry": dict(telemetry_port=0),
}


@pytest.mark.parametrize("case", list(_UNPORTED))
def test_unported_options_raise_naming_their_item(case, tmp_path):
    """Each option once refused with ``trace_path`` now runs with it: the
    trace loads as JSON with the service's spans, the option took effect,
    and the summary carries the program table and the ledger."""
    kw = _UNPORTED[case]
    path = tmp_path / "t.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_telemetry_workers.py"),
         "torch", str(path), json.dumps(kw)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    s = out["summary"]
    assert s["env_steps"] >= 800 and s["grad_steps"] > 0
    names = {e["name"] for e in json.load(open(path))}
    assert {"process_name", "ingest.shm_record", "act.batched",
            "train_step.dispatch", "replay_size"} <= names
    assert set(out["trace_names"]) == names
    assert s["programs"]["apex.train_step"]["dispatches"] == \
        s["device_calls"]["train"]
    assert s["chip_time"]["chunks"] >= 1.0
    if case == "learner_devices":
        assert s["learner_devices"] == 2 and s["learner_replicas_equal"]
    elif case == "ingest_shards":
        assert s["shard_sampling"] and len(s["records_by_shard"]) == 2


def test_telemetry_port_serves_the_service_registry():
    """``telemetry_port=0`` (ported in A10a) binds after the build, logs
    the bound port, serves the service's families while it lives, and
    closes with ``shutdown``."""
    import urllib.request

    logs = []
    svc = tservice.ApexLearnerService(
        _tiny_cfg(), tservice.ApexRuntimeConfig(telemetry_port=0),
        log_fn=logs.append, device="cpu")
    try:
        port = json.loads(logs[-1])["telemetry_port"]
        url = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(url + "/metrics",
                                      timeout=10).read().decode()
        assert "dqn_ingest_shards 1" in text
        assert 'dqn_learner_replay_ratio{loop="apex"} 1' in text
        assert urllib.request.urlopen(url + "/healthz",
                                      timeout=10).read() == b"ok\n"
    finally:
        svc.shutdown()
    with pytest.raises(OSError):
        urllib.request.urlopen(url + "/healthz", timeout=5)


_PORTED = {
    "remote_actors": dict(num_remote_actors=1),
    "tcp_port": dict(tcp_port=0),
    "legacy": dict(transport="legacy"),
    "bootstrap": dict(actor_priorities=False),
    "checkpoint_replay": dict(checkpoint_replay=True),
    "feeder": dict(host_env="feeder:pixel"),
    "shm_batch": dict(host_env="feeder:vector", shm_batch=4),
}


@pytest.mark.parametrize("case", list(_PORTED))
def test_ported_options_build_their_paths(case, tmp_path):
    """The options ROADMAP.md A8 items 1, 2, 4 and 6 refused until they
    were ported build the JAX service's paths (the same attributes and slot
    sizes on both), and a shutdown leaves no segment and no listener thread
    behind."""
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors.service import ApexLearnerService as JService
    from dist_dqn_tpu.actors.service import ApexRuntimeConfig as JRt
    kw = dict(_PORTED[case])
    if case == "checkpoint_replay":
        kw["checkpoint_dir"] = str(tmp_path / "ours")
    ours = tservice.ApexLearnerService(
        _tiny_cfg(), tservice.ApexRuntimeConfig(**kw), log_fn=lambda s: None,
        device="cpu")
    if case == "checkpoint_replay":
        kw["checkpoint_dir"] = str(tmp_path / "theirs")
    theirs = JService(jconfig.CONFIGS["cartpole"], JRt(**kw),
                      log_fn=lambda s: None)
    try:
        assert ours.total_actors == theirs.total_actors
        assert (ours.tcp_server is None) == (theirs.tcp_server is None)
        if ours.tcp_server is not None:
            assert ours.tcp_address[0] == theirs.tcp_address[0]
            assert ours.tcp_address[1] > 0
        assert bool(ours._zc_rings) == bool(theirs._zc_rings)
        assert [r.slot_size for r in ours._zc_rings.values()] == \
            [r.slot_size for r in theirs._zc_rings.values()]
        assert ours.num_actions == theirs.num_actions
        assert ours.actor_prio == (theirs._act_q is not None)
        assert bool(ours._fused) == (theirs._fused is not None)
        native = type(theirs.assemblers[0]).__name__ == "NativeNStepAssembler"
        assert ours.assembler_kind == ("native" if native else "python")
        assert [type(a).__name__ for a in ours.assemblers] == \
            [type(a).__name__ for a in theirs.assemblers]
        np.testing.assert_array_equal(ours.actor_eps, theirs.actor_eps)
        if case == "checkpoint_replay":
            assert ours._replay_snapshot_path().endswith(
                os.path.join("ours", "replay_shard.npz"))
            assert os.path.basename(ours._replay_snapshot_path()) == \
                os.path.basename(theirs._replay_snapshot_path())
    finally:
        ours.shutdown()
        theirs.shutdown()
    # Other test workers share the shared-memory directory: look for this
    # run's own names only.
    assert not ours.run_dir.exists()
    if os.path.isdir("/dev/shm"):
        assert not [n for n in os.listdir("/dev/shm")
                    if n.startswith(f"req_{ours.run_id}")]
    if ours.tcp_server is not None:
        threads = ours.tcp_server._threads + [ours.tcp_server._thread]
        assert not any(t.is_alive() for t in threads)


def test_recurrent_config_builds_the_sequence_path():
    """A recurrent config (r2d2 at full width, on the numpy Pong) builds
    the JAX service's sequence path: the sequence assembler at L = burn-in
    + unroll + n, the stride, min_fill and the cadence in sequences, no
    actor priorities and no bootstrap."""
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors.service import ApexLearnerService as JService
    from dist_dqn_tpu.actors.service import ApexRuntimeConfig as JRt

    kw = dict(host_env="pong", num_actors=2, envs_per_actor=3)
    ours = tservice.ApexLearnerService(
        tconfig.CONFIGS["r2d2"], tservice.ApexRuntimeConfig(**kw),
        log_fn=lambda s: None, device="cpu")
    theirs = JService(jconfig.CONFIGS["r2d2"], JRt(**kw),
                      log_fn=lambda s: None)
    try:
        assert ours.recurrent and theirs.recurrent
        assert ours.seq_len == theirs.seq_len == 125
        a, b = ours.assemblers[0], theirs.assemblers[0]
        assert type(a).__name__ == type(b).__name__ == "SequenceAssembler"
        assert (a.L, a.stride, len(a.lanes)) == (b.L, b.stride,
                                                 len(b.lanes)) == (125, 40, 3)
        assert ours._min_fill_items() == theirs._min_fill_items() == 128
        assert ours._inserts_per_grad() == theirs._inserts_per_grad() == 1
        assert not ours.actor_prio and theirs._act_q is None
        assert ours._prio_fn is None and theirs._prio_fn is None
        assert ours.replay_ratio == theirs.replay_ratio == 1
    finally:
        ours.shutdown()
        theirs.shutdown()


class _LockstepActor:
    """One actor of the service-glue parity test, in-process: the port's
    ``run_actor`` steps (hello, then one zero-copy step record per act
    reply), with the record handed to both services by the test."""

    def __init__(self, actor_id, lanes, seed, dedup):
        from dist_dqn_tpu_torch import ingest as tingest
        from dist_dqn_tpu_torch.actors import actor as tactor
        from dist_dqn_tpu_torch.actors.transport import encode_arrays
        from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env

        self.id, self.t = actor_id, 0
        self.env = make_host_env("synthstack", lanes, seed=seed)
        obs = self.env.reset()
        # The lanes start 15 to 30 steps short of synthstack's 400-step
        # truncation, so the stream carries truncated windows, whose
        # bootstrap is their in-band boot_q.
        for k, lane in enumerate(self.env.envs):
            lane._t = 370 + 5 * k
        schema = tingest.step_schema(obs.shape[1:], obs.dtype, lanes)
        fs = tactor._negotiate_dedup(self.env, obs, "zerocopy", dedup)
        self.enc = (tingest.DedupStepEncoder(schema, fs) if fs
                    else tingest.StepEncoder(schema))
        self.record = encode_arrays({"obs": obs}, tactor._hello_meta(
            actor_id, 0, "zerocopy", schema, dedup_stack=fs))

    def answer(self, reply):
        from dist_dqn_tpu_torch import ingest as tingest
        from dist_dqn_tpu_torch.actors.actor import _step_and_encode_zc

        actions, q_sel, q_max, hdr = tingest.decode_reply(reply)
        _, self.t, payload = _step_and_encode_zc(
            self.env, actions, self.enc, self.id, self.t, hdr["shard"],
            q_sel, q_max, params_version=hdr["params_version"])
        self.record = bytes(payload)


def _fake_act(num_actions, obs_size):
    """A deterministic numpy stand-in for the act program (the two
    packages' networks are initialised differently): a fixed linear q,
    greedy unless the row's epsilon is above a per-row threshold."""
    w = np.random.default_rng(11).normal(
        size=(obs_size, num_actions)).astype(np.float32)

    def act(obs, eps):
        n = obs.shape[0]
        q = (obs.reshape(n, -1).astype(np.float32) / 255.0) @ w
        rows = np.arange(n)
        explore = (rows * 37 % 100) / 100.0 < eps
        actions = np.where(explore, (rows + 1) % num_actions,
                           q.argmax(1)).astype(np.int32)
        return actions, q[rows, actions], q.max(1)

    return act


def _fake_train(log):
    """A numpy stand-in for the train step: priorities from the batch and
    its IS weights, so the write-back values follow the draws."""
    def step(obs, reward, discount, weights):
        obs, weights = np.asarray(obs), np.asarray(weights, np.float32)
        log.append(weights)
        n = obs.shape[0]
        return (np.abs(np.asarray(reward, np.float32))
                + np.asarray(discount, np.float32) * weights * 0.5
                + obs.reshape(n, -1).mean(1).astype(np.float32) / 255.0)
    return step


@pytest.mark.parametrize("wire_dedup,stage_depth", [(True, 2), (False, 0)])
def test_actor_priorities_fold_like_the_jax_service(wire_dedup,
                                                     stage_depth):
    """The service's own ingest and learning glue against the JAX
    service's, on the same record stream from three lock-step actors
    (one restarts mid-stream), with both acts and both train steps
    replaced by the same numpy functions: ``_handle_record`` (dedup or
    plain decode, the n-step assembler, episode returns),
    ``_flush_act_queue`` (one padded bucket; each request's q_max rows
    filed under its id; the replies), ``_insert_actor_prio`` (|q_start -
    (R + discount * boot)|, the ``_last_flush_q`` stand-in at the end),
    the learner cadence, the beta anneal, the pipelined, batched and
    generation-guarded write-back, and the epsilon ladder. Every reply,
    IS weight, stored item, priority, generation and counter is equal,
    bit for bit, the two wire lineage lanes each store stamps on its
    items included; the port's train batch selects its fields, so the
    lanes never reach the card."""
    import jax.numpy as jnp
    import torch

    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors import service as jservice
    from dist_dqn_tpu.replay import host as jhost
    from dist_dqn_tpu_torch.replay import host as thost

    overrides = ["seed=5", "network.torso=mlp", "network.mlp_features=(16,)",
                 "network.hidden=0", "network.compute_dtype=float32",
                 "replay.capacity=128", "replay.min_fill=48",
                 "learner.batch_size=16", "learner.n_step=3"]
    rt_kw = dict(host_env="synthstack", num_actors=3, envs_per_actor=4,
                 total_env_steps=2000, inserts_per_grad_step=4,
                 pipeline_depth=2, prio_writeback_batch=3,
                 stage_depth=stage_depth, wire_dedup=wire_dedup)
    ours = tservice.ApexLearnerService(
        tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], overrides),
        tservice.ApexRuntimeConfig(**rt_kw), log_fn=lambda s: None,
        device="cpu")
    theirs = None
    try:
        theirs = jservice.ApexLearnerService(
            jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], overrides),
            jservice.ApexRuntimeConfig(**rt_kw), log_fn=lambda s: None)
        # The numpy tree on both sides: JAX's C++ tree does not compile
        # with g++ 12, and the port's agrees with numpy to rtol 1e-12 only.
        theirs.replay.tree = jhost.SumTree(128)
        ours.replay.tree = thost.SumTree(128)
        act = _fake_act(4, 8 * 8 * 4)
        our_w, their_w = [], []
        our_train, their_train = _fake_train(our_w), _fake_train(their_w)

        def our_act(net, obs, generator, eps):
            return tuple(torch.from_numpy(x)
                         for x in act(obs.numpy(), eps.numpy()))

        def our_step(state, batch, weights):
            p = our_train(batch.obs, batch.reward, batch.discount, weights)
            return state, {"priorities": torch.from_numpy(p),
                           "loss": torch.tensor(float(p.mean()))}

        def their_step(state, batch, weights):
            p = their_train(batch.obs, batch.reward, batch.discount, weights)
            return state, {"priorities": jnp.asarray(p),
                           "loss": jnp.float32(p.mean())}

        ours._act_q = our_act
        ours._train_step = our_step
        theirs._act_q = lambda params, obs, key, eps: act(np.asarray(obs),
                                                          np.asarray(eps))
        theirs._train_step = their_step

        rng = np.random.default_rng(2)
        actors = [_LockstepActor(i, 4, 100 + i, wire_dedup)
                  for i in range(3)]
        for p in range(150):
            if p == 70:     # a restart: a fresh hello resets the lanes
                actors[1] = _LockstepActor(1, 4, 999, wire_dedup)
            batch = list(rng.permutation(3)[:rng.integers(1, 4)])
            for svc in (ours, theirs):
                for i in batch:
                    svc._handle_record(actors[i].record,
                                       transport_kind="shm")
            if p == 149:    # the loop ends between drain and flush
                break
            for svc in (ours, theirs):
                svc._flush_act_queue()
                svc._insert_actor_prio()
                svc._maybe_train()
            for i in batch:
                got, want = (svc.act_boxes[i].read() for svc in (ours,
                                                                 theirs))
                assert got == want and got[1] == actors[i].t + 1
                actors[i].answer(got[0])
        for svc in (ours, theirs):
            svc._insert_actor_prio()
            svc._finalize_all_train()

        np.testing.assert_array_equal(ours.actor_eps, theirs.actor_eps)
        assert ours.grad_steps == theirs.grad_steps >= 40
        assert len(our_w) == len(their_w) == ours.grad_steps
        for a, b in zip(our_w, their_w):
            np.testing.assert_array_equal(a, b)
        assert ours.env_steps == theirs.env_steps
        assert ours.episodes_completed == theirs.episodes_completed > 0
        assert list(ours._ep_returns) == list(theirs._ep_returns)
        assert ours.device_calls == theirs.device_calls
        assert ours.router.records_by_shard == theirs.router.records_by_shard
        assert (ours.router.bytes_by_transport
                == theirs.router.bytes_by_transport)
        a, b = ours.replay, theirs.replay
        assert set(a._data) == set(b._data) >= {
            "lineage_birth_time", "lineage_params_version"}
        assert (a._data["lineage_birth_time"] > 0).any()
        for k in a._data:
            assert a._data[k].dtype == b._data[k].dtype, k
            np.testing.assert_array_equal(a._data[k], b._data[k], err_msg=k)
        np.testing.assert_array_equal(a.tree.tree, b.tree.tree)
        np.testing.assert_array_equal(a._slot_gen, b._slot_gen)
        assert a._slot_gen.max() > 1        # the ring wrapped
        assert (a._pos, a._size, a.added, a.sampled, a._max_priority) == (
            b._pos, b._size, b.added, b.sampled, b._max_priority)
        assert a.added_by_shard == b.added_by_shard
        # The train batch holds the five device fields only.
        host, _ = ours._host_batch(8, 0.4)
        assert type(host[0])._fields == ("obs", "action", "reward",
                                         "discount", "next_obs")
    finally:
        ours.shutdown()
        if theirs is not None:
            theirs.shutdown()
    assert not ours.run_dir.exists()


_LINEAGE = ("lineage_birth_time", "lineage_params_version")


def _lineage_items(rng, n, t):
    return {"obs": rng.integers(0, 9, (n, 3)).astype(np.uint8),
            "action": rng.integers(0, 2, n).astype(np.int32),
            "lineage_birth_time": np.full(n, 1722470400.5 + t),
            "lineage_params_version": np.full(n, 40 + t, np.int64)}


def test_store_lineage_lanes_ride_add_sample_snapshot_and_reshard():
    """One stamped record stream into the port's store and JAX's: the
    lineage lanes ride add, sample, snapshot and a two-shard reshard
    equal in both, bit for bit; a snapshot without lineage lanes still
    restores, and the restored store takes stamped adds without growing
    them."""
    from dist_dqn_tpu.replay import host as jhost
    from dist_dqn_tpu.replay import sharded as jsharded
    from dist_dqn_tpu_torch.replay import host as thost
    from dist_dqn_tpu_torch.replay import sharded as tsharded

    stores = [thost.PrioritizedHostReplay(64, seed=3, native=False),
              jhost.PrioritizedHostReplay(64, seed=3, native=False)]
    for store in stores:
        rng = np.random.default_rng(5)
        for t in range(12):
            store.add(_lineage_items(rng, 8, t),
                      priorities=rng.random(8) + 0.1)
    draws = [s.sample(16, 0.4) for s in stores]
    for k in _LINEAGE:
        np.testing.assert_array_equal(draws[0][0][k], draws[1][0][k])
        np.testing.assert_array_equal(stores[0]._data[k],
                                      stores[1]._data[k])
    snaps = [s.state_dict() for s in stores]
    assert set(snaps[0]) == set(snaps[1])
    for k in _LINEAGE:
        np.testing.assert_array_equal(snaps[0][f"data.{k}"],
                                      snaps[1][f"data.{k}"])
    resharded = [tsharded.ShardedPrioritizedReplay(2, 64, seed=3,
                                                   native=False),
                 jsharded.ShardedPrioritizedReplay(2, 64, seed=3,
                                                   native=False)]
    ev = [mod.restore_replay_snapshot(r, s) for mod, r, s in zip(
        (tsharded, jsharded), resharded, snaps)]
    assert ev[0] == ev[1] and ev[0]["resharded"]
    for i in range(2):
        for k in _LINEAGE:
            np.testing.assert_array_equal(
                resharded[0].shards[i]._data[k],
                resharded[1].shards[i]._data[k])
    # A snapshot from before the stamps restores and stays lane-free.
    lane_free = {k: v for k, v in snaps[0].items()
                 if not k.startswith("data.lineage_")}
    old = thost.PrioritizedHostReplay(64, seed=3, native=False)
    old.load_state_dict(lane_free)
    old.add(_lineage_items(np.random.default_rng(6), 4, 99))
    assert set(old._data) == {"obs", "action"}
    items, _, _ = old.sample(4, 0.4)
    assert set(items) == {"obs", "action"}


_PONG_TINY = ["--config", "apex", "--host-env", "pong",
              "--set", "network.torso=small", "--set", "network.hidden=16",
              "--set", "network.compute_dtype=float32"]
_E2E = {
    "synthstack": ["--config", "cartpole", "--host-env", "synthstack",
                   "--set", "network.mlp_features=(32,)",
                   "--eval-every-steps", "300"],
    "pong": [*_PONG_TINY, "--device-sampling", "--profile-dir", "PROF"],
    "pong_ratio2": [*_PONG_TINY, "--replay-ratio", "2"],
}


@pytest.mark.parametrize("env_name", list(_E2E))
def test_apex_cli_runs_end_to_end_on_the_cpu(env_name, tmp_path):
    """One actor process of four lanes, 600 env steps, through ``python -m
    dist_dqn_tpu_torch.train --runtime apex --device cpu``: the JAX
    package's plumbing invariants, scaled to the run."""
    ckpt = str(tmp_path / "ckpt")
    argv = [sys.executable, "-m", "dist_dqn_tpu_torch.train",
            "--runtime", "apex", "--device", "cpu", "--num-actors", "1",
            "--envs-per-actor", "4", "--total-env-steps", "600",
            "--checkpoint-dir", ckpt,
            *(str(tmp_path / "prof") if a == "PROF" else a
              for a in _E2E[env_name]),
            "--set", "replay.capacity=2048", "--set", "replay.min_fill=128",
            "--set", "learner.batch_size=16"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    rows = [json.loads(line) for line in lines[:-1]
            if line.startswith("{")]
    assert out["env_steps"] >= 600
    assert out["replay_size"] > 400
    assert out["grad_steps"] >= 1
    assert out["ring_dropped"] == 0 and out["bad_records"] == 0
    assert out["ingest_torn_reads"] == 0 and out["actor_restarts"] == 0
    assert out["ingest_decode_errors"] == 0
    assert out["transport"] == "zerocopy" and out["actor_priorities"]
    assert out["ingest_device_calls_per_pass"] == 1.0
    assert set(out["device_calls"]) <= {"act", "train", "replay_sample"}
    assert list(out["records_by_shard"]) == ["0"]
    assert out["replay_added_by_shard"] == {"0": out["replay_size"]}
    assert np.isfinite(out["loss"])
    if env_name == "synthstack":
        # Frame-stacked pixels: each frame crossed the wire once.
        assert out["dedup_frames_reused"] > 0
        assert out["dedup_bytes_saved"] > out["bytes_on_wire"]
        evals = [r["eval_return"] for r in rows if "eval_return" in r]
        assert len(evals) == 2 and all(np.isfinite(evals))
    elif env_name == "pong_ratio2":
        assert out["replay_ratio"] == 2 and out["grad_steps"] % 2 == 0
        assert out["device_calls"]["train"] * 2 == out["grad_steps"]
    else:
        # The first train event traced with torch.profiler.
        profiled = [r for r in rows if "profile_trace" in r]
        assert len(profiled) == 1
        assert os.path.exists(profiled[0]["profile_trace"])
        assert out["sampler"] == "device"
        assert out["device_calls"]["replay_sample"] == out["grad_steps"]
        # The learner checkpoint restores through the evaluate CLI.
        ev = subprocess.run(
            [sys.executable, "-m", "dist_dqn_tpu_torch.evaluate", "--config",
             "apex", "--checkpoint-dir", ckpt, "--episodes", "1",
             "--device", "cpu", "--set", "network.torso=small", "--set",
             "network.hidden=16", "--set", "network.compute_dtype=float32"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
        assert ev.returncode == 0, ev.stderr[-3000:]
        row = json.loads(ev.stdout.strip().splitlines()[-1])
        assert row["frames"] == out["env_steps"]
        assert np.isfinite(row["eval_return"])


_ACTOR_SIDE = ("dist_dqn_tpu_torch.actors.actor",
               "dist_dqn_tpu_torch.actors.remote",
               "dist_dqn_tpu_torch.actors.assembler",
               "dist_dqn_tpu_torch.actors.act_dispatch",
               "dist_dqn_tpu_torch.actors.transport",
               "dist_dqn_tpu_torch.ingest",
               "dist_dqn_tpu_torch.envs.gym_adapter",
               "dist_dqn_tpu_torch.envs.host_pong",
               "dist_dqn_tpu_torch.envs.host_breakout",
               "dist_dqn_tpu_torch.utils.host_eval")


def test_actor_side_modules_import_no_torch():
    probe = ("import importlib, sys\n"
             f"for m in {_ACTOR_SIDE!r}:\n"
             "    importlib.import_module(m)\n"
             "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
             "('torch', 'jax', 'dist_dqn_tpu'))\n"
             "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_spawned_actor_process_loads_no_torch():
    """The service starts actors without the parent's ``__main__``: the
    child imports its target's module alone (here the bootstrap only)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "modules.json")
        code = ("import json, sys\n"
                f"json.dump(sorted(k for k in sys.modules if k.split('.')[0]"
                f" in ('torch', 'jax', 'dist_dqn_tpu', 'dist_dqn_tpu_torch',"
                f" 'tests')), open({path!r}, 'w'))\n")
        main = sys.modules["__main__"]
        p = tservice._spawn_process(exec, (code,), {})
        p.join(timeout=60)
        assert p.exitcode == 0
        assert sys.modules["__main__"] is main
        with open(path) as f:
            assert json.load(f) == []


@pytest.mark.slow
def test_apex_split_learns_cartpole():
    """Twin of tests/test_apex_integration.py::test_apex_split_learns_cartpole:
    two actor processes feed the port's service on the CPU, and the greedy
    eval must clearly beat a random CartPole policy (~20 return)."""
    cfg = tconfig.CONFIGS["apex"]
    cfg = dataclasses.replace(
        cfg,
        network=dataclasses.replace(cfg.network, torso="mlp",
                                    mlp_features=(64, 64), hidden=0,
                                    dueling=False, compute_dtype="float32"),
        replay=dataclasses.replace(cfg.replay, capacity=20_000,
                                   min_fill=1_000),
        learner=dataclasses.replace(cfg.learner, batch_size=128, n_step=3,
                                    learning_rate=1e-3,
                                    target_update_period=250))
    rt = tservice.ApexRuntimeConfig(host_env="CartPole-v1", num_actors=2,
                                    envs_per_actor=8, total_env_steps=40_000,
                                    inserts_per_grad_step=8,
                                    eval_every_steps=10_000, eval_episodes=5)
    logs = []
    result = tservice.run_apex(cfg, rt, log_fn=logs.append, device="cpu")
    assert result["grad_steps"] >= 2_000, result
    evals = [json.loads(s)["eval_return"] for s in logs
             if "eval_return" in s]
    assert evals, logs[-3:]
    assert max(evals) >= 100.0, evals
