"""The Ape-X service's distributed paths in the port (ROADMAP.md A6c)
against the JAX package's:

* ``replay/sharded.py ShardSampleService``: with inserts quiesced its
  batches are the facade's inline draw bit for bit, and the JAX service's
  from the same inserts and seed (items, slot ids, IS weights and
  generations); a dead thread's tombstone; draws under concurrent inserts;
  generations read at draw time (twins of ``tests/test_ingest_dedup.py``);
* ``ingest_shards=2`` in the service: the same record stream from the same
  actor ids lands in the same shards, items, masses and generations as in
  the JAX service's sharded store, and the draws' IS weights are equal;
* ``learner_devices=2``: the service's learner ranks (rank 0 here, one
  spawned CPU rank) against one learner on the same batch (params within
  rtol 1e-5, atol 1e-6; priorities rtol 2e-4, atol 1e-6, in global row
  order) and against JAX's ``make_sharded_train_step`` over two of the
  conftest's eight CPU devices from the same flax weights (the same
  tolerances); the replicas are bit-equal; a bounded CLI run with
  ``--learner-devices 2`` ends with bit-equal replicas;
* ``actors/multihost.py MultihostLearner``: ``agree`` is exact past
  float32's 2**24 with JAX's range texts (twin of
  ``test_agreement_limb_split_exactness``); two processes in which the peer
  dies, or stalls past the timeout, fail fast, and a timed-out learner is
  poisoned (twin of ``test_agree_fails_fast_when_peer_dies``);
* two service processes joined by ``--coordinator`` on the CPU (twins of
  ``tests/test_multihost_apex.py``, DQN and R2D2): equal grad steps, only
  rank 0 logs rows, the agreed global cursor ends the run, bit-equal
  learners, rank 0 alone evaluates; then a relaunch resumes from the saved
  global cursor with each process's ``replay_shard_p<r>.npz``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu.replay import sharded as jsharded
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.replay import host as thost
from dist_dqn_tpu_torch.replay import sharded as tsharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_TOL = dict(rtol=1e-5, atol=1e-6)
PRIO_TOL = dict(rtol=2e-4, atol=1e-6)


# --------------------------------------------------------------------------
# ShardSampleService
# --------------------------------------------------------------------------

def _records(rng, n):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "discount": np.full(n, 0.99, np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32)}


def _filled(mod, seed=0):
    """JAX test_ingest_dedup.py's ``_filled_sharded_replay`` in package
    ``mod``, on numpy trees."""
    r = mod.ShardedPrioritizedReplay(3, 300, alpha=0.6, seed=seed,
                                     native=False)
    rng = np.random.default_rng(7)
    for _ in range(40):
        n = int(rng.integers(1, 9))
        r.add(_records(rng, n), priorities=rng.random(n) + 0.1,
              shard=int(rng.integers(0, 3)))
    return r


def test_shard_sampling_bit_identical_to_facade_draw():
    facade = _filled(tsharded)
    threaded = _filled(tsharded)
    svc = tsharded.ShardSampleService(threaded, depth=1)
    try:
        for k in range(10):
            ia, xa, wa = facade.sample(32, 0.5)
            ib, xb, wb, gb = svc.sample(32, 0.5)
            assert np.array_equal(xa, xb), k
            assert np.array_equal(wa, wb), k
            assert np.array_equal(gb, facade.generation(xa)), k
            for key in ia:
                assert ia[key].tobytes() == ib[key].tobytes(), (k, key)
        assert facade.sampled == threaded.sampled
        assert svc.batches == 10
    finally:
        svc.close()


def test_shard_sampling_matches_the_jax_service():
    """The port's service against JAX's, from identical inserts and seed,
    at depth 2 (two batches drawn ahead): items, slot ids, IS weights and
    generations, bit for bit."""
    ours, theirs = _filled(tsharded), _filled(jsharded)
    a = tsharded.ShardSampleService(ours, depth=2)
    b = jsharded.ShardSampleService(theirs, depth=2)
    try:
        for k in range(8):
            beta = 0.4 + 0.05 * k
            got, want = a.sample(32, beta), b.sample(32, beta)
            for x, y in zip(got[1:], want[1:]):
                assert x.dtype == y.dtype and np.array_equal(x, y), k
            assert set(got[0]) == set(want[0])
            for key in got[0]:
                assert got[0][key].tobytes() == want[0][key].tobytes()
        assert a.batches == b.batches == 8
    finally:
        a.close()
        b.close()


def test_shard_sampling_error_tombstones():
    svc = tsharded.ShardSampleService(
        tsharded.ShardedPrioritizedReplay(2, 100), depth=1)
    try:
        with pytest.raises(tsharded.ShardSamplerError):
            svc.sample(8, 0.5)                  # an empty replay: loud
        with pytest.raises(tsharded.ShardSamplerError):
            svc.sample(8, 0.5)                  # latched, still loud
    finally:
        svc.close()


def test_shard_sampling_under_concurrent_inserts():
    r = _filled(tsharded)
    svc = tsharded.ShardSampleService(r, depth=2)
    stop = threading.Event()

    def adder():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            r.add(_records(rng, 4), priorities=rng.random(4) + 0.1,
                  shard=int(rng.integers(0, 3)))

    th = threading.Thread(target=adder, name="dd-adder", daemon=True)
    th.start()
    try:
        for _ in range(100):
            items, idx, w, gen = svc.sample(32, 0.4)
            assert idx.shape == w.shape == gen.shape == (32,)
            assert np.all(idx >= 0) and np.all(idx < 3 * r.shard_capacity)
            assert np.all(np.isfinite(w)) and items["obs"].shape == (32, 4)
    finally:
        stop.set()
        th.join(timeout=5)
        svc.close()


def test_shard_sampling_generation_snapshotted_at_draw_time():
    """A slot overwritten after the draw and before the learner's write-back
    keeps its draw-time generation, so the guard drops the stale rows."""
    r = _filled(tsharded)
    svc = tsharded.ShardSampleService(r, depth=1)
    try:
        _, idx, _, gen = svc.sample(32, 0.5)
        rng = np.random.default_rng(9)
        for _ in range(200):
            r.add(_records(rng, 8), priorities=rng.random(8) + 0.1,
                  shard=int(rng.integers(0, 3)))
        assert not np.array_equal(gen, r.generation(idx))
        before = [s.tree.get(np.arange(s.capacity, dtype=np.int64))
                  for s in r.shards]
        r.update_priorities(idx, np.full(32, 1e6), expected_gen=gen)
        after = [s.tree.get(np.arange(s.capacity, dtype=np.int64))
                 for s in r.shards]
        for b, a in zip(before, after):
            assert np.array_equal(b, a)         # nothing stamped
    finally:
        svc.close()


# --------------------------------------------------------------------------
# ingest_shards=2 in the service
# --------------------------------------------------------------------------

def test_ingest_shards_place_like_the_jax_service():
    """Three lock-step actors (ids 0, 1, 2: shards 0, 1, 1) feed both
    services with ``ingest_shards=2``, acts and train steps replaced by the
    same numpy functions (tests/test_torch_apex_service.py): every insert
    lands in the same shard, slot and mass, with the same generations, and
    every draw of the sharded facade has the same IS weights."""
    from dist_dqn_tpu import config as jconfig
    from dist_dqn_tpu.actors import service as jservice
    from test_torch_apex_service import (_LockstepActor, _fake_act,
                                         _fake_train)

    overrides = ["seed=5", "network.torso=mlp", "network.mlp_features=(16,)",
                 "network.hidden=0", "network.compute_dtype=float32",
                 "replay.capacity=128", "replay.min_fill=48",
                 "learner.batch_size=16", "learner.n_step=3"]
    rt_kw = dict(host_env="synthstack", num_actors=3, envs_per_actor=4,
                 total_env_steps=2000, inserts_per_grad_step=4,
                 pipeline_depth=2, prio_writeback_batch=3, stage_depth=2,
                 ingest_shards=2)
    ours = tservice.ApexLearnerService(
        tconfig.apply_overrides(tconfig.CONFIGS["cartpole"], overrides),
        tservice.ApexRuntimeConfig(**rt_kw), log_fn=lambda s: None,
        device="cpu")
    theirs = None
    try:
        theirs = jservice.ApexLearnerService(
            jconfig.apply_overrides(jconfig.CONFIGS["cartpole"], overrides),
            jservice.ApexRuntimeConfig(**rt_kw), log_fn=lambda s: None)
        for a, b in zip(ours.replay.shards, theirs.replay.shards):
            a.tree = thost.SumTree(a.capacity)
            b.tree = jhost.SumTree(b.capacity)
        act = _fake_act(4, 8 * 8 * 4)
        our_w, their_w = [], []
        our_train, their_train = _fake_train(our_w), _fake_train(their_w)

        def our_step(state, batch, weights):
            p = our_train(batch.obs, batch.reward, batch.discount, weights)
            return state, {"priorities": torch.from_numpy(p),
                           "loss": torch.tensor(float(p.mean()))}

        def their_step(state, batch, weights):
            p = their_train(batch.obs, batch.reward, batch.discount, weights)
            return state, {"priorities": jnp.asarray(p),
                           "loss": jnp.float32(p.mean())}

        ours._act_q = lambda net, obs, gen, eps: tuple(
            torch.from_numpy(x) for x in act(obs.numpy(), eps.numpy()))
        ours._train_step = our_step
        theirs._act_q = lambda params, obs, key, eps: act(np.asarray(obs),
                                                          np.asarray(eps))
        theirs._train_step = their_step
        rng = np.random.default_rng(2)
        actors = [_LockstepActor(i, 4, 100 + i, True) for i in range(3)]
        for p in range(120):
            batch = list(rng.permutation(3)[:rng.integers(1, 4)])
            for svc in (ours, theirs):
                for i in batch:
                    svc._handle_record(actors[i].record,
                                       transport_kind="shm")
                svc._flush_act_queue()
                svc._insert_actor_prio()
                svc._maybe_train()
            for i in batch:
                got, want = (svc.act_boxes[i].read() for svc in (ours,
                                                                 theirs))
                assert got == want
                actors[i].answer(got[0])
        for svc in (ours, theirs):
            svc._insert_actor_prio()
            svc._finalize_all_train()
        assert [ours.router.shard_for(i) for i in range(3)] == \
            [theirs.router.shard_for(i) for i in range(3)] == [0, 1, 1]
        assert ours.router.records_by_shard == theirs.router.records_by_shard
        assert ours.replay.added_by_shard == theirs.replay.added_by_shard
        assert set(ours.replay.added_by_shard) == {0, 1}
        assert ours.grad_steps == theirs.grad_steps >= 20
        assert len(our_w) == len(their_w) == ours.grad_steps
        for a, b in zip(our_w, their_w):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.replay.shards, theirs.replay.shards):
            for k in a._data:
                np.testing.assert_array_equal(a._data[k], b._data[k])
            np.testing.assert_array_equal(a.tree.tree, b.tree.tree)
            np.testing.assert_array_equal(a._slot_gen, b._slot_gen)
            assert (a._pos, a._size, a.added) == (b._pos, b._size, b.added)
    finally:
        ours.shutdown()
        if theirs is not None:
            theirs.shutdown()


# --------------------------------------------------------------------------
# learner_devices=2: the learner ranks
# --------------------------------------------------------------------------

def test_learner_ranks_step_matches_one_rank_and_jax():
    """One train event of the service's learner ranks (rank 0 in this
    process, rank 1 spawned; 2 x 16 rows) against one learner on the 32
    rows and against JAX's two-device sharded step, from the same flax
    weights (test_torch_mesh.py's dqn case)."""
    from dist_dqn_tpu_torch.actors.learner_ranks import LearnerRanks
    from dist_dqn_tpu_torch.agents.dqn import make_learner
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.types import Transition
    from test_torch_mesh import A, OBS, _feed_forward_case

    case, _, jres = _feed_forward_case("dqn")
    cfg = dataclasses.replace(
        tconfig.CONFIGS["cartpole"],
        network=tconfig.NetworkConfig(**case["network"]),
        learner=tconfig.LearnerConfig(**case["learner"]))

    def learner(axis=None):
        net = build_network(cfg.network, A, (OBS,), device="cpu")
        net.load_state_dict({k: torch.from_numpy(v)
                             for k, v in case["state_dict"].items()})
        init, step = make_learner(cfg.learner, net, axis=axis)
        return init(net), step

    obs, action, reward, discount, next_obs = case["batch"]
    whole, step = learner()
    batch = Transition(torch.from_numpy(obs), torch.from_numpy(action).long(),
                       torch.from_numpy(reward), torch.from_numpy(discount),
                       torch.from_numpy(next_obs))
    whole, m_whole = step(whole, batch, torch.from_numpy(case["weights"]))

    ranks = LearnerRanks(2, torch.device("cpu"))
    try:
        mesh = ranks.start(cfg, A, (OBS,), tservice._spawn_process)
        state, step = learner(mesh)
        ranks.bind(state, step, recurrent=False)
        # The service's layout: one stacked sub-step, [1, B, ...].
        args = (Transition(*(x[None] for x in batch)),
                torch.from_numpy(case["weights"])[None])
        state, m = ranks.train(state, args, scan=True)
        equal = ranks.check(state)
    finally:
        ranks.close(clean=True)
    assert equal
    prios = m["priorities"].reshape(-1).numpy()
    np.testing.assert_allclose(prios, m_whole["priorities"].numpy(),
                               **PRIO_TOL)
    np.testing.assert_allclose(prios, jres["priorities"], **PRIO_TOL)
    np.testing.assert_allclose(float(m["loss"]), float(m_whole["loss"]),
                               rtol=1e-5)
    ours = state.net.state_dict()
    for k, v in whole.net.state_dict().items():
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(),
                                   err_msg=k, **PARAMS_TOL)
        np.testing.assert_allclose(ours[k].numpy(), jres["params"][k],
                                   err_msg=k, **PARAMS_TOL)


def _summary(out: str) -> dict:
    return json.loads([line for line in out.splitlines()
                       if line.startswith('{"env_steps"')][-1])


def _cli(args, timeout=120, **kw):
    return subprocess.run(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout, **kw)


_CARTPOLE = ["--config", "cartpole", "--runtime", "apex", "--host-env",
             "CartPole-v1", "--device", "cpu", "--envs-per-actor", "4",
             "--set", "network.mlp_features=(32,)", "--set",
             "replay.capacity=4096", "--set", "replay.min_fill=128",
             "--set", "learner.batch_size=32", "--set", "learner.n_step=2"]


def test_cli_learner_devices_two_ranks_run():
    """``--learner-devices 2`` on the CPU: the service leads one spawned
    learner rank; the run trains and ends with bit-equal replicas."""
    out = _cli([*_CARTPOLE, "--num-actors", "2", "--total-env-steps", "1600",
                "--learner-devices", "2"])
    assert out.returncode == 0, out.stderr[-3000:]
    s = _summary(out.stdout)
    assert s["learner_devices"] == 2 and s["learner_replicas_equal"] is True
    assert s["grad_steps"] > 0 and np.isfinite(s["loss"])
    assert s["ring_dropped"] == 0 and s["bad_records"] == 0


# --------------------------------------------------------------------------
# MultihostLearner
# --------------------------------------------------------------------------

@pytest.fixture
def solo_group():
    from dist_dqn_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                           device="cpu")
    yield
    distributed.shutdown()


def test_agreement_is_exact_with_the_jax_texts(solo_group):
    from dist_dqn_tpu.actors.multihost import MultihostLearner as JLearner
    from dist_dqn_tpu_torch.actors.multihost import MultihostLearner

    mh, jmh = MultihostLearner(device="cpu"), JLearner()
    vals = np.array([(1 << 37) + 12_345, 0, (1 << 24) + 1], np.int64)
    got = mh.agree(vals)
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(got, jmh.agree(vals))
    for bad in (np.array([1 << 38]), np.array([-1])):
        with pytest.raises(ValueError, match="out of per-host range") as e:
            mh.agree(bad)
        with pytest.raises(ValueError) as want:
            jmh.agree(bad)
        assert str(e.value) == str(want.value)
    mh.nprocs = jmh.nprocs = 2000
    with pytest.raises(ValueError, match="1024 hosts") as e:
        mh.agree(np.array([1]))
    with pytest.raises(ValueError) as want:
        jmh.agree(np.array([1]))
    assert str(e.value) == str(want.value)
    mh.total_devices = jmh.total_devices = 2
    with pytest.raises(ValueError) as e:
        mh.shard_batch_size(33)
    with pytest.raises(ValueError) as want:
        jmh.shard_batch_size(33)
    assert str(e.value) == str(want.value)
    assert mh.shard_batch_size(32) == (16, 16)


_AGREE_WORKER = textwrap.dedent("""
    import os, sys, time
    os.environ["DQN_AGREE_TIMEOUT_S"] = "120"
    sys.path.insert(0, {repo!r})

    def main():
        import numpy as np
        port, pid, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        from dist_dqn_tpu_torch.parallel import distributed
        distributed.initialize(f"127.0.0.1:{{port}}", 2, pid, device="cpu",
                               timeout_s=60)
        from dist_dqn_tpu_torch.actors.multihost import MultihostLearner
        mh = MultihostLearner(device="cpu")
        out = mh.agree(np.array([pid + 1]))
        assert int(out[0]) == 3, out  # both joined round 1
        os.environ["DQN_AGREE_TIMEOUT_S"] = "3"  # the budget under test
        if pid == 0:
            print("P0_EXITING", flush=True)
            if mode == "stalls":
                time.sleep(7)    # alive, but never joins round 2
            os._exit(17)
        t0 = time.perf_counter()
        try:
            mh.agree(np.array([5]))
            print("AGREE_COMPLETED_UNEXPECTEDLY", flush=True)
        except Exception as e:
            print("AGREE_FAILFAST_OK", type(e).__name__,
                  round(time.perf_counter() - t0, 1), flush=True)
            if "incomplete after" in str(e):
                try:
                    mh.agree(np.array([5]))
                    print("POISON_MISSING", flush=True)
                except RuntimeError as e2:
                    print("POISON_OK" if "poisoned" in str(e2)
                          else "POISON_MISSING", flush=True)
        sys.stdout.flush()
        os._exit(0)

    if __name__ == "__main__":
        main()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(script, tmp_path, argv_per_proc, timeout):
    path = tmp_path / "worker.py"
    path.write_text(script.format(repo=REPO))
    procs = [subprocess.Popen([sys.executable, str(path), *map(str, argv)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO)
             for argv in argv_per_proc]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    return procs, outs


@pytest.mark.parametrize("mode", ["dies", "stalls"])
def test_agree_fails_fast_when_peer_dies(tmp_path, mode):
    """Rank 0 leaves between agreements: it dies (its sockets close, so
    rank 1's all-reduce raises at once) or stalls past rank 1's 3 s budget
    (rank 1's agreement times out, and the learner is poisoned: the next
    agree is refused, not issued). Neither hangs."""
    port = _free_port()
    procs, outs = _launch(_AGREE_WORKER, tmp_path,
                          [(port, pid, mode) for pid in range(2)], 90)
    assert procs[0].returncode == 17, outs[0][-2000:]
    assert "P0_EXITING" in outs[0]
    assert "AGREE_FAILFAST_OK" in outs[1], outs[1][-2000:]
    assert "POISON_MISSING" not in outs[1], outs[1][-2000:]
    if mode == "stalls":
        assert "POISON_OK" in outs[1], outs[1][-2000:]


# --------------------------------------------------------------------------
# Two service processes (--coordinator)
# --------------------------------------------------------------------------

_R2D2 = ["--config", "r2d2", "--runtime", "apex", "--host-env",
         "CartPole-v1", "--device", "cpu", "--envs-per-actor", "4",
         *(a for o in ("network.torso=mlp", "network.mlp_features=(32,)",
                       "network.hidden=0", "network.lstm_size=16",
                       "network.dueling=false",
                       "network.compute_dtype=float32",
                       "network.lstm_dtype=float32", "replay.capacity=2048",
                       "replay.min_fill=64", "replay.burn_in=2",
                       "replay.unroll_length=6", "replay.sequence_stride=3",
                       "learner.batch_size=16", "learner.n_step=2")
           for a in ("--set", o))]


def _two_hosts(args, total):
    port = _free_port()
    argv = [*args, "--num-actors", "1", "--total-env-steps", str(total),
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dist_dqn_tpu_torch.train", *argv,
         "--process-id", str(pid)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for p in procs:
            p.kill()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid}:\n{err[-3000:]}"
    return [out for out, _ in outs]


def _hold_lockstep(outs, total, rows=True):
    sums = [_summary(out) for out in outs]
    # Lockstep: both trained the same number of collective steps, from the
    # same agreed counters, and ended with equal learners.
    assert sums[0]["grad_steps"] == sums[1]["grad_steps"] >= 5, sums
    assert sums[0]["global_env_steps"] == sums[1]["global_env_steps"]
    assert sums[0]["global_env_steps"] >= total
    assert all(s["env_steps"] > 0 for s in sums)
    assert all(s["learner_replicas_equal"] is True for s in sums)
    assert all(s["ring_dropped"] == 0 and s["bad_records"] == 0
               for s in sums)
    # Rank 0 reports; rank 1 computes silently.
    assert ('"env_steps_per_sec_per_chip"' in outs[0]) == rows
    assert '"env_steps_per_sec_per_chip"' not in outs[1]
    return sums


def test_two_host_apex_split(tmp_path):
    """The DQN twin, with an async eval on rank 0 and learner saves plus
    each process's replay snapshot; a relaunch to a larger total resumes
    from the saved global cursor with each process's own snapshot."""
    ckpt = str(tmp_path / "ckpt")
    args = [*_CARTPOLE, "--eval-every-steps", "1200", "--checkpoint-dir",
            ckpt, "--checkpoint-replay", "--save-every-frames", "100000"]
    outs = _two_hosts(args, 2400)
    first = _hold_lockstep(outs, 2400)
    assert '"eval_return"' in outs[0] and '"eval_return"' not in outs[1]
    files = sorted(os.listdir(ckpt))
    assert {"replay_shard_p0.npz", "replay_shard_p1.npz"} <= set(files)
    saved = first[0]["global_env_steps"]
    assert str(saved) in files
    outs = _two_hosts([*_CARTPOLE, "--eval-every-steps", "0",
                       "--checkpoint-dir", ckpt, "--checkpoint-replay"],
                      saved + 800)
    # Shorter than a log period, with no eval: no rows on either.
    second = _hold_lockstep(outs, saved + 800, rows=False)
    assert f'{{"resumed_at_env_steps": {saved}}}' in outs[0]
    assert "resumed_at_env_steps" not in outs[1]
    # Local env steps restart at 0; the saved global cursor re-enters the
    # agreement once.
    local = sum(s["env_steps"] for s in second)
    assert saved + 800 <= second[0]["global_env_steps"] <= saved + local
    for pid, s in enumerate(second):
        assert s["env_steps"] < saved
        assert s["replay_snapshot"]["replay_snapshot_restored_items"] == \
            first[pid]["replay_size"]


def test_two_host_apex_r2d2():
    """The same lockstep machinery through the recurrent path: sequence
    batches sharded by process, the act's q-plane priorities; rank 0 alone
    evaluates, threading its own eval carry."""
    outs = _two_hosts([*_R2D2, "--eval-every-steps", "800"], 1600)
    _hold_lockstep(outs, 1600)
    assert '"eval_return"' in outs[0] and '"eval_return"' not in outs[1]
