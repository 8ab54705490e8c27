"""The port's Ape-X service glue on the paths of this slice, against the
JAX service's, in the manner of ``test_actor_priorities_fold_like_the_jax_
service`` (tests/test_torch_apex_service.py): both services take one record
stream from three in-process lock-step actors (one restarts mid-stream,
which re-hellos), with the act, the priority bootstrap and the train step
replaced by the same numpy functions, and every reply, IS weight, stored
item, priority, generation and counter must be equal, bit for bit:

* the learner-side bootstrap on the zero-copy wire (``actor_priorities``
  off): the C++ n-step assembler (the JAX side runs its Python one, which
  the port's C++ one equals exactly), the fused act + bootstrap dispatch,
  the pipelined chunks, the padded buckets; and its split twin
  (``fused_ingest`` off, one dispatch per 256 rows);
* the legacy wire: JSON-header hellos, steps and replies;
* R2D2 on the split: the carry-threaded act (carries concatenated in actor
  order, padded, kept on the host), sequence assembly with reset flags,
  carry zeroing at episode ends and at a re-hello, the act-time sequence
  priorities, the sequence learner's cadence in sequences.

The JAX store also stamps each zero-copy item's wire lineage (telemetry,
ROADMAP.md A10); the port stores no lineage.
"""
import numpy as np
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu.actors import service as jservice
from dist_dqn_tpu.replay import host as jhost
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import ingest as tingest
from dist_dqn_tpu_torch.actors import actor as tactor
from dist_dqn_tpu_torch.actors import service as tservice
from dist_dqn_tpu_torch.actors.transport import decode_arrays, encode_arrays
from dist_dqn_tpu_torch.envs.gym_adapter import make_host_env
from dist_dqn_tpu_torch.replay import host as thost

NUM_ACTIONS = {"synthstack": 4, "CartPole-v1": 2}


class _LockstepActor:
    """One in-process actor: ``record`` is its next record (hello first),
    ``answer(reply)`` steps its env with the reply's actions."""

    def __init__(self, actor_id, env_name, lanes, seed, transport):
        self.id, self.t, self.transport = actor_id, 0, transport
        self.env = make_host_env(env_name, lanes, seed=seed)
        obs = self.env.reset()
        if env_name == "synthstack":
            # Short of synthstack's 400-step truncation: truncated windows.
            for k, lane in enumerate(self.env.envs):
                lane._t = 370 + 5 * k
        self.enc, schema = None, None
        if transport == "zerocopy":
            schema = tingest.step_schema(obs.shape[1:], obs.dtype, lanes)
            fs = tactor._negotiate_dedup(self.env, obs, transport, True)
            self.enc = (tingest.DedupStepEncoder(schema, fs) if fs
                        else tingest.StepEncoder(schema))
            meta = tactor._hello_meta(actor_id, 0, transport, schema,
                                      dedup_stack=fs)
        else:
            meta = tactor._hello_meta(actor_id, 0, transport)
        self.record = encode_arrays({"obs": obs}, meta)

    def answer(self, reply):
        if self.enc is not None:
            actions, q_sel, q_max, hdr = tingest.decode_reply(reply)
            _, self.t, payload = tactor._step_and_encode_zc(
                self.env, actions, self.enc, self.id, self.t, hdr["shard"],
                q_sel, q_max, params_version=hdr["params_version"])
        else:
            actions = decode_arrays(reply)[0]["action"]
            _, self.t, payload = tactor._step_and_encode(
                self.env, actions, self.id, self.t)
        self.record = bytes(payload)


def _q_weights(obs_size, num_actions, seed=11):
    return np.random.default_rng(seed).normal(
        size=(obs_size, num_actions)).astype(np.float32)


def _explore(n, eps, num_actions, greedy):
    rows = np.arange(n)
    explore = (rows * 37 % 100) / 100.0 < eps
    return np.where(explore, (rows + 1) % num_actions,
                    greedy).astype(np.int32)


def _fake_q(w):
    def q(obs):
        n = obs.shape[0]
        return (np.asarray(obs).reshape(n, -1).astype(np.float32) / 255.0) @ w
    return q


def _fake_act(w, num_actions):
    q_of = _fake_q(w)

    def act(obs, eps):
        q = q_of(obs)
        rows = np.arange(q.shape[0])
        actions = _explore(q.shape[0], eps, num_actions, q.argmax(1))
        return actions, q[rows, actions], q.max(1)
    return act


def _fake_prio(w):
    """A numpy stand-in for the bootstrap |Q(s,a) - (r + d max Q(s'))|."""
    q_of = _fake_q(w)

    def prio(obs, action, reward, discount, next_obs):
        q = q_of(obs)
        qa = q[np.arange(q.shape[0]), np.asarray(action, np.int64)]
        boot = q_of(next_obs).max(1) * np.float32(0.5)
        return np.abs(qa - (np.asarray(reward, np.float32)
                            + np.asarray(discount, np.float32) * boot))
    return prio


def _drive(ours, theirs, make_actor, passes=150, restart_at=70):
    rng = np.random.default_rng(2)
    actors = [make_actor(i, 100 + i) for i in range(3)]
    for p in range(passes):
        if p == restart_at:     # a restart: a fresh hello resets the lanes
            actors[1] = make_actor(1, 999)
        batch = list(rng.permutation(3)[:rng.integers(1, 4)])
        for svc in (ours, theirs):
            for i in batch:
                svc._handle_record(actors[i].record, transport_kind="shm")
        if p == passes - 1:     # the loop ends between drain and flush
            break
        for svc in (ours, theirs):
            svc._flush_act_queue()
            svc._insert_actor_prio()
            svc._flush_pending()
            svc._maybe_train()
        for i in batch:
            got, want = (svc.act_boxes[i].read() for svc in (ours, theirs))
            assert got == want and got[1] == actors[i].t + 1
            actors[i].answer(got[0])
    for svc in (ours, theirs):
        svc._insert_actor_prio()
        svc._flush_pending(force=True)
        svc._finalize_all_train()


def _assert_same_state(ours, theirs, min_grad_steps):
    np.testing.assert_array_equal(ours.actor_eps, theirs.actor_eps)
    assert ours.grad_steps == theirs.grad_steps >= min_grad_steps
    assert ours.env_steps == theirs.env_steps
    assert ours.episodes_completed == theirs.episodes_completed > 0
    assert list(ours._ep_returns) == list(theirs._ep_returns)
    assert ours.device_calls == theirs.device_calls
    assert ours.router.records_by_shard == theirs.router.records_by_shard
    assert ours.router.bytes_by_transport == theirs.router.bytes_by_transport
    a, b = ours.replay, theirs.replay
    assert set(b._data) - set(a._data) <= {"lineage_birth_time",
                                           "lineage_params_version"}
    for k in a._data:
        assert a._data[k].dtype == b._data[k].dtype, k
        np.testing.assert_array_equal(a._data[k], b._data[k], err_msg=k)
    np.testing.assert_array_equal(a.tree.tree, b.tree.tree)
    np.testing.assert_array_equal(a._slot_gen, b._slot_gen)
    assert a._slot_gen.max() > 1        # the ring wrapped
    assert (a._pos, a._size, a.added, a.sampled, a._max_priority) == (
        b._pos, b._size, b.added, b.sampled, b._max_priority)
    assert a.added_by_shard == b.added_by_shard


def _services(preset, overrides, rt_kw, their_rt_kw=None):
    ours = tservice.ApexLearnerService(
        tconfig.apply_overrides(tconfig.CONFIGS[preset], overrides),
        tservice.ApexRuntimeConfig(**rt_kw), log_fn=lambda s: None,
        device="cpu")
    try:
        theirs = jservice.ApexLearnerService(
            jconfig.apply_overrides(jconfig.CONFIGS[preset], overrides),
            jservice.ApexRuntimeConfig(**{**rt_kw, **(their_rt_kw or {})}),
            log_fn=lambda s: None)
    except BaseException:
        ours.shutdown()
        raise
    # The numpy tree on both sides: JAX's C++ tree does not compile with
    # g++ 12, and the port's agrees with numpy to rtol 1e-12 only.
    theirs.replay.tree = jhost.SumTree(theirs.replay.capacity)
    ours.replay.tree = thost.SumTree(ours.replay.capacity)
    return ours, theirs


_FF = ["seed=5", "network.torso=mlp", "network.mlp_features=(16,)",
       "network.hidden=0", "network.compute_dtype=float32",
       "replay.capacity=512", "replay.min_fill=48", "learner.batch_size=16",
       "learner.n_step=3"]
_BOOT = {
    "bootstrap_fused": ("synthstack", "zerocopy", True),
    "bootstrap_split": ("synthstack", "zerocopy", False),
    "legacy_wire": ("CartPole-v1", "legacy", True),
}


@pytest.mark.parametrize("case", list(_BOOT))
def test_bootstrap_and_legacy_glue_like_the_jax_service(case):
    env_name, transport, fused = _BOOT[case]
    rt_kw = dict(host_env=env_name, num_actors=3, envs_per_actor=4,
                 total_env_steps=2000, inserts_per_grad_step=4,
                 pipeline_depth=2, prio_writeback_batch=3, stage_depth=2,
                 transport=transport, actor_priorities=False,
                 fused_ingest=fused)
    # The JAX side runs its Python assembler: its C++ one rounds the fold
    # in float (queue C); the port's C++ one equals the Python fold.
    ours, theirs = _services("cartpole", _FF, rt_kw,
                             {"native_assembly": False})
    try:
        assert ours.assembler_kind == "native"
        obs_size = int(np.prod(make_host_env(env_name, 1).reset().shape[1:]))
        num_actions = NUM_ACTIONS[env_name]
        w = _q_weights(obs_size, num_actions)
        act, prio = _fake_act(w, num_actions), _fake_prio(w)
        our_w, their_w = [], []

        def train(log):
            def step(state, batch, weights):
                weights = np.asarray(weights, np.float32)
                log.append(weights)
                obs = np.asarray(batch.obs)
                n = obs.shape[0]
                p = (np.abs(np.asarray(batch.reward, np.float32))
                     + np.asarray(batch.discount, np.float32) * weights * 0.5
                     + obs.reshape(n, -1).mean(1).astype(np.float32) / 255.0)
                return state, p
            return step

        our_train, their_train = train(our_w), train(their_w)

        def our_step(state, batch, weights):
            state, p = our_train(state, batch, weights)
            return state, {"priorities": torch.from_numpy(p),
                           "loss": torch.tensor(float(p.mean()))}

        def their_step(state, batch, weights):
            import jax.numpy as jnp
            state, p = their_train(state, batch, weights)
            return state, {"priorities": jnp.asarray(p),
                           "loss": jnp.float32(p.mean())}

        ours._act_q = lambda net, obs, gen, eps: tuple(
            torch.from_numpy(x) for x in act(obs.numpy(), eps.numpy()))
        ours._prio_fn = lambda net, tnet, *b: torch.from_numpy(
            prio(*(x.numpy() for x in b)))
        ours._train_step = our_step
        theirs._act = lambda params, obs, key, eps: act(
            np.asarray(obs), np.asarray(eps))[0]
        theirs._prio_fn = lambda params, tparams, *b: prio(
            *(np.asarray(x) for x in b))
        if theirs._fused is not None:
            theirs._fused = lambda params, tparams, obs, key, eps, *b: (
                act(np.asarray(obs), np.asarray(eps))[0],
                prio(*(np.asarray(x) for x in b)))
        theirs._train_step = their_step

        _drive(ours, theirs, lambda i, seed: _LockstepActor(
            i, env_name, 4, seed, transport))
        assert len(our_w) == len(their_w) == ours.grad_steps
        for a, b in zip(our_w, their_w):
            np.testing.assert_array_equal(a, b)
        kinds = set(ours.device_calls)
        assert ("fused_act_bootstrap" in kinds) == fused
        assert "bootstrap" in kinds
        _assert_same_state(ours, theirs, 40)
    finally:
        ours.shutdown()
        theirs.shutdown()
    assert not ours.run_dir.exists()


_R2D2 = ["seed=5", "network.torso=mlp", "network.mlp_features=(16,)",
         "network.hidden=0", "network.lstm_size=8", "network.dueling=false",
         "network.compute_dtype=float32", "network.lstm_dtype=float32",
         "replay.capacity=96", "replay.min_fill=64", "replay.burn_in=2",
         "replay.unroll_length=6", "replay.sequence_stride=3",
         "learner.batch_size=8", "learner.n_step=2"]


def test_r2d2_glue_like_the_jax_service():
    rt_kw = dict(host_env="CartPole-v1", num_actors=3, envs_per_actor=4,
                 total_env_steps=2000, inserts_per_grad_step=16,
                 pipeline_depth=2, prio_writeback_batch=3, stage_depth=2)
    ours, theirs = _services("r2d2", _R2D2, rt_kw)
    try:
        lstm = 8
        rng = np.random.default_rng(4)
        wx = rng.normal(size=(4, lstm)).astype(np.float32)
        wq = rng.normal(size=(lstm, 2)).astype(np.float32)

        def ract(c, h, obs, eps):
            c2 = np.tanh(np.float32(0.5) * c + np.asarray(obs) @ wx)
            h2 = np.tanh(c2 + np.float32(0.1) * h)
            q = h2 @ wq
            rows = np.arange(q.shape[0])
            actions = _explore(q.shape[0], np.asarray(eps), 2, q.argmax(1))
            return (c2, h2), actions, q[rows, actions], q.max(1)

        def our_act(net, carry, obs, gen, eps):
            (c, h), a, qs, qm = ract(carry[0].numpy(), carry[1].numpy(),
                                     obs.numpy(), eps.numpy())
            return ((torch.from_numpy(c), torch.from_numpy(h)),
                    torch.from_numpy(a).long(), torch.from_numpy(qs),
                    torch.from_numpy(qm))

        our_w, their_w = [], []

        def train(log):
            def step(state, sample):
                weights = np.asarray(sample.weights, np.float32)
                log.append(weights)
                r = np.asarray(sample.reward, np.float32)[2:8]
                p = (np.abs(r.sum(0)) + weights * np.float32(0.5)
                     + np.asarray(sample.start_state[0]).mean(1)
                     + np.asarray(sample.reset, np.float32).sum(0))
                return state, p
            return step

        our_train, their_train = train(our_w), train(their_w)

        def our_step(state, sample):
            state, p = our_train(state, sample)
            return state, {"priorities": torch.from_numpy(p),
                           "loss": torch.tensor(float(p.mean()))}

        def their_step(state, sample):
            import jax.numpy as jnp
            state, p = their_train(state, sample)
            return state, {"priorities": jnp.asarray(p),
                           "loss": jnp.float32(p.mean())}

        ours._act_rec = our_act
        ours._train_step = our_step
        theirs._act = lambda params, carry, obs, key, eps: ract(
            np.asarray(carry[0]), np.asarray(carry[1]), obs, eps)
        theirs._train_step = their_step

        _drive(ours, theirs, lambda i, seed: _LockstepActor(
            i, "CartPole-v1", 4, seed, "zerocopy"))
        assert len(our_w) == len(their_w) == ours.grad_steps
        for a, b in zip(our_w, their_w):
            np.testing.assert_array_equal(a, b)
        assert ours._min_fill_items() == theirs._min_fill_items() == 16
        assert ours._inserts_per_grad() == theirs._inserts_per_grad() == 2
        for i in range(3):
            for a, b in zip(ours._carry[i], theirs._carry[i]):
                np.testing.assert_array_equal(a, b)
        assert ours.replay._data["reset"].any()
        assert ours.replay._data["state_c"].any()
        _assert_same_state(ours, theirs, 40)
    finally:
        ours.shutdown()
        theirs.shutdown()
