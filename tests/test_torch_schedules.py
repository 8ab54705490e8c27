"""Port parity: the fused loop's scaffolding (dist_dqn_tpu_torch/loop_common.py)
and the learner's lr schedules against the JAX package and optax.

The port computes its schedules on the host, in float32, from host-int
counters; they must equal the values the JAX programs compute on device.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_dqn_tpu import config as jconfig
from dist_dqn_tpu import loop_common as jlc
from dist_dqn_tpu_torch import config as tconfig
from dist_dqn_tpu_torch import loop_common as tlc
from dist_dqn_tpu_torch.agents.dqn import make_lr_schedule


def _both(name, **replace):
    jcfg = dataclasses.replace(jconfig.CONFIGS[name], **replace)
    tcfg = dataclasses.replace(tconfig.CONFIGS[name], **replace)
    return jcfg, tcfg


@pytest.mark.parametrize("name", ["cartpole", "apex", "atari"])
def test_epsilon_and_beta_schedules_exact(name):
    jcfg, tcfg = _both(name, total_env_steps=200_000)
    B = jcfg.actor.num_envs
    j_eps, j_beta = jlc.make_schedules(jcfg, B, 1)
    t_eps, t_beta = tlc.make_schedules(tcfg, B)
    for it in (0, 1, 7, 100, 1234, 5000, 12_499, 12_500, 10 ** 6):
        assert t_eps(it) == float(j_eps(jnp.int32(it))), it
        assert t_beta(it) == float(j_beta(jnp.int32(it))), it


@pytest.mark.parametrize("name", ["cartpole", "apex", "atari"])
def test_per_shard_schedules_exact(name):
    """One shard of a 2-shard run: epsilon and beta in per-shard
    iteration units, over the shard's B/2 lanes."""
    jcfg, tcfg = _both(name, total_env_steps=200_000)
    B = jcfg.actor.num_envs // 2
    j_eps, j_beta = jlc.make_schedules(jcfg, B, 2)
    t_eps, t_beta = tlc.make_schedules(tcfg, B, 2)
    for it in (0, 1, 7, 100, 1234, 5000, 12_499, 12_500, 10 ** 6):
        assert t_eps(it) == float(j_eps(jnp.int32(it))), it
        assert t_beta(it) == float(j_beta(jnp.int32(it))), it


@pytest.mark.parametrize("schedule,end", [("constant", 0.0),
                                          ("linear", 1e-5),
                                          ("cosine", 1e-5)])
def test_lr_schedules_match_optax(schedule, end):
    jl = dataclasses.replace(jconfig.CONFIGS["apex"].learner,
                             lr_schedule=schedule, lr_decay_steps=1000,
                             lr_end_value=end)
    tl = tconfig.LearnerConfig(**dataclasses.asdict(jl))
    lr = make_lr_schedule(tl)
    # optax's schedules as dist_dqn_tpu/agents/dqn.py make_optimizer builds
    # them.
    want_fn = {"constant": lambda c: jl.learning_rate,
               "linear": optax.linear_schedule(jl.learning_rate, end, 1000),
               "cosine": optax.cosine_decay_schedule(
                   jl.learning_rate, 1000, end / jl.learning_rate)}[schedule]
    for count in (0, 1, 10, 499, 500, 999, 1000, 5000):
        np.testing.assert_allclose(lr(count),
                                   float(np.float32(want_fn(count))),
                                   rtol=1e-6, err_msg=str(count))


def test_episode_stats_update_exact():
    class Carry:
        pass

    rng = np.random.default_rng(0)
    c = Carry()
    c.ep_return = jnp.asarray(rng.normal(size=8).astype(np.float32))
    c.completed_return = jnp.float32(1.5)
    c.completed_count = jnp.float32(2.0)
    reward = rng.normal(size=8).astype(np.float32)
    done = rng.uniform(size=8) < 0.5
    want = jlc.episode_stats_update(c, jnp.asarray(reward), jnp.asarray(done))
    got = tlc.episode_stats_update(
        torch.from_numpy(np.array(c.ep_return)), torch.tensor(1.5),
        torch.tensor(2.0), torch.from_numpy(reward), torch.from_numpy(done))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["cartpole", "atari", "apex"])
def test_ring_layout_and_batch_resolution_match(name):
    jcfg, tcfg = _both(name)
    B = jcfg.actor.num_envs
    obs_shape = (4,) if name == "cartpole" else (84, 84, 4)
    slots = jcfg.replay.capacity // B
    for store_final in (False, True):
        assert tlc.resolve_flat_storage(
            tcfg.replay, obs_shape,
            torch.float32 if name == "cartpole" else torch.uint8, slots, B,
            store_final=store_final) == jlc.resolve_flat_storage(
            jcfg.replay, obs_shape,
            jnp.float32 if name == "cartpole" else jnp.uint8, slots, B,
            store_final=store_final)
    assert tlc.shard_sizes(tcfg) == jlc.shard_sizes(jcfg, 1)
    for width in (0, 100, 256, 300):
        j = dataclasses.replace(jcfg, replay=dataclasses.replace(
            jcfg.replay, train_batch=width))
        t = dataclasses.replace(tcfg, replay=dataclasses.replace(
            tcfg.replay, train_batch=width))
        assert tlc.resolve_train_batch(t) == jlc.resolve_train_batch(j)


def test_replay_ratio_above_one_is_refused():
    """Where the JAX package has no replay-ratio scan, the recurrent loop,
    a ratio above one is refused; elsewhere the ratio resolves as JAX's
    does, and one below 1 is refused everywhere."""
    from dist_dqn_tpu_torch.envs import make_env
    from dist_dqn_tpu_torch.models import build_network
    from dist_dqn_tpu_torch.r2d2_loop import make_r2d2_train

    for ratio in (1, 2, 4):
        jcfg, tcfg = _both("apex")
        jcfg, tcfg = (dataclasses.replace(c, replay=dataclasses.replace(
            c.replay, updates_per_chunk=ratio)) for c in (jcfg, tcfg))
        assert tlc.resolve_replay_ratio(tcfg) == \
            jlc.resolve_replay_ratio(jcfg) == ratio
    for zero in _both("apex"):
        zero = dataclasses.replace(zero, replay=dataclasses.replace(
            zero.replay, updates_per_chunk=0))
        with pytest.raises(ValueError):
            (tlc if isinstance(zero, tconfig.ExperimentConfig)
             else jlc).resolve_replay_ratio(zero)
    cfg = tconfig.apply_overrides(tconfig.CONFIGS["r2d2"], [
        "env_name=cartpole", "network.torso=mlp", "network.mlp_features=(8,)",
        "network.hidden=0", "network.lstm_size=4", "replay.capacity=256",
        "replay.burn_in=1", "replay.unroll_length=2",
        "replay.sequence_stride=1", "learner.n_step=1",
        "actor.num_envs=2", "replay.updates_per_chunk=2"])
    env = make_env("cartpole", device="cpu")
    net = build_network(cfg.network, env.num_actions, env.observation_shape,
                        device="cpu")
    with pytest.raises(ValueError, match="replay.updates_per_chunk"):
        make_r2d2_train(cfg, env, net, device="cpu")
