"""Fused single-device R2D2 training loop (twin of
dist_dqn_tpu/r2d2_loop.py:50-272).

The feed-forward loop's shape (train_loop.py): act -> env step ->
sequence-replay add -> sample -> sequence train step -> priority
write-back, as Python loops and branches over host-int counters where the
JAX package has one ``lax.scan``. What differs is the actor's LSTM carry:
it is threaded through the loop, stored with each step *before* the step
(so learner burn-in starts from the exact acting state) and zeroed for
envs whose episode just ended. Whether a grad step may run is decided from
host ints only (replay/sequence_device.py ``live_start_writes``), so no
iteration waits on the device. ``replay.frame_dedup`` stores single frames
and the sampler rebuilds the windows' stacks. A replay ratio above 1 raises,
as in the JAX loop; the actor acts on the learner's float32 net, and
``network.actor_dtype`` is not read, as the JAX recurrent loop does not
read it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.agents.dqn import LearnerState, broadcast_learner
from dist_dqn_tpu_torch.agents.r2d2 import (make_r2d2_learner,
                                            make_recurrent_actor_step)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.replay import sequence_device as sring
from dist_dqn_tpu_torch.types import SequenceSample
from dist_dqn_tpu_torch.utils import flops
from dist_dqn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class R2D2Carry:
    env_state: NamedTuple
    obs: torch.Tensor
    actor_carry: Tuple[torch.Tensor, torch.Tensor]   # LSTM (c, h) [B, lstm]
    replay: sring.SequenceRingState
    learner: LearnerState
    gen_env: torch.Generator     # env draws (serves, resets)
    gen_act: torch.Generator     # exploration draws
    gen_sample: torch.Generator  # replay draws
    iteration: int               # env vector steps taken
    # Per-env episode trackers and chunk-level accumulators (device).
    ep_return: torch.Tensor      # [B]
    completed_return: torch.Tensor
    completed_count: torch.Tensor
    loss_sum: torch.Tensor
    train_count: int             # grad steps in the current chunk


def _zero_done(carry, done: torch.Tensor):
    """Zero the (c, h) rows of envs whose episode just ended."""
    keep = (~done).float()[:, None]
    return carry[0] * keep, carry[1] * keep


def make_r2d2_train(cfg: ExperimentConfig, env: TorchEnv, net,
                    device=None, axis=None, num_shards: int = 1):
    """Returns (init, run_chunk), the contract of
    ``train_loop.make_fused_train``, for a ``RecurrentQNetwork``.

    With ``axis`` (a ``parallel.mesh.Mesh`` of ``num_shards`` ranks) they
    are one rank's of the mesh, as there (JAX ``r2d2_loop.py:51-136``):
    per-shard env lanes, batch, fill and slots, the rank's own env,
    exploration and replay generators, rank 0's learner on every rank, an
    averaged gradient, global chunk metrics and the max of the new-window
    priority seed over the ranks at each chunk's end (``:231-236``)."""
    dev = resolve_device(device)
    rcfg = cfg.replay
    if rcfg.updates_per_chunk != 1:
        raise ValueError(
            "replay.updates_per_chunk (the replay-ratio scan) is not "
            "supported by the recurrent R2D2 loop; leave it at 1 or use a "
            "feed-forward config")
    seq_len = rcfg.burn_in + rcfg.unroll_length + cfg.learner.n_step
    stride = rcfg.sequence_stride or rcfg.unroll_length
    if axis is not None and axis.size != num_shards:
        raise ValueError(f"num_shards={num_shards} but the mesh has "
                         f"{axis.size} ranks")
    init_learner, train_step = make_r2d2_learner(cfg.learner, rcfg,
                                                 axis=axis)
    act = make_recurrent_actor_step(env.num_actions)
    B, batch_size = loop_common.shard_sizes(cfg, num_shards)
    min_fill = max(rcfg.min_fill // num_shards, 1)
    num_slots = max(rcfg.capacity // (B * num_shards), seq_len + 2)
    if num_slots < seq_len + stride:
        # A seeded start lives num_slots - seq_len + 1 writes and seeds come
        # every `stride` writes; a smaller ring can hold no live start.
        raise ValueError(
            f"sequence ring too small: num_slots={num_slots} < "
            f"seq_len+stride={seq_len + stride}; raise replay.capacity")
    epsilon, beta_at = loop_common.make_schedules(cfg, B, num_shards)
    use_kernel = loop_common.kernel_routing(rcfg.pallas_sampler, dev)
    stack, stored_shape, frame_shape, slice_newest = \
        loop_common.resolve_frame_dedup(rcfg, env, env.observation_shape)
    # Context slots for the oldest start's rebuild, and headroom so a
    # seeded start is never only inside the masked oldest region between
    # two stride seeds.
    num_slots = max(num_slots, seq_len + stride + max(stack - 1, 0))
    flat_storage = loop_common.resolve_flat_storage(
        rcfg, stored_shape, env.observation_dtype, num_slots, B,
        prefer_flat=bool(stack))
    flatten, unflatten = loop_common.flat_obs_codecs(flat_storage,
                                                     stored_shape)
    # Dedup sampling returns rebuilt, unflattened stacks.
    decode = (lambda x: x) if stack else unflatten

    def can_train(replay: sring.SequenceRingState, iteration: int) -> bool:
        # Host ints only: the drawable starts are a function of `writes`.
        return (replay.ring.size * B >= min_fill
                and sring.sequence_ring_can_sample(replay, seq_len)
                and len(sring.live_start_writes(
                    replay.writes, num_slots, seq_len, stride,
                    frame_stack=stack)) > 0
                and iteration % cfg.train_every == 0)

    def init(seed: int) -> R2D2Carry:
        gen_env, gen_act, gen_sample, _ = loop_common.rank_generators(
            seed, dev, 0 if axis is None else axis.rank)
        env_state, obs = env.v_reset(B, gen_env)
        replay = sring.sequence_ring_init(num_slots, B,
                                          flatten(slice_newest(obs))[0],
                                          net.lstm_size,
                                          merge_obs_rows=flat_storage)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        learner = init_learner(net)
        if axis is not None:
            broadcast_learner(learner, axis)
        return R2D2Carry(
            env_state=env_state, obs=obs, actor_carry=net.initial_state(B),
            replay=replay, learner=learner, gen_env=gen_env,
            gen_act=gen_act, gen_sample=gen_sample, iteration=0,
            ep_return=torch.zeros((B,), dtype=torch.float32, device=dev),
            completed_return=zero.clone(), completed_count=zero.clone(),
            loss_sum=zero.clone(), train_count=0)

    def train_event(c: R2D2Carry, beta: float) -> torch.Tensor:
        """``updates_per_train`` grad steps; returns their summed loss."""
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(cfg.updates_per_train):
            s = sring.sequence_ring_sample(
                c.replay, c.gen_sample, batch_size, seq_len,
                rcfg.priority_exponent, beta, use_kernel=use_kernel,
                merge_obs_rows=flat_storage, frame_stack=stack,
                frame_shape=frame_shape)
            s = s._replace(obs=decode(s.obs))
            _, metrics = train_step(c.learner, s)
            sring.sequence_ring_update(c.replay, s.t_idx, s.b_idx,
                                       metrics["priorities"],
                                       eps=rcfg.priority_eps)
            loss = loss + metrics["loss"]
        return loss

    def one_iteration(c: R2D2Carry) -> None:
        new_actor_carry, actions = act(c.learner.net, c.actor_carry, c.obs,
                                       c.gen_act, epsilon(c.iteration))
        c.env_state, out = env.v_step(c.env_state, actions, c.gen_env)
        # Store the *pre-step* carry: the state the actor held entering obs.
        sring.sequence_ring_add(c.replay, flatten(slice_newest(c.obs)),
                                actions, out.reward, out.terminated,
                                out.truncated, c.actor_carry, seq_len,
                                stride, merge_obs_rows=flat_storage)
        # The next act (and the carry stored with it) starts a fresh
        # episode in envs that just finished one.
        done = out.terminated | out.truncated
        c.actor_carry = _zero_done(new_actor_carry, done)
        if can_train(c.replay, c.iteration):
            c.loss_sum = c.loss_sum + train_event(c, beta_at(c.iteration))
            c.train_count += cfg.updates_per_train
        c.ep_return, c.completed_return, c.completed_count = \
            loop_common.episode_stats_update(
                c.ep_return, c.completed_return, c.completed_count,
                out.reward, done)
        c.obs = out.obs
        c.iteration += 1

    def run_chunk(carry: R2D2Carry, num_iters: int
                  ) -> Tuple[R2D2Carry, Dict[str, object]]:
        """Run ``num_iters`` iterations; the chunk accumulators are zeroed
        on entry."""
        carry.completed_return = torch.zeros_like(carry.completed_return)
        carry.completed_count = torch.zeros_like(carry.completed_count)
        carry.loss_sum = torch.zeros_like(carry.loss_sum)
        carry.train_count = 0
        for _ in range(num_iters):
            one_iteration(carry)
        if axis is not None:
            # Keep the fresh-window priority seed replicated (global max).
            carry.replay.max_priority = axis.pmax(carry.replay.max_priority)
        return carry, loop_common.chunk_metrics(carry, B, axis)

    def chunk_cost(carry: R2D2Carry, num_iters: int) -> dict:
        """``train_loop.make_fused_train``'s ``chunk_cost`` for the
        recurrent loop: ``num_iters`` acts and a training chunk's
        ``num_iters * updates_per_train / train_every`` sequence steps,
        each on a [seq_len, S] window of zeros."""
        if axis is not None:
            return {"flops": None, "bytes": None}
        L, S = seq_len, batch_size

        def seq(shape=(), dtype=torch.float32):
            return torch.zeros((L, S, *shape), dtype=dtype, device=dev)

        sample = SequenceSample(
            obs=seq(carry.obs.shape[1:], carry.obs.dtype),
            action=seq(dtype=torch.int64), reward=seq(),
            done=seq(dtype=torch.bool), reset=seq(dtype=torch.bool),
            start_state=carry.learner.net.initial_state(S),
            weights=torch.ones((S,), dtype=torch.float32, device=dev),
            t_idx=torch.zeros((S,), dtype=torch.int64, device=dev),
            b_idx=torch.zeros((S,), dtype=torch.int64, device=dev))
        acting = flops.census(act, carry.learner.net, carry.actor_carry,
                              carry.obs, carry.gen_act,
                              epsilon(carry.iteration))
        training = flops.census(train_step, carry.learner, sample)
        return flops.scaled_sum([
            (num_iters, acting),
            (num_iters * cfg.updates_per_train / max(cfg.train_every, 1),
             training)])

    run_chunk.chunk_cost = chunk_cost
    return init, run_chunk


def make_r2d2_evaluator(cfg: ExperimentConfig, env: TorchEnv,
                        num_episodes: int = 10, epsilon: float = 0.001):
    """Greedy evaluation with the LSTM carry threaded and zeroed at episode
    ends: ``evaluate(net, generator)`` runs ``env.max_steps`` steps, one
    episode per lane, and returns the mean return as a device scalar."""
    act = make_recurrent_actor_step(env.num_actions)

    def evaluate(net, generator: Optional[torch.Generator]) -> torch.Tensor:
        env_state, obs = env.v_reset(num_episodes, generator)
        carry = net.initial_state(num_episodes)
        ret = torch.zeros((num_episodes,), dtype=torch.float32,
                          device=env.device)
        alive = torch.ones_like(ret)
        for _ in range(env.max_steps):
            carry, a = act(net, carry, obs, generator, epsilon)
            env_state, out = env.v_step(env_state, a, generator)
            ret = ret + out.reward * alive
            done = out.terminated | out.truncated
            carry = _zero_done(carry, done)
            alive = ((alive > 0) & ~done).float()
            obs = out.obs
        return ret.mean()

    return evaluate
