"""Fused single-device training loop (twin of dist_dqn_tpu/train_loop.py:68-374).

Every iteration acts epsilon-greedily, steps the batched on-device env,
appends the time slice to the device ring and — once the ring is filled —
runs a train event: ``updates_per_train × replay.updates_per_chunk`` grad
steps, each on its own batch (PER through the sampler kernel with
``replay.pallas_sampler``), with the priorities written back after each
step, or, under PER with a replay ratio above 1, flushed once after the
last one with chronological last-write-wins. Options of the JAX loop that
ride along: frame-dedup rings (``replay.frame_dedup``: the ring stores
each step's newest frame and the gathers rebuild the stacks), and the
bf16 actor (``network.actor_dtype``: acting reads a bf16 snapshot of the
online net taken at chunk entry). The JAX package compiles this into one
``lax.scan``; here the scan
and the train ``lax.cond`` are Python loops and branches over host-int
counters. Everything per-iteration stays on the device: the chunk
accumulators are device tensors the caller reads once per chunk, and the
only values the host decides on (ring position and size, iteration,
grad-step count) advance deterministically, so no iteration waits on the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.agents.dqn import (LearnerState, make_actor_step,
                                           make_learner)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.replay import device as ring
from dist_dqn_tpu_torch.replay import prioritized_device as pring
from dist_dqn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainCarry:
    env_state: NamedTuple
    obs: torch.Tensor
    replay: object               # TimeRingState or PrioritizedRingState
    learner: LearnerState
    gen_env: torch.Generator     # env draws (serves, resets)
    gen_act: torch.Generator     # exploration (and actor noise) draws
    gen_sample: torch.Generator  # replay draws
    iteration: int               # env vector steps taken
    # Per-env episode trackers and chunk-level accumulators (device).
    ep_return: torch.Tensor      # [B]
    completed_return: torch.Tensor
    completed_count: torch.Tensor
    loss_sum: torch.Tensor
    train_count: int             # grad steps in the current chunk


def make_fused_train(cfg: ExperimentConfig, env: TorchEnv, net,
                     device=None):
    """Returns (init, run_chunk): ``init(seed)`` builds the carry around
    ``net`` (the online Q-network, on ``device``); ``run_chunk(carry,
    num_iters)`` runs ``num_iters`` fused iterations and returns the carry
    and the chunk's metrics as device tensors (``env_frames`` and
    ``grad_steps_in_chunk`` are host ints)."""
    dev = resolve_device(device)
    prioritized = cfg.replay.prioritized
    init_learner, train_step = make_learner(cfg.learner, net)
    act = make_actor_step(env.num_actions)
    replay_ratio = loop_common.resolve_replay_ratio(cfg)
    updates = cfg.updates_per_train * replay_ratio
    # Under PER with a ratio above 1 the sub-steps draw from the event-entry
    # plane and their write-backs land in one last-wins flush; ratio 1 keeps
    # the write-back after every step.
    defer_writeback = prioritized and replay_ratio > 1
    actor_snapshot = loop_common.make_actor_param_cast(
        cfg.network.actor_dtype)
    B, batch_size = loop_common.shard_sizes(cfg)
    min_fill = max(cfg.replay.min_fill, 1)
    num_slots = max(cfg.replay.capacity // B, cfg.learner.n_step + 2)
    n_step = cfg.learner.n_step
    gamma = cfg.learner.gamma
    # Exact truncation bootstrap for cheap (non-pixel) observations; pixel
    # rings skip final_obs to halve their memory (truncation treated as
    # terminal). cfg.replay.store_final_obs overrides the heuristic.
    store_final = (env.observation_dtype != torch.uint8
                   if cfg.replay.store_final_obs is None
                   else cfg.replay.store_final_obs)
    epsilon, beta_at = loop_common.make_schedules(cfg, B)
    use_kernel = loop_common.kernel_routing(
        prioritized and cfg.replay.pallas_sampler, dev)
    stack, stored_shape, frame_shape, slice_newest = \
        loop_common.resolve_frame_dedup(cfg.replay, env,
                                        env.observation_shape,
                                        store_final=store_final)
    # A dedup start needs stack - 1 context slots beyond the n-step window;
    # a smaller ring could never be sampled.
    num_slots = max(num_slots, n_step + max(stack - 1, 0) + 2)
    flat_storage = loop_common.resolve_flat_storage(
        cfg.replay, stored_shape, env.observation_dtype, num_slots, B,
        store_final=store_final, prefer_flat=bool(stack))
    flatten, unflatten = loop_common.flat_obs_codecs(flat_storage,
                                                     stored_shape)
    # Dedup gathers return rebuilt, unflattened stacks.
    decode = (lambda x: x) if stack else unflatten

    def ring_of(replay) -> ring.TimeRingState:
        return replay.ring if prioritized else replay

    def can_train(replay, iteration: int) -> bool:
        r = ring_of(replay)
        return (r.size * B >= min_fill
                and ring.time_ring_can_sample(r, n_step, frame_stack=stack)
                and iteration % cfg.train_every == 0)

    def init(seed: int) -> TrainCarry:
        gen_env, gen_act, gen_sample, gen_learn = loop_common.generators(
            seed, dev, 4)
        env_state, obs = env.v_reset(B, gen_env)
        example = flatten(slice_newest(obs))[0]
        if prioritized:
            replay = pring.prioritized_ring_init(
                num_slots, B, example, store_final_obs=store_final,
                merge_obs_rows=flat_storage)
        else:
            replay = ring.time_ring_init(num_slots, B, example,
                                         store_final_obs=store_final,
                                         merge_obs_rows=flat_storage)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return TrainCarry(
            env_state=env_state, obs=obs, replay=replay,
            learner=init_learner(net, gen_learn), gen_env=gen_env,
            gen_act=gen_act, gen_sample=gen_sample, iteration=0,
            ep_return=torch.zeros((B,), dtype=torch.float32, device=dev),
            completed_return=zero.clone(), completed_count=zero.clone(),
            loss_sum=zero.clone(), train_count=0)

    def train_event(c: TrainCarry, beta: float) -> torch.Tensor:
        """``updates`` grad steps; returns their summed loss (device)."""
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        deferred = []           # (t_idx, b_idx, |td|) of each sub-step
        for _ in range(updates):
            if prioritized:
                s = pring.prioritized_ring_sample(
                    c.replay, c.gen_sample, batch_size, n_step, gamma,
                    cfg.replay.priority_exponent, beta,
                    use_kernel=use_kernel, merge_obs_rows=flat_storage,
                    frame_stack=stack, frame_shape=frame_shape)
                batch = s.batch._replace(obs=decode(s.batch.obs),
                                         next_obs=decode(s.batch.next_obs))
                _, metrics = train_step(c.learner, batch, s.weights)
                if defer_writeback:
                    deferred.append((s.t_idx, s.b_idx, metrics["priorities"]))
                else:
                    pring.prioritized_ring_update(
                        c.replay, s.t_idx, s.b_idx, metrics["priorities"],
                        eps=cfg.replay.priority_eps)
            else:
                batch = ring.time_ring_sample(
                    c.replay, c.gen_sample, batch_size, n_step, gamma,
                    merge_obs_rows=flat_storage, frame_stack=stack,
                    frame_shape=frame_shape)
                batch = batch._replace(obs=decode(batch.obs),
                                       next_obs=decode(batch.next_obs))
                _, metrics = train_step(c.learner, batch)
            loss = loss + metrics["loss"]
        if deferred:
            t_i, b_i, prios = (torch.stack(x) for x in zip(*deferred))
            pring.prioritized_ring_update_batched(
                c.replay, t_i, b_i, prios, eps=cfg.replay.priority_eps)
        return loss

    def one_iteration(c: TrainCarry, actor_net) -> None:
        actions = act(actor_net, c.obs, c.gen_act, epsilon(c.iteration))
        c.env_state, out = env.v_step(c.env_state, actions, c.gen_env)
        add = pring.prioritized_ring_add if prioritized else \
            ring.time_ring_add
        add(c.replay, flatten(slice_newest(c.obs)), actions, out.reward,
            out.terminated, out.truncated,
            final_obs=flatten(out.next_obs) if store_final else None,
            merge_obs_rows=flat_storage)
        if can_train(c.replay, c.iteration):
            c.loss_sum = c.loss_sum + train_event(c, beta_at(c.iteration))
            c.train_count += updates
        done = out.terminated | out.truncated
        c.ep_return, c.completed_return, c.completed_count = \
            loop_common.episode_stats_update(
                c.ep_return, c.completed_return, c.completed_count,
                out.reward, done)
        c.obs = out.obs
        c.iteration += 1

    def run_chunk(carry: TrainCarry, num_iters: int
                  ) -> Tuple[TrainCarry, Dict[str, object]]:
        """Run ``num_iters`` iterations; the chunk accumulators are zeroed
        on entry."""
        carry.completed_return = torch.zeros_like(carry.completed_return)
        carry.completed_count = torch.zeros_like(carry.completed_count)
        carry.loss_sum = torch.zeros_like(carry.loss_sum)
        carry.train_count = 0
        # The bf16 actor reads one snapshot of the chunk-entry net; else the
        # live learner net.
        actor_net = actor_snapshot(carry.learner.net)
        for _ in range(num_iters):
            one_iteration(carry, actor_net)
        return carry, loop_common.chunk_metrics(carry, B)

    return init, run_chunk


def make_evaluator(cfg: ExperimentConfig, env: TorchEnv,
                   num_episodes: int = 10, epsilon: float = 0.001):
    """Greedy-policy evaluation: one episode per env lane.

    A noisy net acts with noise drawn from the generator, as the JAX
    evaluator does (``train_loop.py:352``).
    ``evaluate(net, generator)`` runs ``env.max_steps`` steps under a mask
    that freezes each lane at its first episode end and returns the mean
    undiscounted return as a device scalar.
    """
    act = make_actor_step(env.num_actions)

    def evaluate(net, generator: Optional[torch.Generator]) -> torch.Tensor:
        env_state, obs = env.v_reset(num_episodes, generator)
        ret = torch.zeros((num_episodes,), dtype=torch.float32,
                          device=env.device)
        alive = torch.ones_like(ret)
        for _ in range(env.max_steps):
            a = act(net, obs, generator, epsilon)
            env_state, out = env.v_step(env_state, a, generator)
            ret = ret + out.reward * alive
            done = out.terminated | out.truncated
            alive = ((alive > 0) & ~done).float()
            obs = out.obs
        return ret.mean()

    return evaluate
