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

With ``member_hp`` (the population plane, population.py) the same loop
advances M members at once: the net is a stacked module, every carry leaf
gains a leading member axis (env lanes and obs [M, B, ...], the ring
[M, T, B, ...], the accumulators [M]), each member has its own four
generators, epsilon decays per member (``loop_common.make_member_epsilon``)
and each member's gamma folds its n-step returns. All members fill, train
and evaluate on the same iterations, since those depend on host counters
alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dist_dqn_tpu_torch import loop_common
from dist_dqn_tpu_torch.agents.dqn import (LearnerState, broadcast_learner,
                                           make_actor_step, make_learner,
                                           make_population_optimizer,
                                           set_member_lr)
from dist_dqn_tpu_torch.config import ExperimentConfig
from dist_dqn_tpu_torch.envs.base import TorchEnv
from dist_dqn_tpu_torch.models.qnets import members_of
from dist_dqn_tpu_torch.replay import device as ring
from dist_dqn_tpu_torch.replay import prioritized_device as pring
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils import flops
from dist_dqn_tpu_torch.utils.device import resolve_device


class MemberHP(NamedTuple):
    """Per-member hyperparameters of the population plane (twin of
    dist_dqn_tpu/train_loop.py:35-50): [M] float32 tensors.
    ``eps_delta`` is ``epsilon_start - epsilon_end`` folded on the host in
    float64 then cast to float32 (population.member_hp); ``lr`` is None
    when the members share the config's learning-rate schedule."""

    eps_delta: torch.Tensor
    eps_end: torch.Tensor
    gamma: torch.Tensor
    lr: Optional[torch.Tensor]


@dataclasses.dataclass
class TrainCarry:
    """The fused loop's state. A population's has a leading member axis on
    every tensor and a list of M generators where a solo run has one."""

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
                     device=None, member_hp: Optional[MemberHP] = None,
                     axis=None, num_shards: int = 1):
    """Returns (init, run_chunk): ``init(seed)`` builds the carry around
    ``net`` (the online Q-network, on ``device``); ``run_chunk(carry,
    num_iters)`` runs ``num_iters`` fused iterations and returns the carry
    and the chunk's metrics as device tensors (``env_frames`` and
    ``grad_steps_in_chunk`` are host ints). ``run_chunk.chunk_cost(carry,
    num_iters)`` is the census of a training chunk (the ``fused.chunk``
    program's cost in the program table, telemetry/devtime.py).

    With ``member_hp`` (a population of M), ``net`` is the members' stacked
    net (models.stack_networks), ``init(seeds)`` takes the M members' seeds
    and every tensor metric is [M].

    With ``axis`` (a ``parallel.mesh.Mesh`` of ``num_shards`` ranks) the
    functions are one rank's of the data-parallel mesh
    (parallel/learner.py): sizes are per shard (``train_loop.py:109-121``:
    env lanes and the batch from ``shard_sizes``, ``min_fill //
    num_shards``, ``capacity // (B x num_shards)`` slots), the env,
    exploration and replay generators are the rank's own
    (``loop_common.rank_generators``), the learner starts from rank 0's
    parameters and optimizer state on every rank and averages its
    gradients across them, the chunk metrics are global, and under PER
    the new-item priority seed is the max over the ranks at each chunk's
    end (``train_loop.py:316-321``)."""
    dev = resolve_device(device)
    prioritized = cfg.replay.prioritized
    M = 0 if member_hp is None else int(member_hp.eps_end.shape[0])
    if members_of(net) != M:
        raise ValueError(f"the net stacks {members_of(net)} members, the "
                         f"population has {M}")
    if axis is not None and axis.size != num_shards:
        raise ValueError(f"num_shards={num_shards} but the mesh has "
                         f"{axis.size} ranks")
    rank = 0 if axis is None else axis.rank
    tx = (make_population_optimizer(cfg.learner, M)
          if M and member_hp.lr is not None else None)
    init_learner, train_step = make_learner(cfg.learner, net, tx, axis=axis)
    act = make_actor_step(env.num_actions)
    replay_ratio = loop_common.resolve_replay_ratio(cfg)
    updates = cfg.updates_per_train * replay_ratio
    # Under PER with a ratio above 1 the sub-steps draw from the event-entry
    # plane and their write-backs land in one last-wins flush; ratio 1 keeps
    # the write-back after every step.
    defer_writeback = prioritized and replay_ratio > 1
    actor_snapshot = loop_common.make_actor_param_cast(
        cfg.network.actor_dtype)
    B, batch_size = loop_common.shard_sizes(cfg, num_shards)
    min_fill = max(cfg.replay.min_fill // num_shards, 1)
    num_slots = max(cfg.replay.capacity // (B * num_shards),
                    cfg.learner.n_step + 2)
    n_step = cfg.learner.n_step
    gamma = member_hp.gamma.to(dev) if M else cfg.learner.gamma
    # Exact truncation bootstrap for cheap (non-pixel) observations; pixel
    # rings skip final_obs to halve their memory (truncation treated as
    # terminal). cfg.replay.store_final_obs overrides the heuristic.
    store_final = (env.observation_dtype != torch.uint8
                   if cfg.replay.store_final_obs is None
                   else cfg.replay.store_final_obs)
    epsilon, beta_at = loop_common.make_schedules(cfg, B, num_shards)
    if M:
        # The members' epsilons, an [M] tensor on the device.
        eps_at = loop_common.make_member_epsilon(cfg, B, num_shards)
        eps_lanes = (member_hp.eps_delta.to(dev), member_hp.eps_end.to(dev))

        def epsilon(iteration: int) -> torch.Tensor:
            return eps_at(iteration, *eps_lanes)
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
    if M:
        # Ring inserts take [M, B, ...] obs.
        flatten_lanes = flatten
        flatten = (lambda x: flatten_lanes(x.flatten(0, 1)).unflatten(
            0, (M, B)))
    # Dedup gathers return rebuilt, unflattened stacks.
    decode = (lambda x: x) if stack else unflatten

    def ring_of(replay) -> ring.TimeRingState:
        return replay.ring if prioritized else replay

    def can_train(replay, iteration: int) -> bool:
        r = ring_of(replay)
        return (r.size * B >= min_fill
                and ring.time_ring_can_sample(r, n_step, frame_stack=stack)
                and iteration % cfg.train_every == 0)

    def init(seed) -> TrainCarry:
        if M:
            # Member k's generators are those of a solo run seeded with
            # seed[k].
            gen_env, gen_act, gen_sample, gen_learn = (list(g) for g in zip(
                *(loop_common.generators(s, dev, 4) for s in seed)))
            env_state, obs = env.v_reset_members(B, gen_env)
            example = flatten(slice_newest(obs))[0, 0]
        else:
            gen_env, gen_act, gen_sample, gen_learn = \
                loop_common.rank_generators(seed, dev, rank)
            env_state, obs = env.v_reset(B, gen_env)
            example = flatten(slice_newest(obs))[0]
        if prioritized:
            replay = pring.prioritized_ring_init(
                num_slots, B, example, store_final_obs=store_final,
                merge_obs_rows=flat_storage, members=M)
        else:
            replay = ring.time_ring_init(num_slots, B, example,
                                         store_final_obs=store_final,
                                         merge_obs_rows=flat_storage,
                                         members=M)
        learner = init_learner(net, gen_learn)
        if M and member_hp.lr is not None:
            set_member_lr(learner, member_hp.lr)
        if axis is not None:
            broadcast_learner(learner, axis)
        lead = (M,) if M else ()
        zero = torch.zeros(lead, dtype=torch.float32, device=dev)
        return TrainCarry(
            env_state=env_state, obs=obs, replay=replay,
            learner=learner, gen_env=gen_env,
            gen_act=gen_act, gen_sample=gen_sample, iteration=0,
            ep_return=torch.zeros(lead + (B,), dtype=torch.float32,
                                  device=dev),
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
        step = env.v_step_members if M else env.v_step
        c.env_state, out = step(c.env_state, actions, c.gen_env)
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
        if axis is not None and prioritized:
            # Keep the new-item priority seed replicated (the global max).
            carry.replay.max_priority = axis.pmax(carry.replay.max_priority)
        return carry, loop_common.chunk_metrics(carry, B, axis)

    def chunk_cost(carry: TrainCarry, num_iters: int) -> dict:
        """The census (utils/flops.py) of one training chunk of
        ``num_iters`` iterations, on copies of the carry's learner and
        generators: ``num_iters`` acts and a training chunk's steady
        ``num_iters * updates / train_every`` grad steps, each step on a
        batch of zeros of the sampled batch's shapes. The draw and gather
        (the sampler kernel is bound through ctypes), the ring's writes
        and the env step are not counted. Unknown (None) under a mesh:
        the step's all-reduce cannot run on one rank alone."""
        if axis is not None:
            return {"flops": None, "bytes": None}
        lead = (M,) if M else ()
        obs = carry.obs

        def rows(shape=(), dtype=torch.float32, fill=0):
            return torch.full((*lead, batch_size, *shape), fill,
                              dtype=dtype, device=dev)

        frame = obs.shape[len(lead) + 1:]
        batch = Transition(obs=rows(frame, obs.dtype),
                           action=rows(dtype=torch.int64), reward=rows(),
                           discount=rows(fill=1), next_obs=rows(frame,
                                                                obs.dtype))
        step_args = (carry.learner, batch) + (
            (rows(fill=1),) if prioritized else ())
        acting = flops.census(act, actor_snapshot(carry.learner.net), obs,
                              carry.gen_act, epsilon(carry.iteration))
        training = flops.census(train_step, *step_args)
        return flops.scaled_sum([
            (num_iters, acting),
            (num_iters * updates / max(cfg.train_every, 1), training)])

    run_chunk.chunk_cost = chunk_cost
    return init, run_chunk


def make_evaluator(cfg: ExperimentConfig, env: TorchEnv,
                   num_episodes: int = 10, epsilon: float = 0.001):
    """Greedy-policy evaluation: one episode per env lane.

    A noisy net acts with noise drawn from the generator, as the JAX
    evaluator does (``train_loop.py:352``).
    ``evaluate(net, generator)`` runs ``env.max_steps`` steps under a mask
    that freezes each lane at its first episode end and returns the mean
    undiscounted return as a device scalar. A population's stacked net
    plays every member's episodes at once, member m's draws from
    ``generator[m]`` (the JAX package vmaps this evaluator over the
    members' keys), and returns the [M] members' means.
    """
    act = make_actor_step(env.num_actions)

    def evaluate(net, generator: Optional[torch.Generator]) -> torch.Tensor:
        members = members_of(net)
        if members:
            env_state, obs = env.v_reset_members(num_episodes, generator)
            step = env.v_step_members
        else:
            env_state, obs = env.v_reset(num_episodes, generator)
            step = env.v_step
        lead = (members,) if members else ()
        ret = torch.zeros(lead + (num_episodes,), dtype=torch.float32,
                          device=env.device)
        alive = torch.ones_like(ret)
        for _ in range(env.max_steps):
            a = act(net, obs, generator, epsilon)
            env_state, out = step(env_state, a, generator)
            ret = ret + out.reward * alive
            done = out.terminated | out.truncated
            alive = ((alive > 0) & ~done).float()
            obs = out.obs
        return ret.mean(dim=-1)

    return evaluate
