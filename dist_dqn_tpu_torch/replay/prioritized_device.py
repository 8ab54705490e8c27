"""On-device prioritized replay over the time-ring (Ape-X).

Twin of ``dist_dqn_tpu/replay/prioritized_device.py:27-128``. Sampling is
a stratified inverse-CDF draw over the masked ``p ** alpha`` plane
(ops/sampler.py); with ``use_kernel`` the draw runs the hand-written CUDA
kernel on the card. Priorities are stored raw (|TD| + eps); alpha is
applied at sample time. Like the ring, the state is updated in place.
Every write-back is chronological last-write-wins where a slot appears
twice, so a seed's run repeats on the card; the replay-ratio engine
flushes its sub-steps' write-backs at once
(:func:`prioritized_ring_update_batched`). A population's ring stacks M
members' rings and planes (``members`` = M): one draw takes every
member's samples from its own plane (one sampler launch), and one
write-back lands every member's priorities in its own plane.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from dist_dqn_tpu_torch.ops.sampler import (importance_weights,
                                            stratified_sample,
                                            stratified_sample_at)
from dist_dqn_tpu_torch.replay import device as ring
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils.trace import span


@dataclasses.dataclass
class PrioritizedRingState:
    ring: ring.TimeRingState
    priorities: torch.Tensor    # [T, B] f32, raw |TD| (+eps), 0 = never written
    max_priority: torch.Tensor  # [] f32 running max — seed for new items
    # (a population's: [M, T, B] and [M])


class PrioritizedSample(NamedTuple):
    batch: Transition
    weights: torch.Tensor  # [S] importance-sampling weights, batch-max normalized
    t_idx: torch.Tensor    # [S] int32 ring slot of each sampled transition
    b_idx: torch.Tensor    # [S] int32 env lane of each sampled transition


def prioritized_ring_init(num_slots: int, num_envs: int,
                          obs_example: torch.Tensor,
                          store_final_obs: bool = False,
                          merge_obs_rows: bool = False, members: int = 0
                          ) -> PrioritizedRingState:
    dev = obs_example.device
    stack = (members,) if members else ()
    return PrioritizedRingState(
        ring=ring.time_ring_init(num_slots, num_envs, obs_example,
                                 store_final_obs=store_final_obs,
                                 merge_obs_rows=merge_obs_rows,
                                 members=members),
        priorities=torch.zeros(stack + (num_slots, num_envs),
                               dtype=torch.float32, device=dev),
        max_priority=torch.ones(stack, dtype=torch.float32, device=dev))


def prioritized_ring_add(state: PrioritizedRingState, obs: torch.Tensor,
                         action: torch.Tensor, reward: torch.Tensor,
                         terminated: torch.Tensor, truncated: torch.Tensor,
                         final_obs: Optional[torch.Tensor] = None,
                         merge_obs_rows: bool = False
                         ) -> PrioritizedRingState:
    """Append a time slice; fresh transitions get the running max priority
    (standard Ape-X seeding)."""
    p = state.ring.pos
    ring.time_ring_add(state.ring, obs, action, reward, terminated,
                       truncated, final_obs=final_obs,
                       merge_obs_rows=merge_obs_rows)
    if state.ring.members:
        state.priorities[:, p] = state.max_priority[:, None]
    else:
        state.priorities[p] = state.max_priority
    return state


def _valid_start_mask(state: ring.TimeRingState, n_step: int,
                      frame_stack: int = 0) -> torch.Tensor:
    """[T] bool — slots that are valid n-step window starts (the oldest
    size - n_step slots, as the uniform sampler draws from); frame-dedup
    rings also exclude the oldest frame_stack - 1, whose stack-rebuild
    context is not stored (ring.contextful_start_mask)."""
    num_slots = state.action.shape[-2]
    t = torch.arange(num_slots, device=state.action.device)
    oldest = (state.pos - state.size) % num_slots
    offset = (t - oldest) % num_slots
    return (ring.contextful_start_mask(state, frame_stack)
            & (offset < state.size - n_step))


def prioritized_ring_sample(state: PrioritizedRingState, generator,
                            batch_size: int, n_step: int, gamma,
                            alpha: float, beta: float,
                            use_kernel: bool = False,
                            merge_obs_rows: bool = False,
                            u: Optional[torch.Tensor] = None,
                            frame_stack: int = 0, frame_shape=None
                            ) -> PrioritizedSample:
    """Stratified sample ~ P(i) = p_i^alpha / sum p^alpha over valid slots.

    ``use_kernel`` draws through ops/sampler.py's kernel wrapper (the CUDA
    kernel on the card, its plain version on the CPU); otherwise the
    cumsum+searchsorted twin. ``u`` [S] injects the stratified uniforms
    instead of drawing them from ``generator`` (the parity tests hand both
    packages the same ones). ``frame_stack`` / ``frame_shape``: a
    frame-dedup ring (replay/device.py ``gather_transitions``). A stacked
    ring takes a list of M member generators (or [M, S] uniforms) and [M]
    gammas: one draw over the [M, T, B] planes, [M, S] outputs. The draw
    runs in the profiler span ``replay.draw``, the gather in
    ``replay.gather`` (utils/trace.py ``span``).
    """
    num_envs = state.priorities.shape[-1]
    with span("replay.draw"):
        mask = _valid_start_mask(state.ring, n_step, frame_stack)   # [T]
        w = torch.where(mask[:, None], state.priorities ** alpha,
                        torch.zeros((), device=mask.device))  # [(M,) T, B]
        n_valid = mask.sum().float() * num_envs
        if u is None:
            t_idx, b_idx, mass_sel, total = stratified_sample(
                w, generator, batch_size, use_kernel=use_kernel)
        else:
            t_idx, b_idx, mass_sel, total = stratified_sample_at(
                w, u, use_kernel=use_kernel)
        weights = importance_weights(mass_sel, total, n_valid, beta)
    with span("replay.gather"):
        batch = ring.gather_transitions(
            state.ring, t_idx, b_idx, n_step, gamma,
            merge_obs_rows=merge_obs_rows, frame_stack=frame_stack,
            frame_shape=frame_shape)
    return PrioritizedSample(batch=batch, weights=weights, t_idx=t_idx,
                             b_idx=b_idx)


def _write_priorities(state: PrioritizedRingState, t_idx: torch.Tensor,
                      b_idx: torch.Tensor, new_priorities: torch.Tensor,
                      eps: float) -> PrioritizedRingState:
    """|p| + eps into the plane at (t_idx, b_idx), chronological
    last-write-wins where a slot appears more than once
    (ring.last_write_wins_scatter); the running max follows.

    A stacked ring's indices are [..., M, S]: member m's writes land in
    plane m only, since the flat position (m·T + t)·B + b holds m, and the
    row-major order keeps each member's writes in chronological order."""
    T, B = state.priorities.shape[-2:]
    members = state.ring.members
    p = new_priorities.abs() + eps
    t, b = t_idx.long(), b_idx.long()
    if members:
        m = ring.member_index(members, t[0] if t.dim() == 3 else t)
        flat_idx = ((m * T + t) * B + b).reshape(-1)
        member_max = p.movedim(-2, 0).reshape(members, -1).amax(dim=1)
    else:
        flat_idx = t.reshape(-1) * B + b.reshape(-1)
        member_max = p.max()
    state.priorities.copy_(ring.last_write_wins_scatter(
        state.priorities.reshape(-1), flat_idx, p.reshape(-1)).view(
            state.priorities.shape))
    state.max_priority = torch.maximum(state.max_priority, member_max)
    return state


def prioritized_ring_update(state: PrioritizedRingState,
                            t_idx: torch.Tensor, b_idx: torch.Tensor,
                            new_priorities: torch.Tensor,
                            eps: float = 1e-6) -> PrioritizedRingState:
    """Write back learner TD magnitudes for the sampled transitions.

    A (t, b) drawn twice in one batch keeps the later draw's value. The
    two can differ (IQN draws fresh taus per example, so one transition
    gets two losses), and a CUDA ``index_put_`` leaves the order among
    duplicate indices undefined, which made a seed's IQN run differ
    between two runs on the card; the election makes it deterministic.
    """
    return _write_priorities(state, t_idx, b_idx, new_priorities, eps)


def prioritized_ring_update_batched(state: PrioritizedRingState,
                                    t_idx: torch.Tensor, b_idx: torch.Tensor,
                                    new_priorities: torch.Tensor,
                                    eps: float = 1e-6) -> PrioritizedRingState:
    """One flush for N sub-steps' write-backs (the replay-ratio engine).

    Inputs are [N, S] (or already flat [M]) in sub-step order; flattening
    row-major keeps that order, so a slot several sub-steps drew ends at
    the last one's |TD| + eps, deterministically
    (ring.last_write_wins_scatter).
    """
    return _write_priorities(state, t_idx, b_idx, new_priorities, eps)
