"""On-device prioritized replay over the time-ring (Ape-X).

Twin of ``dist_dqn_tpu/replay/prioritized_device.py:27-128``. Sampling is
a stratified inverse-CDF draw over the masked ``p ** alpha`` plane
(ops/sampler.py); with ``use_kernel`` the draw runs the hand-written CUDA
kernel on the card. Priorities are stored raw (|TD| + eps); alpha is
applied at sample time. Like the ring, the state is updated in place.
The replay-ratio engine flushes its sub-steps' write-backs at once, with
chronological last-write-wins (:func:`prioritized_ring_update_batched`).
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


@dataclasses.dataclass
class PrioritizedRingState:
    ring: ring.TimeRingState
    priorities: torch.Tensor    # [T, B] f32, raw |TD| (+eps), 0 = never written
    max_priority: torch.Tensor  # [] f32 running max — seed for new items


class PrioritizedSample(NamedTuple):
    batch: Transition
    weights: torch.Tensor  # [S] importance-sampling weights, batch-max normalized
    t_idx: torch.Tensor    # [S] int32 ring slot of each sampled transition
    b_idx: torch.Tensor    # [S] int32 env lane of each sampled transition


def prioritized_ring_init(num_slots: int, num_envs: int,
                          obs_example: torch.Tensor,
                          store_final_obs: bool = False,
                          merge_obs_rows: bool = False
                          ) -> PrioritizedRingState:
    dev = obs_example.device
    return PrioritizedRingState(
        ring=ring.time_ring_init(num_slots, num_envs, obs_example,
                                 store_final_obs=store_final_obs,
                                 merge_obs_rows=merge_obs_rows),
        priorities=torch.zeros((num_slots, num_envs), dtype=torch.float32,
                               device=dev),
        max_priority=torch.ones((), dtype=torch.float32, device=dev))


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
    state.priorities[p] = state.max_priority
    return state


def _valid_start_mask(state: ring.TimeRingState, n_step: int,
                      frame_stack: int = 0) -> torch.Tensor:
    """[T] bool — slots that are valid n-step window starts (the oldest
    size - n_step slots, as the uniform sampler draws from); frame-dedup
    rings also exclude the oldest frame_stack - 1, whose stack-rebuild
    context is not stored (ring.contextful_start_mask)."""
    num_slots = state.action.shape[0]
    t = torch.arange(num_slots, device=state.action.device)
    oldest = (state.pos - state.size) % num_slots
    offset = (t - oldest) % num_slots
    return (ring.contextful_start_mask(state, frame_stack)
            & (offset < state.size - n_step))


def prioritized_ring_sample(state: PrioritizedRingState,
                            generator: Optional[torch.Generator],
                            batch_size: int, n_step: int, gamma: float,
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
    frame-dedup ring (replay/device.py ``gather_transitions``).
    """
    num_envs = state.priorities.shape[1]
    mask = _valid_start_mask(state.ring, n_step, frame_stack)     # [T]
    w = torch.where(mask[:, None], state.priorities ** alpha,
                    torch.zeros((), device=mask.device))          # [T, B]
    n_valid = mask.sum().float() * num_envs
    if u is None:
        t_idx, b_idx, mass_sel, total = stratified_sample(
            w, generator, batch_size, use_kernel=use_kernel)
    else:
        t_idx, b_idx, mass_sel, total = stratified_sample_at(
            w, u, use_kernel=use_kernel)
    weights = importance_weights(mass_sel, total, n_valid, beta)
    batch = ring.gather_transitions(state.ring, t_idx, b_idx, n_step, gamma,
                                    merge_obs_rows=merge_obs_rows,
                                    frame_stack=frame_stack,
                                    frame_shape=frame_shape)
    return PrioritizedSample(batch=batch, weights=weights, t_idx=t_idx,
                             b_idx=b_idx)


def prioritized_ring_update(state: PrioritizedRingState,
                            t_idx: torch.Tensor, b_idx: torch.Tensor,
                            new_priorities: torch.Tensor,
                            eps: float = 1e-6) -> PrioritizedRingState:
    """Write back learner TD magnitudes for the sampled transitions."""
    p = new_priorities.abs() + eps
    # A (t, b) drawn twice in one batch is the same transition under the
    # same params, so both writes carry the same value: index_put_'s
    # unspecified order among duplicate indices cannot change the result.
    state.priorities.index_put_((t_idx.long(), b_idx.long()), p)
    state.max_priority = torch.maximum(state.max_priority, p.max())
    return state


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
    T, B = state.priorities.shape
    p = new_priorities.reshape(-1).abs() + eps
    flat_idx = t_idx.reshape(-1).long() * B + b_idx.reshape(-1).long()
    state.priorities.copy_(ring.last_write_wins_scatter(
        state.priorities.reshape(-1), flat_idx, p).view(T, B))
    state.max_priority = torch.maximum(state.max_priority, p.max())
    return state
