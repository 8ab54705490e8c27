"""On-device R2D2 sequence replay over the time-ring.

Twin of ``dist_dqn_tpu/replay/sequence_device.py:34-239``. Every step is
stored once in the time-ring (replay/device.py) together with the actor's
LSTM carry *entering* that step; a sequence is a length-L window gather at
sample time, so overlapping windows cost no extra memory.

Window starts are seeded into the priority plane every ``stride`` writes:
a start's row gets the running max priority when its full window lands in
the ring, and is cleared when the ring overwrites its slot. So
``priorities > 0`` is exactly the set of live starts, and the same
stratified inverse-CDF draw as the transition sampler
(replay/prioritized_device.py) reads it, through the sampler kernel's
wrapper when ``use_kernel`` is set.

Like the ring, the state is updated in place, and ``writes`` is a host int:
it advances by one per add whatever the data, so which starts are live is a
function of host ints (:func:`live_start_writes`) and the loop decides when
it may sample without reading the device. With frame-dedup storage the
ring holds single frames and the sampler rebuilds every window position's
stack (:func:`_rebuild_seq_stacks`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dist_dqn_tpu_torch.ops.sampler import (importance_weights,
                                            stratified_sample,
                                            stratified_sample_at)
from dist_dqn_tpu_torch.replay import device as ring
from dist_dqn_tpu_torch.types import SequenceSample


@dataclasses.dataclass
class SequenceRingState:
    ring: ring.TimeRingState
    state_c: torch.Tensor       # [T, B, lstm] f32 — carry entering each step
    state_h: torch.Tensor       # [T, B, lstm] f32
    priorities: torch.Tensor    # [T, B] f32; > 0 exactly at live starts
    max_priority: torch.Tensor  # [] f32 — seed for fresh windows
    writes: int = 0             # time slices ever written


def sequence_ring_init(num_slots: int, num_envs: int,
                       obs_example: torch.Tensor, lstm_size: int,
                       merge_obs_rows: bool = False) -> SequenceRingState:
    """A zeroed ring on ``obs_example``'s device. ``merge_obs_rows`` stores
    obs as ``[num_slots * num_envs, ...]`` rows (replay/device.py); the
    carry and priority planes keep ``[T, B]``."""
    dev = obs_example.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return SequenceRingState(
        ring=ring.time_ring_init(num_slots, num_envs, obs_example,
                                 store_final_obs=False,
                                 merge_obs_rows=merge_obs_rows),
        state_c=zeros(num_slots, num_envs, lstm_size),
        state_h=zeros(num_slots, num_envs, lstm_size),
        priorities=zeros(num_slots, num_envs),
        max_priority=torch.ones((), dtype=torch.float32, device=dev))


def sequence_ring_add(state: SequenceRingState, obs: torch.Tensor,
                      action: torch.Tensor, reward: torch.Tensor,
                      terminated: torch.Tensor, truncated: torch.Tensor,
                      carry: Tuple[torch.Tensor, torch.Tensor], seq_len: int,
                      stride: int,
                      merge_obs_rows: bool = False) -> SequenceRingState:
    """Append one time slice and the actor carry that produced ``action``.

    Overwriting slot ``p`` ends the window that starts there (it is the
    oldest slot of any window holding it), so its priority row is cleared;
    the start whose window this write completes, write index ``writes + 1 -
    seq_len``, is seeded with the running max priority when it is
    stride-aligned.
    """
    num_slots = state.priorities.shape[0]
    p = state.ring.pos
    ring.time_ring_add(state.ring, obs, action, reward, terminated,
                       truncated, merge_obs_rows=merge_obs_rows)
    state.writes += 1
    state.priorities[p] = 0.0
    start_write = state.writes - seq_len
    if start_write >= 0 and start_write % stride == 0:
        state.priorities[(p - (seq_len - 1)) % num_slots] = state.max_priority
    state.state_c[p] = carry[0]
    state.state_h[p] = carry[1]
    return state


def sequence_ring_can_sample(state: SequenceRingState, seq_len: int) -> bool:
    """True once the first full window has been written."""
    return state.writes >= seq_len


def live_start_writes(writes: int, num_slots: int, seq_len: int,
                      stride: int, frame_stack: int = 0) -> range:
    """Write indices of the live window starts after ``writes`` adds: the
    stride-aligned starts whose window is complete (``s + seq_len <=
    writes``) and whose slot has not been overwritten (``s >= writes -
    num_slots``). Their slots (``s % num_slots``) are exactly the rows where
    ``priorities > 0``: a write-back stores ``|td| + eps > 0`` and only where
    the row is live, so it never changes the set. With ``frame_stack`` the
    oldest ``frame_stack - 1`` stored slots are left out too: the sampler
    masks those starts (ring.contextful_start_mask)."""
    lo = max(writes - num_slots, 0) + max(frame_stack - 1, 0)
    hi = writes - seq_len
    first = -(-lo // stride) * stride
    return range(first, hi + 1, stride) if hi >= first else range(0)


def _gather_seq(field: torch.Tensor, tt: torch.Tensor,
                b_idx: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] field -> [L, S, ...] windows at slots ``tt`` [L, S]."""
    return field[tt, b_idx[None, :]]


def _rebuild_seq_stacks(r: ring.TimeRingState, t_idx: torch.Tensor,
                        b_idx: torch.Tensor, seq_len: int, frame_stack: int,
                        merge_obs_rows: bool, frame_shape) -> torch.Tensor:
    """[L, S_, H, W, frame_stack] stacks for every window position, from a
    dedup ring (single stored frames, replay/device.py).

    The done flags of ``seq_len + frame_stack - 1`` slots (offsets
    -(S-1)..L-1) give every position's ``age`` with the nearest-done rule
    of ``device.stack_rebuild_indices``; each channel ``d`` of position
    ``i`` is then the frame at slot ``t + i - min(d, age)``, gathered in
    one indexing pass. Callers mask out starts whose context predates the
    ring (sequence_ring_sample).
    """
    num_slots, num_envs = r.action.shape
    S, L = frame_stack, seq_len
    t, b = t_idx.long(), b_idx.long()
    ext_offs = torch.arange(-(S - 1), L, device=t.device)
    tt = (t[None, :] + ext_offs[:, None]) % num_slots          # [L+S-1, S_]
    done_ext = r.terminated[tt, b[None, :]] | r.truncated[tt, b[None, :]]
    # age[i]: distance-1 to the nearest done among positions i-1..i-(S-1)
    # (window position i lives at ext index i + S - 1).
    age = torch.full((L, t.shape[0]), S - 1, dtype=torch.int64,
                     device=t.device)
    for j in range(S - 1, 0, -1):   # descending: the nearest done wins
        age = torch.where(done_ext[S - 1 - j:S - 1 - j + L],
                          torch.full_like(age, j - 1), age)
    pos = torch.arange(L, device=t.device)[:, None, None]           # [L,1,1]
    lookback = torch.arange(S - 1, -1, -1, device=t.device)         # oldest first
    back = torch.minimum(lookback[None, None, :], age[..., None])   # [L,S_,S]
    slots = (t[None, :, None] + pos - back) % num_slots
    return ring._take_stacks(r.obs, slots, b, num_envs, merge_obs_rows,
                             frame_shape)


def sequence_ring_sample(state: SequenceRingState,
                         generator: Optional[torch.Generator],
                         batch_size: int, seq_len: int, alpha: float,
                         beta: float, use_kernel: bool = False,
                         merge_obs_rows: bool = False,
                         u: Optional[torch.Tensor] = None,
                         frame_stack: int = 0,
                         frame_shape=None) -> SequenceSample:
    """Stratified inverse-CDF sample of ``batch_size`` windows of
    ``seq_len`` steps, time-major.

    ``use_kernel`` draws through ops/sampler.py's kernel wrapper (the CUDA
    kernel on the card, its plain version on the CPU); otherwise the
    cumsum+searchsorted twin. ``u`` [S] injects the stratified uniforms
    instead of drawing them from ``generator``. ``frame_stack`` > 0: the
    ring stores single frames (dedup), the returned obs are rebuilt
    [L, S_, H, W, frame_stack] stacks, and starts whose rebuild context
    predates the stored region (the oldest frame_stack - 1 slots) are
    masked out of the draw.
    """
    num_slots, num_envs = state.priorities.shape
    pr = state.priorities
    zero = torch.zeros((), device=pr.device)
    w = torch.where(pr > 0.0, pr ** alpha, zero)
    if frame_stack:
        w = torch.where(
            ring.contextful_start_mask(state.ring, frame_stack)[:, None],
            w, zero)
    if u is None:
        t_idx, b_idx, mass_sel, total = stratified_sample(
            w, generator, batch_size, use_kernel=use_kernel)
    else:
        t_idx, b_idx, mass_sel, total = stratified_sample_at(
            w, u, use_kernel=use_kernel)
    n_valid = (w > 0.0).float().sum()
    weights = importance_weights(mass_sel, total, n_valid, beta)

    r = state.ring
    t, b = t_idx.long(), b_idx.long()
    offs = torch.arange(seq_len, device=t.device)
    tt = (t[None, :] + offs[:, None]) % num_slots           # [L, S]
    if frame_stack:
        obs = _rebuild_seq_stacks(r, t, b, seq_len, frame_stack,
                                  merge_obs_rows, frame_shape)
    elif merge_obs_rows:
        obs = r.obs[tt * num_envs + b[None, :]]             # slot t, env b
    else:
        obs = _gather_seq(r.obs, tt, b)
    action = _gather_seq(r.action, tt, b)
    reward = _gather_seq(r.reward, tt, b)
    done = _gather_seq(r.terminated, tt, b) | _gather_seq(r.truncated, tt, b)
    # obs[t] opens a new episode iff the previous stored step ended one.
    # The first step never resets: its stored carry is already right.
    reset = torch.cat([torch.zeros_like(done[:1]), done[:-1]], dim=0)
    start_state = (state.state_c[t, b], state.state_h[t, b])
    return SequenceSample(obs=obs, action=action, reward=reward, done=done,
                          reset=reset, start_state=start_state,
                          weights=weights, t_idx=t_idx, b_idx=b_idx)


def sequence_ring_update(state: SequenceRingState, t_idx: torch.Tensor,
                         b_idx: torch.Tensor, new_priorities: torch.Tensor,
                         eps: float = 1e-6) -> SequenceRingState:
    """Write back the learner's per-sequence priorities for the drawn
    windows, only where the start is still live, so a start overwritten
    between draw and write-back is not revived."""
    t, b = t_idx.long(), b_idx.long()
    p = new_priorities.abs() + eps
    # Read before the scatter. A window drawn twice in one batch is the
    # same sequence under the same params, so both writes carry the same
    # value: index_put_'s unspecified order among duplicate indices cannot
    # change the result.
    still_valid = state.priorities[t, b] > 0.0
    p = torch.where(still_valid, p, torch.zeros_like(p))
    state.priorities.index_put_((t, b), p)
    state.max_priority = torch.maximum(state.max_priority, p.max())
    return state
