"""On-device replay: a time-major ring buffer in device memory.

Twin of ``dist_dqn_tpu/replay/device.py``: one ring of ``T`` time slots,
each holding one step from all ``B`` parallel envs — leaves are
``[T, B, ...]`` (obs optionally merged to ``[T * B, ...]`` rows). The fused
loop appends one time slice per env step; n-step returns are folded at
sample time from the stored (reward, terminated, truncated) fields, so
episode boundaries and truncation are handled exactly.

Unlike the JAX ring (immutable, rebuilt each step) this one is updated IN
PLACE: a 1M-transition pixel ring is 28 GB, and a second copy would not
fit beside it. ``pos`` and ``size`` are host ints — they advance by one
per add whatever the data, so the loop decides when it may sample without
reading anything back from the device.

Frame-dedup storage (``frame_stack`` > 0): the ring stores only each
step's newest frame and the gathers rebuild the stacks exactly, reset
re-tiling included (:func:`stack_rebuild_indices`) — a 4x saving of ring
memory on Atari stacks.

A population's ring (``members`` = M) holds M members' rings on a leading
axis, ``[M, T, B, ...]`` (merged obs ``[M, T * B, ...]``): one add writes
every member's slice at the shared ``pos``, and the gathers take [M, S]
index planes, member m's row of indices reading member m's ring only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils.trace import span


@dataclasses.dataclass
class TimeRingState:
    obs: torch.Tensor         # [T, B, ...] (or [T * B, ...] merged) obs
    action: torch.Tensor      # [T, B] int64
    reward: torch.Tensor      # [T, B] float32
    terminated: torch.Tensor  # [T, B] bool
    truncated: torch.Tensor   # [T, B] bool
    # Pre-reset successor obs, or None: storing it buys exact bootstrapping
    # through truncation; without it truncation is treated as terminal.
    final_obs: Optional[torch.Tensor]
    pos: int = 0              # next slot to write
    size: int = 0             # slots filled (<= T)

    @property
    def members(self) -> int:
        """M of a population's stacked ring; 0 for a solo ring."""
        return self.action.shape[0] if self.action.dim() == 3 else 0


def member_index(members: int, like: torch.Tensor) -> torch.Tensor:
    """[M, 1, ...] member ids that broadcast against an index tensor
    ``like`` of shape [M, ...]."""
    return torch.arange(members, device=like.device).view(
        (members,) + (1,) * (like.dim() - 1))


def _at(field: torch.Tensor, members: int, t: torch.Tensor,
        b: torch.Tensor) -> torch.Tensor:
    """``field[t, b]`` of a solo [T, B, ...] field; of a stacked [M, T, B,
    ...] one, ``field[m, t, b]`` with member m's indices in row m."""
    if not members:
        return field[t, b]
    return field[member_index(members, t), t, b]


def time_ring_init(num_slots: int, num_envs: int, obs_example: torch.Tensor,
                   store_final_obs: bool = False,
                   merge_obs_rows: bool = False,
                   members: int = 0) -> TimeRingState:
    """Allocate a zeroed ring on ``obs_example``'s device; the example (one
    env's obs) fixes the per-env obs shape and dtype. ``merge_obs_rows``
    stores obs as ``[num_slots * num_envs, ...]``: slot ``t`` of env ``b``
    at row ``t * num_envs + b``. ``members`` > 0 stacks that many rings on
    a leading axis."""
    dev = obs_example.device
    stack = (members,) if members else ()

    def zeros_obs():
        lead = ((num_slots * num_envs,) if merge_obs_rows
                else (num_slots, num_envs))
        return torch.zeros(stack + lead + tuple(obs_example.shape),
                           dtype=obs_example.dtype, device=dev)

    def zeros(dtype):
        return torch.zeros(stack + (num_slots, num_envs), dtype=dtype,
                           device=dev)

    return TimeRingState(
        obs=zeros_obs(), action=zeros(torch.int64),
        reward=zeros(torch.float32), terminated=zeros(torch.bool),
        truncated=zeros(torch.bool),
        final_obs=zeros_obs() if store_final_obs else None)


def time_ring_add(state: TimeRingState, obs: torch.Tensor,
                  action: torch.Tensor, reward: torch.Tensor,
                  terminated: torch.Tensor, truncated: torch.Tensor,
                  final_obs: Optional[torch.Tensor] = None,
                  merge_obs_rows: bool = False) -> TimeRingState:
    """Append one time slice (all envs) at ``pos`` in place; wraps around.
    A stacked ring takes every member's slice at once ([M, B, ...]
    inputs)."""
    num_slots, num_envs = state.action.shape[-2:]
    p = state.pos
    # A stacked ring's slot is the same in every member's ring.
    lead = (slice(None),) if state.members else ()

    def write_obs(buf, x):
        if merge_obs_rows:
            buf[lead + (slice(p * num_envs, (p + 1) * num_envs),)] = x
        else:
            buf[lead + (p,)] = x

    write_obs(state.obs, obs)
    state.action[lead + (p,)] = action
    state.reward[lead + (p,)] = reward
    state.terminated[lead + (p,)] = terminated
    state.truncated[lead + (p,)] = truncated
    if state.final_obs is not None:
        write_obs(state.final_obs, final_obs)
    state.pos = (p + 1) % num_slots
    state.size = min(state.size + 1, num_slots)
    return state


def time_ring_can_sample(state: TimeRingState, n_step: int,
                         frame_stack: int = 0) -> bool:
    """True once windows of length ``n_step`` (plus bootstrap slot) exist;
    a frame-dedup ring also needs ``frame_stack - 1`` prior slots stored to
    rebuild a start's stack."""
    return state.size > n_step + max(frame_stack - 1, 0)


def _gather_window(field: torch.Tensor, t_idx: torch.Tensor,
                   b_idx: torch.Tensor, n: int, num_slots: int,
                   members: int = 0) -> torch.Tensor:
    """[S, n] windows of ``field`` [T, B] starting at slot ``t_idx`` of env
    ``b_idx`` ([M, S, n] from a stacked [M, T, B] field at [M, S]
    indices)."""
    offs = torch.arange(n, device=t_idx.device)
    tt = (t_idx.long()[..., None] + offs) % num_slots
    return _at(field, members, tt, b_idx.long()[..., None])


def compute_n_step(reward_w: torch.Tensor, term_w: torch.Tensor,
                   trunc_w: torch.Tensor, gamma
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact n-step return over a window with episode-boundary masking.

    Args: [S, n] windows of per-step reward / terminated / truncated, and
    ``gamma``, a float; or a population's [M, S, n] windows and its [M]
    gammas (a tensor), member m's windows folded with member m's gamma.
    Returns:
      returns:  [S] — sum_{k<=k*} gamma^k r_k, where k* is the first done in
                the window (or n-1 if none).
      discount: [S] — gamma^(k*+1) * (1 - terminated[k*]).
      kstar:    [S] int64 — index of the last step inside the transition,
                i.e. the bootstrap observation lives at slot t + k* + 1.
    """
    n = reward_w.shape[-1]
    if isinstance(gamma, torch.Tensor):
        # [M] -> [M, 1], against the [M, S] leading dims.
        gamma = gamma.view((-1,) + (1,) * (reward_w.dim() - 2))
        gammas = gamma[..., None] ** torch.arange(
            n, dtype=torch.float32, device=reward_w.device)
    else:
        gammas = gamma ** torch.arange(n, dtype=torch.float32,
                                       device=reward_w.device)
    done_w = term_w | trunc_w
    # prefix[k] = prod_{j<k} (1 - done_j): 1 until just after first done.
    cont = 1.0 - done_w.float()
    prefix = torch.cat([torch.ones_like(cont[..., :1]),
                        torch.cumprod(cont[..., :-1], dim=-1)], dim=-1)
    terms = prefix * gammas * reward_w
    # Summed in window order, as XLA reduces the window axis.
    returns = terms[..., 0]
    for k in range(1, n):
        returns = returns + terms[..., k]

    any_done = done_w.any(dim=-1)
    first_done = done_w.int().argmax(dim=-1)
    kstar = torch.where(any_done, first_done, n - 1)
    term_at_k = term_w.gather(-1, kstar[..., None])[..., 0]
    discount = (gamma ** (kstar + 1).float()) * (1.0 - term_at_k.float())
    return returns, discount, kstar


def contextful_start_mask(state: TimeRingState, frame_stack: int = 0
                          ) -> torch.Tensor:
    """[T] bool — stored slots, minus the oldest ``frame_stack - 1`` (whose
    frame-dedup rebuild context is not stored); all stored slots when
    ``frame_stack`` is 0/1."""
    num_slots = state.action.shape[-2]
    extra = max(frame_stack - 1, 0)
    t = torch.arange(num_slots, device=state.action.device)
    oldest = (state.pos - state.size) % num_slots
    offset = (t - oldest) % num_slots
    return (offset >= extra) & (offset < state.size)


def last_write_wins_scatter(plane: torch.Tensor, flat_idx: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Scatter ``values`` into the flat ``plane`` with deterministic
    chronological last-write-wins on duplicate indices; returns the new
    plane.

    A CUDA ``index_put_`` leaves the order among duplicate indices
    undefined, so a plain scatter cannot promise which of N replay-ratio
    sub-steps' values a twice-drawn slot keeps. As in the JAX package, a
    scatter-max over write positions elects each slot's last writer, and
    every other writer is routed to a spare slot past the end, which is
    dropped — no mask, no read back to the host.

    Args: plane [N]; flat_idx [M] write positions in chronological order;
    values [M].
    """
    n = plane.shape[0]
    flat_idx = flat_idx.long()
    order = torch.arange(1, flat_idx.shape[0] + 1, device=plane.device)
    # Last writer per slot: the largest write position landing on it.
    winner = torch.zeros(n, dtype=torch.int64, device=plane.device)
    winner.scatter_reduce_(0, flat_idx, order, "amax")
    keep = winner[flat_idx] == order
    safe_idx = torch.where(keep, flat_idx, torch.full_like(flat_idx, n))
    out = torch.cat([plane, plane.new_zeros(1)])
    out[safe_idx] = values.to(plane.dtype)
    return out[:n]


def stack_rebuild_indices(done_at: Callable[[torch.Tensor], torch.Tensor],
                          t_idx: torch.Tensor, frame_stack: int,
                          num_slots: int
                          ) -> List[Tuple[int, torch.Tensor]]:
    """Per-channel ring slots that rebuild a frame stack stored deduped.

    The rolling-stack contract (envs/base.py ``frame_stack``): within an
    episode, channel ``d`` of ``obs_t`` (d=0 newest) is the single frame of
    step ``t-d``; a reset at boundary ``done[t-1-j]`` re-tiled the stack,
    so frames older than the episode start are its first frame repeated.
    Hence channel ``d`` comes from slot ``t - min(d, age_t)``, where
    ``age_t`` is j-1 for the nearest j in [1, S-1] with ``done[t-j]``
    (S-1 when there is none).

    ``done_at(slots) -> [len(t_idx)] bool`` is the done-flag lookup.
    Returns slots per lookback, newest first: [(d, [S] slots), ...].
    """
    S = frame_stack
    age = torch.full_like(t_idx, S - 1)
    for j in range(S - 1, 0, -1):  # descending: the nearest done wins
        age = torch.where(done_at((t_idx - j) % num_slots),
                          torch.full_like(t_idx, j - 1), age)
    return [(d, (t_idx - age.clamp(max=d)) % num_slots) for d in range(S)]


def _take_stacks(obs: torch.Tensor, slots: torch.Tensor, b_idx: torch.Tensor,
                 num_envs: int, merge_obs_rows: bool, frame_shape,
                 members: int = 0) -> torch.Tensor:
    """Single stored frames at ``slots`` [..., F] (oldest channel first)
    of envs ``b_idx`` [...] -> stacks [..., H, W, F]; a stacked ring's
    ``slots`` and ``b_idx`` lead with the member axis."""
    b = b_idx[..., None]
    lead = (member_index(members, slots),) if members else ()
    if merge_obs_rows:
        frames = obs[lead + (slots * num_envs + b,)]        # [..., F, prod]
        frames = frames.reshape(frames.shape[:-1] + tuple(frame_shape))
    else:
        frames = obs[lead + (slots, b)]                     # [..., F, H, W, 1]
    return frames[..., 0].movedim(slots.dim() - 1, -1)


def gather_transitions(state: TimeRingState, t_idx: torch.Tensor,
                       b_idx: torch.Tensor, n_step: int, gamma: float,
                       merge_obs_rows: bool = False, frame_stack: int = 0,
                       frame_shape=None) -> Transition:
    """Window-gather + n-step fold for explicit (t_idx, b_idx) pairs,
    shared by the uniform and prioritized samplers.

    ``frame_stack=S > 0``: the ring stores each step's newest frame only
    (obs leaves [..., H, W, 1], or flat rows of that frame) and the gather
    rebuilds the [N, H, W, S] stacks, channels oldest first, exactly as
    stacked storage would hold them. ``frame_shape`` (e.g. (84, 84, 1))
    reshapes merged rows; rebuilt stacks come back unflattened either way.
    A stacked ring takes [M, S] indices and ``gamma`` as an [M] tensor,
    and gives [M, S, ...] leaves.
    """
    if frame_stack and state.final_obs is not None:
        raise ValueError(
            "frame_stack rebuild is undefined for rings with final_obs (the "
            "final-obs buffer is not a rolling frame stream): build the ring "
            "with store_final_obs=False for frame dedup")
    if frame_stack and merge_obs_rows and frame_shape is None:
        raise ValueError("a merged-row dedup gather needs frame_shape")
    num_slots, num_envs = state.action.shape[-2:]
    members = state.members
    t_idx = t_idx.long()
    b_idx = b_idx.long()
    reward_w = _gather_window(state.reward, t_idx, b_idx, n_step, num_slots,
                              members)
    term_w = _gather_window(state.terminated, t_idx, b_idx, n_step,
                            num_slots, members)
    trunc_w = _gather_window(state.truncated, t_idx, b_idx, n_step,
                             num_slots, members)
    returns, discount, kstar = compute_n_step(reward_w, term_w, trunc_w,
                                              gamma)

    def take(x, t):
        if frame_stack:
            slots = stack_rebuild_indices(
                lambda tt: _at(state.terminated, members, tt, b_idx)
                | _at(state.truncated, members, tt, b_idx), t, frame_stack,
                num_slots)
            oldest_first = torch.stack([s for _, s in reversed(slots)],
                                       dim=-1)
            return _take_stacks(x, oldest_first, b_idx, num_envs,
                                merge_obs_rows, frame_shape, members)
        if merge_obs_rows:
            if members:
                return x[member_index(members, t), t * num_envs + b_idx]
            return x[t * num_envs + b_idx]
        return _at(x, members, t, b_idx)

    obs = take(state.obs, t_idx)
    action = _at(state.action, members, t_idx, b_idx)
    if state.final_obs is not None:
        # Exact path: the stored pre-reset successor of step k*.
        next_obs = take(state.final_obs, (t_idx + kstar) % num_slots)
    else:
        # The next slot's obs is post-reset at episode ends, so it is only a
        # valid bootstrap within an episode: zero the discount at truncation
        # (termination already zeroes it in compute_n_step).
        trunc_at_k = trunc_w.gather(-1, kstar[..., None])[..., 0]
        discount = discount * (1.0 - trunc_at_k.float())
        next_obs = take(state.obs, (t_idx + kstar + 1) % num_slots)
    return Transition(obs=obs, action=action, reward=returns,
                      discount=discount, next_obs=next_obs)


def time_ring_sample(state: TimeRingState, generator, batch_size: int,
                     n_step: int, gamma, merge_obs_rows: bool = False,
                     frame_stack: int = 0, frame_shape=None) -> Transition:
    """Uniformly sample ``batch_size`` n-step transitions from the oldest
    ``size - n_step`` slots, so every bootstrap slot is a stored, in-order
    step of the same env. Frame-dedup rings also skip the oldest
    ``frame_stack - 1`` starts, whose rebuild context is not stored. A
    stacked ring takes a list of M member generators (each draws a solo
    run's numbers) and [M] gammas, and gives [M, S, ...] leaves. The
    draw and the gather run in the profiler spans ``replay.draw`` and
    ``replay.gather`` (utils/trace.py ``span``)."""
    num_slots, num_envs = state.action.shape[-2:]
    dev = state.action.device
    extra = max(frame_stack - 1, 0)
    num_valid = max(state.size - n_step - extra, 1)

    def draw(gen):
        return (torch.randint(0, num_valid, (batch_size,), generator=gen,
                              device=dev),
                torch.randint(0, num_envs, (batch_size,), generator=gen,
                              device=dev))

    with span("replay.draw"):
        if state.members:
            u, b_idx = (torch.stack(x) for x in zip(*map(draw, generator)))
        else:
            u, b_idx = draw(generator)
        t_idx = (state.pos - state.size + extra + u) % num_slots
    with span("replay.gather"):
        return gather_transitions(state, t_idx, b_idx, n_step, gamma,
                                  merge_obs_rows=merge_obs_rows,
                                  frame_stack=frame_stack,
                                  frame_shape=frame_shape)
