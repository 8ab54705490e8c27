"""Core datatypes shared across the port (twin of dist_dqn_tpu/types.py)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class StepOut(NamedTuple):
    """Result of one (vectorized, auto-resetting) environment step.

    Auto-reset semantics: when an episode ends, the environment resets
    immediately and ``obs`` is the *new* episode's first observation, while
    ``next_obs`` is the true successor of the acted-on observation (pre-reset)
    so that bootstrapping on truncation stays correct.
    """

    obs: torch.Tensor         # observation to act on next (post auto-reset)
    next_obs: torch.Tensor    # true successor of the acted-on obs (pre-reset)
    reward: torch.Tensor      # [B] float32
    terminated: torch.Tensor  # [B] bool — env reached a terminal state
    truncated: torch.Tensor   # [B] bool — episode cut by time limit


class Transition(NamedTuple):
    """One (possibly n-step) transition as stored in replay.

    ``discount`` already folds in termination and gamma**n:
    target = reward + discount * bootstrap(next_obs).
    """

    obs: torch.Tensor
    action: torch.Tensor    # [B] int64 (torch's index type)
    reward: torch.Tensor    # [B] float32 — n-step return
    discount: torch.Tensor  # [B] float32 — gamma**n * (1 - terminated)
    next_obs: torch.Tensor


class SequenceSample(NamedTuple):
    """A batch of fixed-length sequences for R2D2.

    Time-major ([L, S, ...], what an LSTM unroll consumes), with L =
    burn_in + unroll_length + n_step (the trailing n_step slots are the
    within-window bootstrap region) and S sequences. ``start_state`` is the
    (c, h) carry the actor held *entering* the first step, so a learner
    unroll from it reproduces the actor's hidden states.
    """

    obs: torch.Tensor          # [L, S, ...]
    action: torch.Tensor       # [L, S] int64
    reward: torch.Tensor       # [L, S] float32
    done: torch.Tensor         # [L, S] bool — terminated|truncated there
    reset: torch.Tensor        # [L, S] bool — obs[t] opens a new episode
    start_state: Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [S, lstm]
    weights: torch.Tensor      # [S] importance-sampling weights
    t_idx: torch.Tensor        # [S] int32 ring slot of each sequence start
    b_idx: torch.Tensor        # [S] int32 env lane of each sequence
