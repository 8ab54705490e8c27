"""Core datatypes shared across the port (twin of dist_dqn_tpu/types.py)."""
from __future__ import annotations

from typing import NamedTuple

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
