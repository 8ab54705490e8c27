"""Base class for the port's batched on-device environments.

Twin of ``dist_dqn_tpu/envs/base.py``. The JAX envs define one instance
and ``vmap`` it; here every method works on a batch dimension written out
(leaves are ``[B, ...]``), and the auto-reset is a ``torch.where`` over
that batch.

Randomness is explicit: every random number one step (or one reset) may
consume is drawn up front by :meth:`TorchEnv.draw` from a
``torch.Generator`` on the env's device, as one ``[B]``-wide draw per
quantity. A test hands ``reset``/``v_step`` the same numbers the JAX env
draws, which is how both packages step in lockstep although their
generators differ.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dist_dqn_tpu_torch.types import StepOut


def _select(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """``where(done, a, b)`` with ``done`` [B] broadcast over a's trailing
    dims."""
    return torch.where(done.view((-1,) + (1,) * (a.dim() - 1)), a, b)


class TorchEnv:
    """Interface: subclasses define ``num_actions`` / observation specs and
    the batched ``reset(draws) -> (state, obs)``, ``env_step(state, action,
    draws) -> (state, next_obs, reward, terminated, truncated)`` and
    ``draw(num_envs, generator) -> draws``. States are NamedTuples of
    ``[B, ...]`` tensors.
    """

    num_actions: int
    observation_shape: Tuple[int, ...]
    observation_dtype = torch.float32
    # Rolling frame-stack depth of the observation's LAST axis, or 0 (the
    # same contract as the JAX envs' ``frame_stack``).
    frame_stack: int = 0
    max_steps: int

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    def draw(self, num_envs: int, generator: torch.Generator) -> NamedTuple:
        raise NotImplementedError

    def reset(self, draws: NamedTuple) -> Tuple[NamedTuple, torch.Tensor]:
        raise NotImplementedError

    def env_step(self, state: NamedTuple, action: torch.Tensor,
                 draws: NamedTuple):
        raise NotImplementedError

    # -- vectorized forms ---------------------------------------------------
    def v_reset(self, num_envs: int, generator: Optional[torch.Generator] = None,
                draws: Optional[NamedTuple] = None):
        if draws is None:
            draws = self.draw(num_envs, generator)
        return self.reset(draws)

    def v_step(self, state: NamedTuple, action: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               draws: Optional[NamedTuple] = None
               ) -> Tuple[NamedTuple, StepOut]:
        """Auto-resetting batched step: lanes whose episode ended come back
        reset (state and ``obs``), with ``next_obs`` the pre-reset
        successor."""
        if draws is None:
            draws = self.draw(action.shape[0], generator)
        new_state, next_obs, reward, terminated, truncated = self.env_step(
            state, action, draws)
        done = terminated | truncated
        reset_state, reset_obs = self.reset(draws)
        state_out = type(new_state)(*(
            _select(done, r, c) for r, c in zip(reset_state, new_state)))
        obs_out = _select(done, reset_obs, next_obs)
        return state_out, StepOut(obs=obs_out, next_obs=next_obs,
                                  reward=reward, terminated=terminated,
                                  truncated=truncated)
