"""The R2D2 sequence learner and recurrent actor of the port (twin of
dist_dqn_tpu/agents/r2d2.py:35-193).

Burn-in: the first ``burn_in`` steps of a window are unrolled from the
stored actor carry only to refresh the hidden state, without grad, for the
online and the target net each with its own weights; the loss covers the
next ``unroll_length`` steps, and the last ``n_step`` steps are the
within-window bootstrap region. The cell re-zeroes its carry at the stored
reset flags and the n-step fold stops at dones (truncation counts as
terminal, as in the pixel ring's bootstrap). The target is double-Q and
value-rescaled when configured; the loss is the per-step Huber loss
averaged over time, then weighted by the IS weights; priorities are
``eta * max|td| + (1 - eta) * mean|td|`` per sequence (Kapturowski et al.,
2019).

The optimizer (:class:`ClipAdam`), the learner state and the target sync
are the feed-forward learner's (agents/dqn.py).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from dist_dqn_tpu_torch.agents.dqn import (ClipAdam, LearnerState,
                                           init_learner_state, make_optimizer,
                                           sync_target)
from dist_dqn_tpu_torch.config import LearnerConfig, ReplayConfig
from dist_dqn_tpu_torch.ops import losses
from dist_dqn_tpu_torch.types import SequenceSample


def make_r2d2_learner(cfg: LearnerConfig, rcfg: ReplayConfig,
                      tx: Optional[ClipAdam] = None):
    """Build (init, train_step) for a ``RecurrentQNetwork`` over sequences.

    ``init(net)`` wraps a built network into a :class:`LearnerState`.
    ``train_step(state, sample) -> (state, metrics)``; metrics holds device
    tensors ``loss``, ``raw_loss``, ``priorities`` [S] and ``grad_norm``.
    """
    burn = rcfg.burn_in
    unroll = rcfg.unroll_length
    n = cfg.n_step
    eta = rcfg.priority_mix
    if unroll <= 0:
        raise ValueError("R2D2 learner needs replay.unroll_length > 0")
    if cfg.munchausen:
        raise ValueError(
            "munchausen targets are implemented on the feed-forward "
            "scalar head only; unset munchausen or lstm_size")
    if tx is None:
        tx = make_optimizer(cfg)

    def init(net: nn.Module) -> LearnerState:
        return init_learner_state(net, tx)

    def unrolled_q(net: nn.Module, sample: SequenceSample) -> torch.Tensor:
        """Burn in without grad, then unroll the loss + bootstrap region:
        q over steps [burn, L), [unroll + n, S, A]."""
        carry = sample.start_state
        if burn:
            with torch.no_grad():
                carry, _ = net.unroll(carry, sample.obs[:burn],
                                      sample.reset[:burn])
            carry = (carry[0].detach(), carry[1].detach())
        _, q = net.unroll(carry, sample.obs[burn:], sample.reset[burn:])
        return q

    def train_step(state: LearnerState, sample: SequenceSample
                   ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        params = list(state.net.parameters())
        q_online = unrolled_q(state.net, sample)          # [unroll+n, S, A]
        with torch.no_grad():
            q_target = unrolled_q(state.target_net, sample)
            # Per-step n-step returns inside the window; d_t = gamma (1 -
            # done_t) zeroes everything past an episode end, the
            # bootstrap with it.
            r = sample.reward[burn:]                      # [unroll+n, S]
            d = cfg.gamma * (1.0 - sample.done[burn:].float())
            acc_r = torch.zeros_like(r[:unroll])
            acc_d = torch.ones_like(acc_r)
            for j in range(n):
                acc_r = acc_r + acc_d * r[j:j + unroll]
                acc_d = acc_d * d[j:j + unroll]
            boot_target = q_target[n:n + unroll]          # q at step k + n
            selector = (q_online[n:n + unroll].detach() if cfg.double_dqn
                        else boot_target)
            a_star = selector.argmax(dim=-1, keepdim=True)
            boot = boot_target.gather(-1, a_star)[..., 0]
            if cfg.value_rescale:
                boot = losses.inv_value_rescale(boot)
            target = acc_r + acc_d * boot
            if cfg.value_rescale:
                target = losses.value_rescale(target)
        action = sample.action[burn:burn + unroll].long()[..., None]
        qa = q_online[:unroll].gather(-1, action)[..., 0]
        td = qa - target                                  # [unroll, S]
        per_step = losses.huber(td, cfg.huber_delta)
        per_seq = per_step.mean(dim=0)                    # [S]
        loss = torch.mean(sample.weights * per_seq)
        grads = torch.autograd.grad(loss, params)
        grad_norm = tx.step(params, list(grads), state.opt_state)
        state.steps += 1
        sync_target(cfg, state)

        abs_td = td.detach().abs()
        priorities = (eta * abs_td.max(dim=0).values
                      + (1.0 - eta) * abs_td.mean(dim=0))
        metrics = {
            "loss": loss.detach(),
            "raw_loss": per_seq.detach().mean(),
            "priorities": priorities,
            "grad_norm": grad_norm,
        }
        return state, metrics

    return init, train_step


def make_recurrent_actor_step(num_actions: int,
                              return_q: bool = False) -> Callable:
    """Epsilon-greedy acting for the recurrent net, carry threaded by the
    caller.

    ``act(net, carry, obs, generator, epsilon) -> (new_carry, actions [B]
    int64)``. The caller zeroes the carry of envs whose episode ended
    before the next call (the fused loop does so right after the env
    step), so there are no reset flags here.

    With ``return_q`` the step also yields ``(q_sel, q_max)`` [B] float32:
    the Q-value of the action taken and the greedy value. The Ape-X
    service records them per step, so fresh sequences enter replay with
    inference-time TD priorities (``initial_sequence_priorities``).
    """

    @torch.no_grad()
    def act(net: nn.Module, carry, obs: torch.Tensor,
            generator: Optional[torch.Generator], epsilon):
        carry, q = net(carry, obs)
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=obs.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=obs.device) < epsilon
        actions = torch.where(explore, random_a, greedy)
        if not return_q:
            return carry, actions
        q32 = q.float()
        q_sel = q32.gather(-1, actions[:, None])[:, 0]
        return carry, actions, q_sel, q32.amax(dim=-1)

    return act
