"""The DQN learner and actor of the port (twin of dist_dqn_tpu/agents/dqn.py).

Scalar-head branch only (``dqn.py:280-317``): double or max bootstrap,
optionally value-rescaled (R2D2's h / h^-1), Huber TD loss weighted by PER
importance weights, |TD| priorities; a hand-written clip-by-global-norm +
Adam with optax's arithmetic (:class:`ClipAdam`); hard or Polyak target
sync (``dqn.py:340-350``, :func:`sync_target`, shared with the R2D2
learner). Distributional, noisy, IQN and Munchausen targets come with
later slices and are refused by :func:`make_learner`.

Parameters live in ``nn.Module``s and are updated in place; the step
counters are host ints (they advance by one per step whatever the data,
so the target-sync decision and the lr schedule need no device read).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dist_dqn_tpu_torch.config import LearnerConfig
from dist_dqn_tpu_torch.ops import losses
from dist_dqn_tpu_torch.types import Transition


# --------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adam), written out.
# --------------------------------------------------------------------------

def make_lr_schedule(cfg: LearnerConfig) -> Callable[[int], float]:
    """lr(count) over grad steps, as optax's constant / linear / cosine
    schedules compute it in float32 (count = updates applied so far)."""
    f32 = np.float32
    if cfg.lr_schedule == "constant":
        lr = f32(cfg.learning_rate)
        return lambda count: float(lr)
    if cfg.lr_schedule not in ("linear", "cosine"):
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; "
            "expected one of: constant, linear, cosine")
    if cfg.lr_decay_steps <= 0:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} needs lr_decay_steps > 0 "
            "(the grad-step horizon the anneal spans)")
    steps = cfg.lr_decay_steps
    if cfg.lr_schedule == "linear":
        init, end = cfg.learning_rate, cfg.lr_end_value

        def linear(count: int) -> float:
            frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
            return float(f32(init - end) * frac + f32(end))
        return linear
    if cfg.learning_rate <= 0:
        raise ValueError(
            "lr_schedule='cosine' needs learning_rate > 0 (the decay floor "
            "is expressed as the ratio lr_end_value / learning_rate)")
    alpha = cfg.lr_end_value / cfg.learning_rate
    init = cfg.learning_rate

    def cosine(count: int) -> float:
        c = f32(min(count, steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(steps),
                                             dtype=f32))
        return float(f32(init) * (f32(1 - alpha) * decay + f32(alpha)))
    return cosine


@dataclasses.dataclass
class AdamState:
    count: int                  # updates applied so far
    mu: List[torch.Tensor]      # first moments, one per parameter
    nu: List[torch.Tensor]      # second moments


class ClipAdam:
    """Clip-by-global-norm + Adam with optax's formulas, applied in place.

    * clip: scale every gradient by ``max_norm / norm`` only when
      ``norm >= max_norm`` — optax's ``clip_by_global_norm`` (no ``+1e-6``,
      unlike ``torch.nn.utils.clip_grad_norm_``), chosen on the device with
      ``torch.where`` so no norm is read back;
    * adam: ``p -= lr(count) * m_hat / (sqrt(v_hat) + eps)`` — optax's eps
      placement, bias corrections ``1 - b**(count + 1)`` in float32.
    """

    def __init__(self, cfg: LearnerConfig, b1: float = 0.9,
                 b2: float = 0.999):
        self.max_norm = cfg.max_grad_norm
        self.eps = cfg.adam_eps
        self.b1, self.b2 = b1, b2
        self.lr = make_lr_schedule(cfg)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: AdamState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the global norm
        of the unclipped gradients."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if self.max_norm:
            keep = g_norm < self.max_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_norm)
                     for g in grads]
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        step = -self.lr(state.count)
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_(step * update)
        state.count = count
        return g_norm


def make_optimizer(cfg: LearnerConfig) -> ClipAdam:
    """The learner's optimizer: clip-by-global-norm (when max_grad_norm is
    set) + Adam with the configured lr schedule."""
    return ClipAdam(cfg)


# --------------------------------------------------------------------------
# Learner.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LearnerState:
    net: nn.Module          # online Q-network (the params)
    target_net: nn.Module   # target Q-network (the target params)
    opt_state: AdamState
    steps: int = 0          # completed gradient steps


def init_learner_state(net: nn.Module, tx: ClipAdam) -> LearnerState:
    """Wrap a built network into a :class:`LearnerState`: a distinct
    target copy and zeroed optimizer moments."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    return LearnerState(net=net, target_net=target,
                        opt_state=tx.init(list(net.parameters())))


@torch.no_grad()
def sync_target(cfg: LearnerConfig, state: LearnerState) -> None:
    """After ``state.steps`` grad steps: a soft Polyak step toward the
    online params every step (``target_tau > 0``), else a hard copy every
    ``target_update_period`` steps."""
    targets = state.target_net.parameters()
    params = state.net.parameters()
    if cfg.target_tau > 0.0:
        for t, p in zip(targets, params):
            t.copy_(t + cfg.target_tau * (p - t))
    elif state.steps % cfg.target_update_period == 0:
        for t, p in zip(targets, params):
            t.copy_(p)


def make_learner(cfg: LearnerConfig, tx: Optional[ClipAdam] = None):
    """Build (init, train_step) for a feed-forward scalar-head Q-network.

    ``init(net)`` wraps a built network into a :class:`LearnerState` (a
    distinct target copy, zeroed optimizer moments).
    ``train_step(state, batch, weights) -> (state, metrics)``; metrics holds
    device tensors ``loss``, ``raw_loss``, ``priorities`` [S] (|TD|),
    ``grad_norm`` and ``mean_q_target_gap``.
    """
    if cfg.munchausen:
        raise NotImplementedError(
            "learner.munchausen is not ported yet: it comes with the "
            "distributional-heads slice (ROADMAP.md)")
    if tx is None:
        tx = make_optimizer(cfg)

    def init(net: nn.Module) -> LearnerState:
        return init_learner_state(net, tx)

    def train_step(state: LearnerState, batch: Transition,
                   weights: Optional[torch.Tensor] = None
                   ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        if weights is None:
            weights = torch.ones_like(batch.reward)
        net, target_net = state.net, state.target_net
        params = list(net.parameters())
        with torch.no_grad():
            q_next_target = target_net(batch.next_obs)
            if cfg.double_dqn:
                boot = losses.double_q_bootstrap(net(batch.next_obs),
                                                 q_next_target)
            else:
                boot = q_next_target.max(dim=-1).values
            if cfg.value_rescale:
                boot = losses.inv_value_rescale(boot)
            target = batch.reward + batch.discount * boot
            if cfg.value_rescale:
                target = losses.value_rescale(target)
        q = net(batch.obs)
        qa = q.gather(-1, batch.action.long()[:, None])[:, 0]
        td = qa - target
        per_example = losses.huber(td, cfg.huber_delta)
        loss = torch.mean(weights * per_example)
        grads = torch.autograd.grad(loss, params)
        grad_norm = tx.step(params, list(grads), state.opt_state)
        state.steps += 1
        sync_target(cfg, state)
        priorities = td.detach().abs()
        metrics = {
            "loss": loss.detach(),
            "raw_loss": per_example.detach().mean(),
            "priorities": priorities,
            "grad_norm": grad_norm,
            "mean_q_target_gap": priorities.mean(),
        }
        return state, metrics

    return init, train_step


# --------------------------------------------------------------------------
# Actor.
# --------------------------------------------------------------------------

def make_actor_step(num_actions: int) -> Callable:
    """Epsilon-greedy acting on scalar Q-values.

    ``act(net, obs, generator, epsilon) -> actions [B] int64``; the
    exploration draws come from ``generator`` on the obs' device.
    """

    @torch.no_grad()
    def act(net: nn.Module, obs: torch.Tensor,
            generator: Optional[torch.Generator], epsilon: float
            ) -> torch.Tensor:
        q = net.q_values(obs)
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=obs.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=obs.device) < epsilon
        return torch.where(explore, random_a, greedy)

    return act
