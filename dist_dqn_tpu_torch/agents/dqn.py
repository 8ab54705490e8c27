"""The DQN learner and actor of the port (twin of dist_dqn_tpu/agents/dqn.py).

One train step for every feed-forward head (``dqn.py:130-363``): the
scalar head (double or max bootstrap, optionally value-rescaled, or
Munchausen's soft bootstrap and log-policy bonus; Huber TD loss, |TD|
priorities), C51 (projected categorical cross-entropy), QR-DQN and IQN
(quantile-Huber regression), each weighted by the PER importance weights;
for the distributional heads the priorities are the per-example loss.
NoisyNet heads draw fresh noise for each of the step's forwards, and IQN
fresh taus, from the learner's generator (the twin of
``LearnerState.rng``), or take them injected. A hand-written
clip-by-global-norm + Adam with optax's arithmetic (:class:`ClipAdam`);
hard or Polyak target sync (``dqn.py:340-350``, :func:`sync_target`,
shared with the R2D2 learner).

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
    # NoisyNet noise and IQN tau draws of the train step (dqn.py:36).
    generator: Optional[torch.Generator] = None


def init_learner_state(net: nn.Module, tx: ClipAdam,
                       generator: Optional[torch.Generator] = None
                       ) -> LearnerState:
    """Wrap a built network into a :class:`LearnerState`: a distinct
    target copy, zeroed optimizer moments and the step's generator
    (default: seed 0 on the net's device)."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    if generator is None:
        device = next(net.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
    return LearnerState(net=net, target_net=target,
                        opt_state=tx.init(list(net.parameters())),
                        generator=generator)


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


def head_kind(net: nn.Module) -> str:
    """The loss branch a feed-forward net takes: ``"c51"``, ``"qr"``,
    ``"iqn"`` or ``"scalar"`` (``dqn.py:156-160``)."""
    if getattr(net, "iqn", False):
        return "iqn"
    if getattr(net, "num_atoms", 1) > 1:
        return "qr" if getattr(net, "quantile", False) else "c51"
    return "scalar"


def check_munchausen(cfg: LearnerConfig, net: nn.Module) -> None:
    """The JAX learner's ``ValueError``s for Munchausen targets
    (``dqn.py:161-178``)."""
    if not cfg.munchausen:
        return
    if head_kind(net) != "scalar":
        raise ValueError(
            "munchausen targets are scalar-head only; unset munchausen "
            "or use a non-distributional network")
    if cfg.value_rescale:
        raise ValueError(
            "munchausen and value_rescale both transform the target; "
            "set only one")
    if cfg.n_step != 1:
        raise ValueError(
            "munchausen requires n_step=1: replay folds n-step rewards "
            "at sample time, so the per-step log-policy bonuses the "
            "soft recursion needs cannot be applied for n_step > 1")
    if cfg.double_dqn:
        raise ValueError(
            "munchausen replaces the max/double-Q bootstrap with the "
            "tau-logsumexp soft bootstrap, so double_dqn has no effect; "
            "set double_dqn=False (the mdqn preset does)")


# A train step's injected draws: per forward ("online", "next", "target"),
# a noisy net's layer noise (models/qnets.py ``Noise``) or IQN's taus.
Draws = Dict[str, object]


def make_learner(cfg: LearnerConfig, net: nn.Module,
                 tx: Optional[ClipAdam] = None):
    """Build (init, train_step) for the feed-forward Q-network ``net``,
    of any head; its head picks the loss branch, as the JAX
    ``make_learner(net, cfg)``'s does. ``init(net, generator=None)`` wraps
    the built network into a :class:`LearnerState`.
    ``train_step(state, batch, weights, draws=None) -> (state, metrics)``;
    metrics holds device tensors ``loss``, ``raw_loss``, ``priorities`` [S]
    (|TD| for the scalar head, the per-example loss otherwise),
    ``grad_norm`` and ``mean_q_target_gap`` (the priorities' mean).
    ``draws`` injects the noise or taus of the step's forwards, keyed
    "online", "next" and "target"; without it they come from
    ``state.generator``: three independent noise draws for a noisy net
    (``dqn.py:197``), the online and target taus for IQN.
    """
    check_munchausen(cfg, net)
    if tx is None:
        tx = make_optimizer(cfg)

    kind = head_kind(net)
    # What each forward draws from: nothing for a deterministic head.
    random = kind == "iqn" or getattr(net, "noisy", False)

    def init(net: nn.Module, generator: Optional[torch.Generator] = None
             ) -> LearnerState:
        return init_learner_state(net, tx, generator)

    def scalar_loss(state, batch, source):
        net, target_net = state.net, state.target_net
        with torch.no_grad():
            q_next_target = target_net(batch.next_obs, source("target"))
            if cfg.munchausen:
                boot = losses.munchausen_soft_bootstrap(q_next_target,
                                                        cfg.munchausen_tau)
                bonus = losses.munchausen_bonus(
                    target_net(batch.obs, source("next")), batch.action,
                    cfg.munchausen_alpha, cfg.munchausen_tau,
                    cfg.munchausen_clip)
                target = batch.reward + bonus + batch.discount * boot
            else:
                if cfg.double_dqn:
                    boot = losses.double_q_bootstrap(
                        net(batch.next_obs, source("next")), q_next_target)
                else:
                    boot = q_next_target.max(dim=-1).values
                if cfg.value_rescale:
                    boot = losses.inv_value_rescale(boot)
                target = batch.reward + batch.discount * boot
                if cfg.value_rescale:
                    target = losses.value_rescale(target)
        q = net(batch.obs, source("online"))
        td = q.gather(-1, batch.action.long()[:, None])[:, 0] - target
        return losses.huber(td, cfg.huber_delta), td.detach().abs()

    def c51_loss(state, batch, source):
        net, target_net = state.net, state.target_net
        with torch.no_grad():
            logits_next_target = target_net(batch.next_obs, source("target"))
            # Non-double: the target net picks its own greedy action.
            selector = (net(batch.next_obs, source("next"))
                        if cfg.double_dqn else logits_next_target)
            atoms = net.atoms(logits_next_target.device)
            next_probs = losses.categorical_double_q_probs(
                selector, logits_next_target, atoms)
            target_probs = losses.categorical_projection(
                atoms, next_probs, batch.reward, batch.discount)
        per_example = losses.categorical_td_loss(
            net(batch.obs, source("online")), batch.action, target_probs)
        return per_example, per_example.detach()

    def qr_loss(state, batch, source):
        net, target_net = state.net, state.target_net
        with torch.no_grad():
            theta_next_target = target_net(batch.next_obs, source("target"))
            selector = (net(batch.next_obs, source("next"))
                        if cfg.double_dqn else theta_next_target)
            next_theta = losses.quantile_double_q_select(
                selector, theta_next_target)
            target_theta = (batch.reward[:, None]
                            + batch.discount[:, None] * next_theta)
        theta_a = losses.take_action(net(batch.obs, source("online")),
                                      batch.action)
        per_example = losses.quantile_huber_td(theta_a, target_theta,
                                               cfg.huber_delta)
        return per_example, per_example.detach()

    def iqn_loss(state, batch, source):
        net, target_net = state.net, state.target_net
        with torch.no_grad():
            theta_next_target, _ = target_net.sample_quantiles(
                batch.next_obs, net.num_tau_target, source("target"))
            # Double-Q selects by the online net's acting fractions.
            q_sel = (net.q_values(batch.next_obs) if cfg.double_dqn
                     else theta_next_target.mean(dim=-1))
            next_theta = losses.take_action(theta_next_target,
                                             q_sel.argmax(dim=-1))
            target_theta = (batch.reward[:, None]
                            + batch.discount[:, None] * next_theta)
        theta, taus = net.sample_quantiles(batch.obs, net.num_tau,
                                           source("online"))
        per_example = losses.iqn_quantile_huber_td(
            losses.take_action(theta, batch.action), taus, target_theta,
            cfg.huber_delta)
        return per_example, per_example.detach()

    loss_fn = {"scalar": scalar_loss, "c51": c51_loss, "qr": qr_loss,
               "iqn": iqn_loss}[kind]

    def train_step(state: LearnerState, batch: Transition,
                   weights: Optional[torch.Tensor] = None,
                   draws: Optional[Draws] = None
                   ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        if weights is None:
            weights = torch.ones_like(batch.reward)

        def source(name):
            if not random:
                return None
            return draws[name] if draws is not None else state.generator

        params = list(state.net.parameters())
        per_example, priorities = loss_fn(state, batch, source)
        loss = torch.mean(weights * per_example)
        grads = torch.autograd.grad(loss, params)
        grad_norm = tx.step(params, list(grads), state.opt_state)
        state.steps += 1
        sync_target(cfg, state)
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
    """Epsilon-greedy acting on scalar Q-values (any head type).

    ``act(net, obs, generator, epsilon) -> actions [B] int64``; the
    exploration draws come from ``generator`` on the obs' device. A noisy
    net also draws its noise from it, once per call, shared by every lane
    (``dqn.py:428-434``); with epsilon 0 that noise is all the exploration.
    """

    @torch.no_grad()
    def act(net: nn.Module, obs: torch.Tensor,
            generator: Optional[torch.Generator], epsilon: float
            ) -> torch.Tensor:
        noise = generator if getattr(net, "noisy", False) else None
        q = net.q_values(obs, noise)
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=obs.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=obs.device) < epsilon
        return torch.where(explore, random_a, greedy)

    return act
