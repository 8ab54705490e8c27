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

A population's learner (``net`` a stacked module, models/qnets.py
``stack_networks``) takes one step for all M members: the loss runs under
``torch.func.vmap`` over the members' parameters and batches, the
gradients of the summed member losses flow back through ordinary autograd
(member m's parameters receive member m's gradient only), and one
:class:`ClipAdam` update clips each member by its own global norm and
steps it at its own rate (``make_population_optimizer``). The noise and
taus each member draws come from its own generator, in the order and
shapes of a solo step.

Both steps open profiler spans (utils/trace.py ``span``): the loss in
``learner.forward``, the gradients in ``learner.backward``, a mesh's
all-reduce in ``learner.allreduce``, Adam and the target sync in
``learner.optimizer``.
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
from dist_dqn_tpu_torch.models.qnets import (MemberView, draw_noise,
                                             member_forward, members_of)
from dist_dqn_tpu_torch.ops import losses
from dist_dqn_tpu_torch.types import Transition
from dist_dqn_tpu_torch.utils.trace import span


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
    # A population's per-member learning rates [M] (set_member_lr); None
    # steps at the config's schedule.
    lr: Optional[torch.Tensor] = None


def _per_member(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An [M] tensor viewed to broadcast over an [M, ...] parameter."""
    return x.view((-1,) + (1,) * (like.dim() - 1))


class ClipAdam:
    """Clip-by-global-norm + Adam with optax's formulas, applied in place.

    * clip: scale every gradient by ``max_norm / norm`` only when
      ``norm >= max_norm`` — optax's ``clip_by_global_norm`` (no ``+1e-6``,
      unlike ``torch.nn.utils.clip_grad_norm_``), chosen on the device with
      ``torch.where`` so no norm is read back;
    * adam: ``p -= lr(count) * m_hat / (sqrt(v_hat) + eps)`` — optax's eps
      placement, bias corrections ``1 - b**(count + 1)`` in float32.

    With ``members`` = M the parameters are a population's stacked [M, ...]
    tensors: each member is clipped by the global norm of its own
    gradients (a norm over the whole stack would couple the members), and
    steps at its own rate where the state holds one (``AdamState.lr``).
    """

    def __init__(self, cfg: LearnerConfig, b1: float = 0.9,
                 b2: float = 0.999, members: int = 0):
        self.max_norm = cfg.max_grad_norm
        self.eps = cfg.adam_eps
        self.b1, self.b2 = b1, b2
        self.lr = make_lr_schedule(cfg)
        self.members = members

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(count=0,
                         mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: AdamState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the global norm
        of the unclipped gradients ([M] norms for a population)."""
        # A solo net's norm is the one-member case of the members' norms.
        M = self.members or 1
        g_norm = torch.sqrt(sum((g * g).reshape(M, -1).sum(dim=1)
                                for g in grads))
        if self.max_norm:
            keep = g_norm < self.max_norm
            grads = [torch.where(_per_member(keep, g), g,
                                 (g / _per_member(g_norm, g))
                                 * self.max_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        step = -self.lr(state.count) if state.lr is None else -state.lr
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            p.add_((step if state.lr is None else _per_member(step, p))
                   * update)
        state.count = count
        return g_norm if self.members else g_norm[0]


def make_optimizer(cfg: LearnerConfig, members: int = 0) -> ClipAdam:
    """The learner's optimizer: clip-by-global-norm (when max_grad_norm is
    set) + Adam with the configured lr schedule; per member for a
    population of ``members``."""
    return ClipAdam(cfg, members=members)


def make_population_optimizer(cfg: LearnerConfig, members: int) -> ClipAdam:
    """The optimizer of a population whose members have their own learning
    rates (twin of the JAX ``make_population_optimizer``): the rates ride
    the optimizer state (:func:`set_member_lr`), so they compose with the
    constant schedule only."""
    if cfg.lr_schedule != "constant":
        raise ValueError(
            f"population per-member learning rates require "
            f"lr_schedule='constant', got {cfg.lr_schedule!r} (the "
            "anneal horizon is a trace-time constant, not a stackable "
            "member axis)")
    return ClipAdam(cfg, members=members)


def set_member_lr(state: "LearnerState", lr: torch.Tensor) -> "LearnerState":
    """Write the members' learning rates ([M] float32) into a population
    learner's optimizer state; every later step reads them there."""
    device = state.opt_state.mu[0].device
    state.opt_state.lr = lr.to(device=device, dtype=torch.float32)
    return state


# --------------------------------------------------------------------------
# Learner.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LearnerState:
    net: nn.Module          # online Q-network (the params)
    target_net: nn.Module   # target Q-network (the target params)
    opt_state: AdamState
    steps: int = 0          # completed gradient steps
    # NoisyNet noise and IQN tau draws of the train step (dqn.py:36); a
    # population's learner holds a list of M member generators.
    generator: Optional[torch.Generator] = None


def init_learner_state(net: nn.Module, tx: ClipAdam,
                       generator: Optional[torch.Generator] = None
                       ) -> LearnerState:
    """Wrap a built network into a :class:`LearnerState`: a distinct
    target copy, zeroed optimizer moments and the step's generator
    (default: seed 0 on the net's device)."""
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    if generator is None and members_of(net):
        raise ValueError("a population's learner needs its M member "
                         "generators")
    if generator is None:
        device = next(net.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)
    return LearnerState(net=net, target_net=target,
                        opt_state=tx.init(list(net.parameters())),
                        generator=generator)


def broadcast_learner(learner: LearnerState, axis) -> None:
    """Overwrite a learner's parameters, target and optimizer moments with
    rank 0's, in one broadcast: the replicas start equal whatever each
    rank's initialisation did."""
    opt = learner.opt_state
    axis.broadcast_([*learner.net.parameters(),
                     *learner.target_net.parameters(), *opt.mu, *opt.nu])


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
                 tx: Optional[ClipAdam] = None, axis=None):
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

    With ``axis`` (a :class:`~dist_dqn_tpu_torch.parallel.mesh.Mesh`) the
    step is one rank's of a data-parallel learner (``dqn.py:328-334``):
    the batch is the rank's row block, the gradients and the scalar
    metrics (``loss``, ``raw_loss``, ``mean_q_target_gap``) are averaged
    across ranks in one flat all-reduce before the optimizer step, so the
    clip sees the averaged gradient, and ``priorities`` stay the rank's
    own rows. IQN's taus are keyed by global batch position: every rank
    draws (or is given) the global ``[rows x size, num]`` block of each
    forward from its replicated generator and keeps its own rows, so a
    row-sharded step sees the fractions of the whole-batch step. A noisy
    net's layer noise is per parameter and needs nothing: the replicated
    generator draws the same noise on every rank. A population under a
    mesh is refused, as in JAX.
    """
    check_munchausen(cfg, net)
    members = members_of(net)
    if members and axis is not None:
        raise ValueError("a population's learner does not run under a "
                         "mesh (--population and --mesh-devices are "
                         "mutually exclusive)")
    if tx is None:
        tx = make_optimizer(cfg, members)

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

    # The forwards of one step that draw, in the order a solo step given
    # the generator draws them (the loss branches above).
    noisy_forwards = ("target",) + (
        ("next",) if cfg.munchausen or cfg.double_dqn else ()) + ("online",)

    def draw_step(generator: torch.Generator, batch_size: int) -> Draws:
        """A solo step's draws, taken up front: IQN's target then online
        taus, or each noisy forward's layer noise."""
        if kind == "iqn":
            dev = next(net.parameters()).device
            return {name: torch.rand(batch_size, num, generator=generator,
                                     device=dev)
                    for name, num in (("target", net.num_tau_target),
                                      ("online", net.num_tau))}
        return {name: draw_noise(net, generator) for name in noisy_forwards}

    def rank_taus(state: LearnerState, draws: Optional[Draws],
                  rows: int) -> Draws:
        """Under a mesh, IQN's draws of this rank's rows: the global
        block, drawn or given, cut to the rank's row block."""
        if draws is None:
            draws = draw_step(state.generator, rows * axis.size)
        block = axis.rows(rows)
        return {name: taus[block] for name, taus in draws.items()}

    def train_step(state: LearnerState, batch: Transition,
                   weights: Optional[torch.Tensor] = None,
                   draws: Optional[Draws] = None
                   ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        def source(name):
            if not random:
                return None
            return draws[name] if draws is not None else state.generator

        params = list(state.net.parameters())
        with span("learner.forward"):
            if weights is None:
                weights = torch.ones_like(batch.reward)
            if axis is not None and kind == "iqn":
                draws = rank_taus(state, draws, batch.reward.shape[0])
            per_example, priorities = loss_fn(state, batch, source)
            loss = torch.mean(weights * per_example)
        with span("learner.backward"):
            grads = list(torch.autograd.grad(loss, params))
        loss = loss.detach()
        raw_loss = per_example.detach().mean()
        mean_gap = priorities.mean()
        if axis is not None:
            # The gradient all-reduce over the dp axis, with the scalar
            # metrics riding the same flat buffer.
            with span("learner.allreduce"):
                *grads, loss, raw_loss, mean_gap = axis.pmean(
                    grads + [loss, raw_loss, mean_gap])
        with span("learner.optimizer"):
            grad_norm = tx.step(params, grads, state.opt_state)
            state.steps += 1
            sync_target(cfg, state)
        metrics = {
            "loss": loss,
            "raw_loss": raw_loss,
            "priorities": priorities,
            "grad_norm": grad_norm,
            "mean_q_target_gap": mean_gap,
        }
        return state, metrics

    def member_step(state: LearnerState, batch: Transition,
                    weights: Optional[torch.Tensor] = None,
                    draws: Optional[Draws] = None
                    ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
        """One step of every member: ``batch`` leaves and ``weights`` are
        [M, S, ...]; ``draws`` (optional) hold each forward's draws with
        a leading member axis. Metrics are [M] (priorities [M, S])."""
        params = dict(state.net.named_parameters())
        target_params = dict(state.target_net.named_parameters())

        def member_loss(p, tp, batch, weights, draws):
            views = _Views(MemberView(state.net, p),
                           MemberView(state.target_net, tp))
            per_example, priorities = loss_fn(
                views, batch, lambda name: draws[name] if random else None)
            return (torch.mean(weights * per_example),
                    per_example.detach().mean(), priorities)

        with span("learner.forward"):
            if weights is None:
                weights = torch.ones_like(batch.reward)
            if random and draws is None:
                S = batch.reward.shape[1]
                draws = _stack_trees([draw_step(g, S)
                                      for g in state.generator])
            loss, raw_loss, priorities = torch.func.vmap(
                member_loss, in_dims=(0, 0, 0, 0, 0 if random else None))(
                    params, target_params, batch, weights, draws)
        with span("learner.backward"):
            grads = torch.autograd.grad(loss.sum(), list(params.values()))
        with span("learner.optimizer"):
            grad_norm = tx.step(list(params.values()), list(grads),
                                state.opt_state)
            state.steps += 1
            sync_target(cfg, state)
        metrics = {
            "loss": loss.detach(),
            "raw_loss": raw_loss,
            "priorities": priorities,
            "grad_norm": grad_norm,
            "mean_q_target_gap": priorities.mean(dim=1),
        }
        return state, metrics

    return init, (member_step if members else train_step)


@dataclasses.dataclass
class _Views:
    """The (net, target_net) pair the loss branches read, as member
    views inside the population's vmap."""
    net: MemberView
    target_net: MemberView


def _stack_trees(trees):
    """Stack a list of same-shaped trees (dicts, tuples, tensors) leaf by
    leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return type(first)(_stack_trees(list(x)) for x in zip(*trees))


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
        if members_of(net):
            return act_members(net, obs, generator, epsilon)
        noise = generator if getattr(net, "noisy", False) else None
        q = net.q_values(obs, noise)
        greedy = q.argmax(dim=-1)
        random_a = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=obs.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=obs.device) < epsilon
        return torch.where(explore, random_a, greedy)

    def act_members(net, obs, generators, epsilon):
        """A population's step: obs [M, B, ...], one generator per member
        (its draws in a solo act's order: noise, actions, coins), epsilon
        an [M] tensor or a number; actions [M, B]."""
        B, dev = obs.shape[1], obs.device
        noisy = getattr(net, "noisy", False)
        noise, random_a, coins = [], [], []
        for g in generators:
            if noisy:
                noise.append(draw_noise(net, g))
            random_a.append(torch.randint(0, num_actions, (B,), generator=g,
                                          device=dev))
            coins.append(torch.rand((B,), generator=g, device=dev))
        q = member_forward(net, "q_values", obs,
                           _stack_trees(noise) if noisy else None)
        greedy = q.argmax(dim=-1)
        if isinstance(epsilon, torch.Tensor):
            epsilon = epsilon[:, None]
        explore = torch.stack(coins) < epsilon
        return torch.where(explore, torch.stack(random_a), greedy)

    return act
