"""TD-loss family of the port (twin of dist_dqn_tpu/ops/losses.py): the
scalar head's Huber loss and double-Q bootstrap, Munchausen-DQN's soft
bootstrap and log-policy bonus, R2D2's value rescaling, the C51
categorical projection and cross-entropy, and the QR-DQN / IQN
quantile-Huber regression.

The JAX package's stop-gradient points are ``.detach()`` at the same
places: the C51 target probs, the quantile targets and the taus. Every
loss is computed in float32.
"""
from __future__ import annotations

import torch


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber loss elementwise; quadratic within ``delta``, linear outside.
    Computed in float32 regardless of the input dtype (the per-example
    values double as PER priorities and IS-weighted loss terms)."""
    abs_x = x.float().abs()
    quad = torch.clamp(abs_x, max=delta)
    return 0.5 * quad * quad + delta * (abs_x - quad)


def double_q_bootstrap(q_next_online: torch.Tensor,
                       q_next_target: torch.Tensor) -> torch.Tensor:
    """Double-DQN bootstrap: argmax from online net, value from target net.
    ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``."""
    a_star = q_next_online.argmax(dim=-1, keepdim=True)
    return q_next_target.gather(-1, a_star)[..., 0]


def take_action(x: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """``x[b, actions[b]]`` along axis 1: [B, A] -> [B], [B, A, M] -> [B, M]."""
    index = actions.long().view((-1, 1) + (1,) * (x.dim() - 2))
    return x.gather(1, index.expand((-1, 1) + tuple(x.shape[2:])))[:, 0]


# --------------------------------------------------------------------------
# Munchausen-DQN (Vieillard et al., 2020).
# --------------------------------------------------------------------------

def munchausen_soft_bootstrap(q_next_target: torch.Tensor,
                              tau: float) -> torch.Tensor:
    """Soft state value from the target net, tau * logsumexp(q / tau) (the
    stable form of sum_a' pi(a'|s') (q - tau log pi)). [B, A] -> [B]."""
    return tau * torch.logsumexp(q_next_target / tau, dim=-1)


def munchausen_bonus(q_obs_target: torch.Tensor, actions: torch.Tensor,
                     alpha: float, tau: float, clip_low: float
                     ) -> torch.Tensor:
    """alpha * clip(tau * log pi(a|s), clip_low, 0) with pi = softmax(q /
    tau) from the target net at the stored observation. [B, A], [B] ->
    [B]."""
    log_pi = torch.log_softmax(q_obs_target / tau, dim=-1)
    log_pi_a = take_action(log_pi, actions)
    return alpha * torch.clamp(tau * log_pi_a, clip_low, 0.0)


# --------------------------------------------------------------------------
# R2D2 value rescaling.
# --------------------------------------------------------------------------

def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """R2D2's h(x) = sign(x) (sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def inv_value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Exact inverse of :func:`value_rescale` (closed form)."""
    inner = torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps))
    return torch.sign(x) * (torch.square((inner - 1.0) / (2.0 * eps)) - 1.0)


# --------------------------------------------------------------------------
# C51 categorical distributional RL.
# --------------------------------------------------------------------------

def categorical_projection(atoms: torch.Tensor, next_probs: torch.Tensor,
                           rewards: torch.Tensor, discounts: torch.Tensor
                           ) -> torch.Tensor:
    """Project the Bellman-shifted target distribution back onto ``atoms``
    [M]: ``next_probs`` [B, M], ``rewards`` / ``discounts`` [B] -> [B, M],
    rows summing to 1.

    Source atom i, landing at fractional position b_i, gives relu(1 -
    |b_i - j|) of its mass to atom j: an elementwise [B, M, M] weight and a
    sum, not a matmul, so the contraction stays in full float32 where a
    TF32 matmul would round its inputs (the JAX package keeps the same form
    for the same reason)."""
    v_min, v_max = atoms[0], atoms[-1]
    m = atoms.shape[0]
    dz = (v_max - v_min) / (m - 1)
    tz = rewards[:, None] + discounts[:, None] * atoms[None, :]
    tz = torch.clamp(tz, v_min, v_max)
    b = (tz - v_min) / dz
    j = torch.arange(m, dtype=b.dtype, device=b.device)
    w = torch.clamp(1.0 - (b[:, :, None] - j[None, None, :]).abs(), min=0.0)
    return torch.sum(next_probs[:, :, None] * w, dim=1)


def categorical_double_q_probs(logits_next_online: torch.Tensor,
                               logits_next_target: torch.Tensor,
                               atoms: torch.Tensor) -> torch.Tensor:
    """The next greedy action by the online logits' expected value; the
    target net's probs there. logits [B, A, M], atoms [M] -> [B, M]."""
    probs_online = torch.softmax(logits_next_online, dim=-1)
    q_online = torch.sum(probs_online * atoms, dim=-1)
    a_star = q_online.argmax(dim=-1)
    return torch.softmax(take_action(logits_next_target, a_star), dim=-1)


def categorical_td_loss(logits: torch.Tensor, actions: torch.Tensor,
                        target_probs: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy of the detached projected target against
    the predicted distribution at the taken action. [B, A, M], [B], [B, M]
    -> [B] (also the Rainbow priority signal)."""
    log_p = torch.log_softmax(take_action(logits, actions), dim=-1)
    return -torch.sum(target_probs.detach() * log_p, dim=-1)


# --------------------------------------------------------------------------
# QR-DQN (Dabney et al., 2018) and IQN (Dabney et al., 2018b).
# --------------------------------------------------------------------------

def quantile_midpoints(num_quantiles: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """tau-hat_i = (2i + 1) / 2N, the quantile fraction of each output."""
    return (torch.arange(num_quantiles, dtype=dtype, device=device) + 0.5) \
        / num_quantiles


def quantile_double_q_select(theta_next_selector: torch.Tensor,
                             theta_next_target: torch.Tensor
                             ) -> torch.Tensor:
    """Greedy action by the selector's mean over quantiles; the target's
    quantile values there. [B, A, N] -> [B, N]."""
    a_star = theta_next_selector.mean(dim=-1).argmax(dim=-1)
    return take_action(theta_next_target, a_star)


def quantile_huber_td(theta_a: torch.Tensor, target_theta: torch.Tensor,
                      kappa: float = 1.0) -> torch.Tensor:
    """QR-DQN's per-example quantile-Huber loss: :func:`iqn_quantile_huber_td`
    at the fixed midpoints. theta_a [B, N], target_theta [B, M] -> [B]."""
    n = theta_a.shape[-1]
    taus = quantile_midpoints(n, theta_a.dtype, theta_a.device)[None, :]
    return iqn_quantile_huber_td(theta_a, taus.expand(theta_a.shape),
                                 target_theta, kappa)


def iqn_quantile_huber_td(theta_a: torch.Tensor, taus: torch.Tensor,
                          target_theta: torch.Tensor, kappa: float = 1.0
                          ) -> torch.Tensor:
    """Per-example quantile-Huber loss at the fractions ``taus`` [B, N] the
    predictions ``theta_a`` [B, N] were made at, against the Bellman
    target samples ``target_theta`` [B, M] (detached here, as are the
    taus): sum over i of the mean over j of |tau_i - 1{u_ij < 0}| *
    Huber_kappa(u_ij) / kappa, u_ij = target_j - theta_i. -> [B]."""
    u = target_theta.detach()[:, None, :] - theta_a[:, :, None]   # [B, N, M]
    tau = taus.detach()[:, :, None]
    weight = (tau - (u < 0.0).to(theta_a.dtype)).abs()
    return torch.sum(torch.mean(weight * huber(u, kappa) / kappa, dim=2),
                     dim=1)
