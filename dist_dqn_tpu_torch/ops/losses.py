"""TD-loss pieces of the scalar head (twin of dist_dqn_tpu/ops/losses.py:16-62)
and R2D2's value rescaling (``:115-122``).

The distributional losses (C51 projection, quantile, IQN, Munchausen)
come with the distributional-heads slice of the port.
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


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """R2D2's h(x) = sign(x) (sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def inv_value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Exact inverse of :func:`value_rescale` (closed form)."""
    inner = torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps))
    return torch.sign(x) * (torch.square((inner - 1.0) / (2.0 * eps)) - 1.0)
