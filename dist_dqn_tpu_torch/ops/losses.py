"""TD-loss pieces of the scalar head (twin of dist_dqn_tpu/ops/losses.py:16-62).

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
