"""CartPole-v1, batched in torch (twin of dist_dqn_tpu/envs/cartpole.py).

Classic Barto-Sutton-Anderson cart-pole as in gymnasium's CartPole-v1
(Euler integration, tau=0.02, force 10N, terminate at |x| > 2.4 or
|theta| > 12 deg, truncate at 500 steps, reward 1 per step, start state
uniform in [-0.05, 0.05]^4). The cheap env of the port's CPU loop tests.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from dist_dqn_tpu_torch.envs.base import TorchEnv

_GRAVITY = 9.8
_MASS_CART = 1.0
_MASS_POLE = 0.1
_TOTAL_MASS = _MASS_CART + _MASS_POLE
_LENGTH = 0.5  # half the pole length
_POLEMASS_LENGTH = _MASS_POLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_LIMIT = 12 * 2 * math.pi / 360
_X_LIMIT = 2.4


class CartPoleState(NamedTuple):
    phys: torch.Tensor  # [B, 4] = (x, x_dot, theta, theta_dot)
    t: torch.Tensor     # [B] int32 step count


class CartPoleDraws(NamedTuple):
    """The random numbers one batched step or reset may consume."""

    reset_phys: torch.Tensor  # [B, 4] f32 in [-0.05, 0.05)


class CartPole(TorchEnv):
    num_actions = 2
    observation_shape = (4,)
    observation_dtype = torch.float32

    def __init__(self, device, max_steps: int = 500):
        super().__init__(device)
        self.max_steps = max_steps

    def draw(self, num_envs: int, generator: torch.Generator
             ) -> CartPoleDraws:
        u = torch.rand((num_envs, 4), generator=generator, device=self.device)
        return CartPoleDraws(reset_phys=u * 0.1 - 0.05)

    def reset(self, draws: CartPoleDraws
              ) -> Tuple[CartPoleState, torch.Tensor]:
        phys = draws.reset_phys
        t = torch.zeros(phys.shape[:1], dtype=torch.int32, device=phys.device)
        return CartPoleState(phys=phys, t=t), phys

    def env_step(self, state: CartPoleState, action: torch.Tensor,
                 draws: CartPoleDraws):
        x, x_dot, theta, theta_dot = state.phys.unbind(dim=1)
        force = torch.where(action == 1, _FORCE_MAG, -_FORCE_MAG)
        cos_t = torch.cos(theta)
        sin_t = torch.sin(theta)
        temp = (force + _POLEMASS_LENGTH * theta_dot ** 2 * sin_t) / _TOTAL_MASS
        theta_acc = (_GRAVITY * sin_t - cos_t * temp) / (
            _LENGTH * (4.0 / 3.0 - _MASS_POLE * cos_t ** 2 / _TOTAL_MASS))
        x_acc = temp - _POLEMASS_LENGTH * theta_acc * cos_t / _TOTAL_MASS

        x = x + _TAU * x_dot
        x_dot = x_dot + _TAU * x_acc
        theta = theta + _TAU * theta_dot
        theta_dot = theta_dot + _TAU * theta_acc
        phys = torch.stack([x, x_dot, theta, theta_dot], dim=1)

        t = state.t + 1
        terminated = (x.abs() > _X_LIMIT) | (theta.abs() > _THETA_LIMIT)
        truncated = (t >= self.max_steps) & ~terminated
        reward = torch.ones_like(x)
        return (CartPoleState(phys=phys, t=t), phys, reward, terminated,
                truncated)
