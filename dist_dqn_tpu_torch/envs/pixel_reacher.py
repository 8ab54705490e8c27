"""PixelReacher — the DM-Control-reacher-shaped pixel task, batched in torch.

Twin of ``dist_dqn_tpu/envs/pixel_reacher.py`` (the rainbow preset's
``dmc_pixels`` env): a 2-link arm anchored at the arena's centre, a random
target, a sparse reward of 1 while the fingertip is within 5 px of the
target, fixed-length episodes (DMC semantics: time-limit truncation at
``max_steps``, never termination), rasterised to 84x84 grayscale with a
rolling 4-frame stack. Actions: the 3x3 torque grid {-1, 0, +1}^2 (9
actions). ``shaping > 0`` adds a dense ``-shaping * dist / arm length``
term.

The random numbers a reset consumes (the joint angles theta ~ U(-pi, pi)^2
and the target's distance and angle from the anchor) are drawn up front by
:meth:`PixelReacher.draw` and can be injected instead (``ReacherDraws``).
A step draws nothing else.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from dist_dqn_tpu_torch.envs.base import TorchEnv

_H = _W = 84
_CX = _CY = 42.0       # arm anchor (arena center)
_L1, _L2 = 18.0, 14.0  # link lengths (px)
_DT = 0.25
_TORQUE = 2.0
_DAMPING = 0.12
_MAX_VEL = 6.0
_TARGET_R = 5.0        # in-target radius (px)
_TARGET_DIST = (8.0, _L1 + _L2 - 3.0)
# 9 actions = {-1, 0, +1} torque per joint.
_ACTION_TORQUE = [[i - 1, j - 1] for i in range(3) for j in range(3)]


class PixelReacherState(NamedTuple):
    theta: torch.Tensor      # [B, 2] joint angles
    theta_dot: torch.Tensor  # [B, 2] joint velocities
    target: torch.Tensor     # [B, 2] (x, y) px
    t: torch.Tensor          # [B] int32
    frames: torch.Tensor     # [B, 84, 84, 4] uint8


class ReacherDraws(NamedTuple):
    """The random numbers one batched step or reset may consume."""

    reset_theta: torch.Tensor        # [B, 2] f32 in [-pi, pi)
    reset_target_dist: torch.Tensor  # [B] f32 in [8, 29)
    reset_target_ang: torch.Tensor   # [B] f32 in [0, 2 pi)


def _tip_positions(theta: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elbow and fingertip pixel coordinates [B, 2] for angles [B, 2]."""
    a1 = theta[:, 0]
    a2 = theta[:, 0] + theta[:, 1]
    elbow = torch.stack([_CX + _L1 * torch.cos(a1),
                         _CY + _L1 * torch.sin(a1)], dim=-1)
    tip = elbow + torch.stack([_L2 * torch.cos(a2), _L2 * torch.sin(a2)],
                              dim=-1)
    return elbow, tip


def _grid(device) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.arange(_H, dtype=torch.float32, device=device)[None, :, None]
    c = torch.arange(_W, dtype=torch.float32, device=device)[None, None, :]
    return r, c


def _segment_mask(a: torch.Tensor, b: torch.Tensor, half_width: float
                  ) -> torch.Tensor:
    """[B, 84, 84] bool: pixels within ``half_width`` of segment a->b."""
    r, c = _grid(a.device)
    ab = b - a
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-6)
    ax, ay = a[:, 0, None, None], a[:, 1, None, None]
    abx, aby = ab[:, 0, None, None], ab[:, 1, None, None]
    # Project each pixel onto the segment, clamp to [0, 1].
    tproj = ((c - ax) * abx + (r - ay) * aby) / denom[:, None, None]
    tproj = torch.clamp(tproj, 0.0, 1.0)
    dx = c - (ax + tproj * abx)
    dy = r - (ay + tproj * aby)
    return dx * dx + dy * dy <= half_width * half_width


def _render(theta: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """[B, 84, 84] uint8 frames of the arm and the target ring."""
    elbow, tip = _tip_positions(theta)
    anchor = torch.tensor([_CX, _CY], dtype=torch.float32,
                          device=theta.device).expand_as(elbow)
    link1 = _segment_mask(anchor, elbow, 1.5)
    link2 = _segment_mask(elbow, tip, 1.5)
    r, c = _grid(theta.device)
    d2_target = ((c - target[:, 0, None, None]) ** 2
                 + (r - target[:, 1, None, None]) ** 2)
    ring = (d2_target <= _TARGET_R ** 2) & \
        (d2_target >= (_TARGET_R - 2.0) ** 2)
    d2_tip = (c - tip[:, 0, None, None]) ** 2 + (r - tip[:, 1, None, None]) ** 2
    tip_m = d2_tip <= 4.0
    u8 = torch.uint8
    return torch.maximum(
        torch.maximum(link1.to(u8) * 150, link2.to(u8) * 150),
        torch.maximum(ring.to(u8) * 255, tip_m.to(u8) * 230))


class PixelReacher(TorchEnv):
    num_actions = 9
    observation_shape = (_H, _W, 4)
    frame_stack = 4    # rolling stack (envs/base.py contract)
    observation_dtype = torch.uint8

    def __init__(self, device, max_steps: int = 1000, shaping: float = 0.0):
        super().__init__(device)
        self.max_steps = max_steps
        self.shaping = shaping
        self._torque = torch.tensor(_ACTION_TORQUE, dtype=torch.float32,
                                    device=self.device)

    def draw(self, num_envs: int, generator: torch.Generator
             ) -> ReacherDraws:
        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=self.device)
            return u * (hi - lo) + lo

        return ReacherDraws(
            reset_theta=uniform((num_envs, 2), -math.pi, math.pi),
            reset_target_dist=uniform((num_envs,), *_TARGET_DIST),
            reset_target_ang=uniform((num_envs,), 0.0, 2.0 * math.pi))

    def reset(self, draws: ReacherDraws
              ) -> Tuple[PixelReacherState, torch.Tensor]:
        theta = draws.reset_theta
        dist, ang = draws.reset_target_dist, draws.reset_target_ang
        target = torch.stack([_CX + dist * torch.cos(ang),
                              _CY + dist * torch.sin(ang)], dim=-1)
        B = theta.shape[0]
        frame = _render(theta, target)
        frames = frame[..., None].expand(B, _H, _W, 4).contiguous()
        return PixelReacherState(
            theta=theta, theta_dot=torch.zeros_like(theta), target=target,
            t=torch.zeros((B,), dtype=torch.int32, device=self.device),
            frames=frames), frames

    def env_step(self, state: PixelReacherState, action: torch.Tensor,
                 draws: ReacherDraws):
        torque = self._torque[action.long().clamp(0, 8)]
        theta_dot = state.theta_dot * (1.0 - _DAMPING) \
            + torque * _TORQUE * _DT
        theta_dot = theta_dot.clamp(-_MAX_VEL, _MAX_VEL)
        theta = state.theta + theta_dot * _DT
        _, tip = _tip_positions(theta)
        dist = torch.sqrt(torch.sum((tip - state.target) ** 2, dim=-1))
        reward = (dist <= _TARGET_R).float()
        if self.shaping:
            reward = reward - self.shaping * dist / (_L1 + _L2)
        frame = _render(theta, state.target)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        t = state.t + 1
        terminated = torch.zeros_like(reward, dtype=torch.bool)
        truncated = t >= self.max_steps
        new_state = PixelReacherState(theta=theta, theta_dot=theta_dot,
                                      target=state.target, t=t, frames=frames)
        return new_state, frames, reward, terminated, truncated
