"""PixelPong — the Atari-shaped 84x84 pixel environment, batched in torch.

Twin of ``dist_dqn_tpu/envs/pixel_pong.py``: 84x84 grayscale frames,
4-frame stacking, 6 Atari-style actions, ±1 point rewards, first-to-5
episodes. Physics, rasterization and frame stacking are branch-free
tensor ops over the env batch, so every lane steps on the device at once.

The three random numbers a step may consume (the serve ``vy`` after a
point, and the side and ``vy`` of an auto-reset serve) are drawn up front
by :meth:`PixelPong.draw` and can be injected instead (``PongDraws``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dist_dqn_tpu_torch.envs.base import TorchEnv

_H = _W = 84
_PAD_HALF = 4          # paddle half-height (8 px tall)
_AGENT_X = 78.0        # agent paddle column (2 px wide)
_OPP_X = 4.0
_BALL_SPEED_X = 1.6
_PAD_SPEED = 2.0
_OPP_SPEED = 1.0
_WIN_SCORE = 5

# Atari Pong action semantics: NOOP, FIRE, UP, DOWN, UPFIRE, DOWNFIRE.
_ACTION_DY = (0.0, 0.0, -_PAD_SPEED, _PAD_SPEED, -_PAD_SPEED, _PAD_SPEED)


class PixelPongState(NamedTuple):
    ball: torch.Tensor    # [B, 4] = (x, y, vx, vy) float32
    pad_y: torch.Tensor   # [B] agent paddle center
    opp_y: torch.Tensor   # [B] opponent paddle center
    score: torch.Tensor   # [B, 2] int32 = (agent, opponent)
    t: torch.Tensor       # [B] int32
    frames: torch.Tensor  # [B, 84, 84, 4] uint8 frame stack


class PongDraws(NamedTuple):
    """The random numbers one batched step or reset may consume."""

    serve_vy: torch.Tensor    # [B] f32 in [-1, 1): serve after a point
    reset_side: torch.Tensor  # [B] bool: reset serve goes toward the agent
    reset_vy: torch.Tensor    # [B] f32 in [-1, 1): reset serve's vy


def _render(ball: torch.Tensor, pad_y: torch.Tensor, opp_y: torch.Tensor
            ) -> torch.Tensor:
    """Rasterize [B, 84, 84] uint8 frames with pure broadcasting."""
    dev = ball.device
    r = torch.arange(_H, dtype=torch.float32, device=dev)[None, :, None]
    c = torch.arange(_W, dtype=torch.float32, device=dev)[None, None, :]
    bx = ball[:, 0, None, None]
    by = ball[:, 1, None, None]
    ball_m = ((r - by).abs() <= 1.0) & ((c - bx).abs() <= 1.0)
    pad_m = ((r - pad_y[:, None, None]).abs() <= _PAD_HALF) & \
        ((c - _AGENT_X).abs() <= 1.0)
    opp_m = ((r - opp_y[:, None, None]).abs() <= _PAD_HALF) & \
        ((c - _OPP_X).abs() <= 1.0)
    return (ball_m.to(torch.uint8) * 255
            | pad_m.to(torch.uint8) * 200
            | opp_m.to(torch.uint8) * 200)


def _serve(vy: torch.Tensor, toward_agent: torch.Tensor) -> torch.Tensor:
    """New balls [B, 4] at center; vx toward the given side, vy given."""
    vx = torch.where(toward_agent, _BALL_SPEED_X, -_BALL_SPEED_X)
    center_x = torch.full_like(vy, _W / 2.0)
    center_y = torch.full_like(vy, _H / 2.0)
    return torch.stack([center_x, center_y, vx.to(vy.dtype), vy], dim=1)


class PixelPong(TorchEnv):
    num_actions = 6
    observation_shape = (_H, _W, 4)
    frame_stack = 4  # rolling stack (envs/base.py contract)
    observation_dtype = torch.uint8

    def __init__(self, device, max_steps: int = 2000):
        super().__init__(device)
        self.max_steps = max_steps
        self._action_dy = torch.tensor(_ACTION_DY, dtype=torch.float32,
                                       device=self.device)

    def draw(self, num_envs: int, generator: torch.Generator) -> PongDraws:
        def uniform_pm1():
            u = torch.rand(num_envs, generator=generator, device=self.device)
            return u * 2.0 - 1.0

        side = torch.rand(num_envs, generator=generator,
                          device=self.device) < 0.5
        return PongDraws(serve_vy=uniform_pm1(), reset_side=side,
                         reset_vy=uniform_pm1())

    def reset(self, draws: PongDraws) -> Tuple[PixelPongState, torch.Tensor]:
        ball = _serve(draws.reset_vy, draws.reset_side)
        B = ball.shape[0]
        pad_y = torch.full((B,), _H / 2.0, device=self.device)
        opp_y = torch.full((B,), _H / 2.0, device=self.device)
        frame = _render(ball, pad_y, opp_y)
        frames = frame[..., None].expand(B, _H, _W, 4).contiguous()
        state = PixelPongState(
            ball=ball, pad_y=pad_y, opp_y=opp_y,
            score=torch.zeros((B, 2), dtype=torch.int32, device=self.device),
            t=torch.zeros((B,), dtype=torch.int32, device=self.device),
            frames=frames)
        return state, frames

    def env_step(self, state: PixelPongState, action: torch.Tensor,
                 draws: PongDraws):
        # Paddles.
        dy = self._action_dy[action.long().clamp(0, 5)]
        pad_y = (state.pad_y + dy).clamp(_PAD_HALF, _H - 1 - _PAD_HALF)
        opp_dy = (state.ball[:, 1] - state.opp_y).clamp(-_OPP_SPEED,
                                                        _OPP_SPEED)
        opp_y = (state.opp_y + opp_dy).clamp(_PAD_HALF, _H - 1 - _PAD_HALF)

        # Ball motion with top/bottom bounce.
        bx = state.ball[:, 0] + state.ball[:, 2]
        by = state.ball[:, 1] + state.ball[:, 3]
        vy = torch.where((by <= 1.0) | (by >= _H - 2.0), -state.ball[:, 3],
                         state.ball[:, 3])
        by = by.clamp(1.0, _H - 2.0)
        vx = state.ball[:, 2]

        # Paddle collisions: reflect and add spin from the hit offset.
        hit_agent = (bx >= _AGENT_X - 1.0) & (vx > 0) & \
            ((by - pad_y).abs() <= _PAD_HALF + 1.0)
        hit_opp = (bx <= _OPP_X + 1.0) & (vx < 0) & \
            ((by - opp_y).abs() <= _PAD_HALF + 1.0)
        zero = torch.zeros_like(by)
        spin = torch.where(hit_agent, (by - pad_y) / _PAD_HALF * 0.8,
                           torch.where(hit_opp, (by - opp_y) / _PAD_HALF * 0.8,
                                       zero))
        vx = torch.where(hit_agent | hit_opp, -vx, vx)
        vy = (vy + spin).clamp(-1.8, 1.8)
        bx = torch.where(hit_agent, torch.full_like(bx, _AGENT_X - 1.0),
                         torch.where(hit_opp, torch.full_like(bx, _OPP_X + 1.0),
                                     bx))

        # Scoring: ball past a paddle column.
        agent_point = bx <= 1.0     # opponent missed
        opp_point = bx >= _W - 2.0  # agent missed
        point = agent_point | opp_point
        reward = agent_point.float() - opp_point.float()
        score = state.score + torch.stack(
            [agent_point.int(), opp_point.int()], dim=1)

        served = _serve(draws.serve_vy, toward_agent=opp_point)
        ball = torch.where(point[:, None], served,
                           torch.stack([bx, by, vx, vy], dim=1))

        frame = _render(ball, pad_y, opp_y)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        t = state.t + 1
        terminated = score.max(dim=1).values >= _WIN_SCORE
        truncated = (t >= self.max_steps) & ~terminated
        new_state = PixelPongState(ball=ball, pad_y=pad_y, opp_y=opp_y,
                                   score=score, t=t, frames=frames)
        return new_state, frames, reward, terminated, truncated
