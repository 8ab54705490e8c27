"""PixelCatch — the fast-learning Atari-shaped pixel task, batched in torch.

Twin of ``dist_dqn_tpu/envs/pixel_catch.py``: a ball falls from a random
column, the agent slides a paddle along the bottom row, ±1 on catch or
miss (about 26 steps an episode). A random policy catches rarely; a
working DQN approaches +1 within tens of thousands of frames, which is
what makes it the port's pixel learning bar. Observations keep the full
Atari shape, a [84, 84, 4] uint8 rolling frame stack, so a learning run
drives the same pipeline as the atari and apex presets. Actions: NOOP,
LEFT, RIGHT.

The two random numbers a reset consumes (the ball's column and the
paddle's position) are drawn up front by :meth:`PixelCatch.draw` and can
be injected instead (``CatchDraws``). A step draws nothing else.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dist_dqn_tpu_torch.envs.base import TorchEnv

_H = _W = 84
_PAD_HALF = 5          # paddle half-width (10 px wide)
_PAD_Y = 80.0          # paddle row
_BALL_SPEED = 3.0      # rows per step: ~26-step episodes
_PAD_SPEED = 3.0
_BALL_X = (4.0, _W - 5.0)                 # reset ball column ~ U(4, 79)
_PAD_X = (float(_PAD_HALF), _W - 1.0 - _PAD_HALF)   # paddle ~ U(5, 78)


class PixelCatchState(NamedTuple):
    ball_x: torch.Tensor   # [B] float32
    ball_y: torch.Tensor   # [B]
    pad_x: torch.Tensor    # [B]
    t: torch.Tensor        # [B] int32
    frames: torch.Tensor   # [B, 84, 84, 4] uint8


class CatchDraws(NamedTuple):
    """The random numbers one batched step or reset may consume."""

    reset_ball_x: torch.Tensor  # [B] f32 in [4, 79)
    reset_pad_x: torch.Tensor   # [B] f32 in [5, 78)


def _render(ball_x: torch.Tensor, ball_y: torch.Tensor, pad_x: torch.Tensor
            ) -> torch.Tensor:
    """Rasterize [B, 84, 84] uint8 frames with pure broadcasting."""
    dev = ball_x.device
    r = torch.arange(_H, dtype=torch.float32, device=dev)[None, :, None]
    c = torch.arange(_W, dtype=torch.float32, device=dev)[None, None, :]
    ball_m = ((r - ball_y[:, None, None]).abs() <= 1.5) & \
        ((c - ball_x[:, None, None]).abs() <= 1.5)
    pad_m = ((r - _PAD_Y).abs() <= 1.5) & \
        ((c - pad_x[:, None, None]).abs() <= _PAD_HALF)
    return ball_m.to(torch.uint8) * 255 | pad_m.to(torch.uint8) * 200


class PixelCatch(TorchEnv):
    num_actions = 3    # NOOP, LEFT, RIGHT (minimal-set convention)
    observation_shape = (_H, _W, 4)
    frame_stack = 4    # rolling stack (envs/base.py contract)
    observation_dtype = torch.uint8

    def __init__(self, device, max_steps: int = 200):
        super().__init__(device)
        self.max_steps = max_steps

    def draw(self, num_envs: int, generator: torch.Generator) -> CatchDraws:
        def uniform(lo_hi):
            lo, hi = lo_hi
            u = torch.rand(num_envs, generator=generator, device=self.device)
            return u * (hi - lo) + lo

        return CatchDraws(reset_ball_x=uniform(_BALL_X),
                          reset_pad_x=uniform(_PAD_X))

    def reset(self, draws: CatchDraws
              ) -> Tuple[PixelCatchState, torch.Tensor]:
        ball_x, pad_x = draws.reset_ball_x, draws.reset_pad_x
        B = ball_x.shape[0]
        ball_y = torch.full((B,), 4.0, device=self.device)
        frame = _render(ball_x, ball_y, pad_x)
        frames = frame[..., None].expand(B, _H, _W, 4).contiguous()
        return PixelCatchState(
            ball_x=ball_x, ball_y=ball_y, pad_x=pad_x,
            t=torch.zeros((B,), dtype=torch.int32, device=self.device),
            frames=frames), frames

    def env_step(self, state: PixelCatchState, action: torch.Tensor,
                 draws: CatchDraws):
        zero = torch.zeros_like(state.pad_x)
        dx = torch.where(action == 1, zero - _PAD_SPEED,
                         torch.where(action == 2, zero + _PAD_SPEED, zero))
        pad_x = (state.pad_x + dx).clamp(_PAD_HALF, _W - 1.0 - _PAD_HALF)
        ball_y = state.ball_y + _BALL_SPEED
        reached = ball_y >= _PAD_Y
        caught = reached & ((state.ball_x - pad_x).abs() <= _PAD_HALF + 1.5)
        reward = caught.float() - (reached & ~caught).float()
        t = state.t + 1
        terminated = reached
        truncated = (t >= self.max_steps) & ~terminated
        frame = _render(state.ball_x, ball_y, pad_x)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        new_state = PixelCatchState(ball_x=state.ball_x, ball_y=ball_y,
                                    pad_x=pad_x, t=t, frames=frames)
        return new_state, frames, reward, terminated, truncated
