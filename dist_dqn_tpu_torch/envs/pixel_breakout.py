"""PixelBreakout — the Atari-shaped 84x84 Breakout, batched in torch.

Twin of ``dist_dqn_tpu/envs/pixel_breakout.py``: a 6 x 12 brick wall,
FIRE-to-serve, 5 lives, +1 per brick (72 at most), 84x84 grayscale frames
in a rolling 4-frame stack. Actions follow the minimal-ALE Breakout set:
NOOP, FIRE, RIGHT, LEFT. While the ball is not in play only FIRE serves
it; losing the ball costs a life, and the episode ends when the lives run
out or the wall is cleared. Physics, brick collisions, rasterization and
frame stacking are branch-free tensor ops over the env batch.

The one random number a step may consume, the serve's ``vx``, is drawn up
front by :meth:`PixelBreakout.draw` and can be injected instead
(``BreakoutDraws``). A reset draws nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dist_dqn_tpu_torch.envs.base import TorchEnv

_H = _W = 84
_ROWS, _COLS = 6, 12
_BRICK_H, _BRICK_W = 3, 7      # 6x3 rows of 12x7 bricks = rows 18..35
_WALL_TOP = 18.0
_WALL_BOT = _WALL_TOP + _ROWS * _BRICK_H
_PAD_Y = 78.0
_PAD_HALF = 4.0                # 8 px paddle
_PAD_SPEED = 3.0
_BALL_SPEED_Y = 2.0
_SERVE_VX = 1.2                # serve vx ~ U(-1.2, 1.2)
_LIVES = 5


class PixelBreakoutState(NamedTuple):
    ball: torch.Tensor      # [B, 4] = (x, y, vx, vy) float32
    pad_x: torch.Tensor     # [B] paddle center column
    bricks: torch.Tensor    # [B, 6, 12] float32 (1 = alive)
    lives: torch.Tensor     # [B] int32
    in_play: torch.Tensor   # [B] bool — False until FIRE serves
    t: torch.Tensor         # [B] int32
    frames: torch.Tensor    # [B, 84, 84, 4] uint8 frame stack


class BreakoutDraws(NamedTuple):
    """The random numbers one batched step may consume."""

    serve_vx: torch.Tensor  # [B] f32 in [-1.2, 1.2): a FIRE serve's vx


def _cells(y: torch.Tensor, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brick (row, column) under pixel coordinates, clamped to the wall."""
    row = ((y - _WALL_TOP) // _BRICK_H).to(torch.int64).clamp(0, _ROWS - 1)
    col = (x // _BRICK_W).to(torch.int64).clamp(0, _COLS - 1)
    return row, col


def _render(ball: torch.Tensor, pad_x: torch.Tensor, bricks: torch.Tensor,
            in_play: torch.Tensor) -> torch.Tensor:
    """Rasterize [B, 84, 84] uint8 frames with pure broadcasting."""
    dev = ball.device
    r = torch.arange(_H, dtype=torch.float32, device=dev)[:, None]
    c = torch.arange(_W, dtype=torch.float32, device=dev)[None, :]
    # Brick wall: map each pixel to its brick cell and gather liveness.
    cell_r, cell_c = _cells(r, c)                              # [84,1], [1,84]
    in_wall = (r >= _WALL_TOP) & (r < _WALL_BOT) & (c < _COLS * _BRICK_W)
    brick_m = in_wall[None] & (bricks[:, cell_r, cell_c] > 0.5)
    bx = ball[:, 0, None, None]
    by = ball[:, 1, None, None]
    ball_m = in_play[:, None, None] & ((r - by).abs() <= 1.0) & \
        ((c - bx).abs() <= 1.0)
    pad_m = ((r - _PAD_Y).abs() <= 1.0)[None] & \
        ((c - pad_x[:, None, None]).abs() <= _PAD_HALF)
    return (ball_m.to(torch.uint8) * 255
            | pad_m.to(torch.uint8) * 200
            | brick_m.to(torch.uint8) * 120)


def _dead_ball(pad_x: torch.Tensor) -> torch.Tensor:
    """[B, 4] balls resting above the paddle, not moving."""
    zero = torch.zeros_like(pad_x)
    return torch.stack([pad_x, zero + (_PAD_Y - 3.0), zero, zero], dim=1)


class PixelBreakout(TorchEnv):
    num_actions = 4    # NOOP, FIRE, RIGHT, LEFT (ale-py minimal order)
    observation_shape = (_H, _W, 4)
    frame_stack = 4    # rolling stack (envs/base.py contract)
    observation_dtype = torch.uint8

    def __init__(self, device, max_steps: int = 2000):
        super().__init__(device)
        self.max_steps = max_steps

    def draw(self, num_envs: int, generator: torch.Generator
             ) -> BreakoutDraws:
        u = torch.rand(num_envs, generator=generator, device=self.device)
        return BreakoutDraws(serve_vx=u * (2 * _SERVE_VX) - _SERVE_VX)

    def reset(self, draws: BreakoutDraws
              ) -> Tuple[PixelBreakoutState, torch.Tensor]:
        B = draws.serve_vx.shape[0]
        dev = self.device
        pad_x = torch.full((B,), _W / 2.0, device=dev)
        bricks = torch.ones((B, _ROWS, _COLS), device=dev)
        ball = _dead_ball(pad_x)
        in_play = torch.zeros((B,), dtype=torch.bool, device=dev)
        frame = _render(ball, pad_x, bricks, in_play)
        frames = frame[..., None].expand(B, _H, _W, 4).contiguous()
        state = PixelBreakoutState(
            ball=ball, pad_x=pad_x, bricks=bricks,
            lives=torch.full((B,), _LIVES, dtype=torch.int32, device=dev),
            in_play=in_play,
            t=torch.zeros((B,), dtype=torch.int32, device=dev),
            frames=frames)
        return state, frames

    def env_step(self, state: PixelBreakoutState, action: torch.Tensor,
                 draws: BreakoutDraws):
        zero = torch.zeros_like(state.pad_x)
        dx = torch.where(action == 2, zero + _PAD_SPEED,
                         torch.where(action == 3, zero - _PAD_SPEED, zero))
        pad_x = (state.pad_x + dx).clamp(_PAD_HALF, _W - 1.0 - _PAD_HALF)

        # FIRE serves when the ball is dead; otherwise it is a NOOP.
        serve = ~state.in_play & (action == 1)
        served = torch.stack([pad_x, zero + (_PAD_Y - 3.0), draws.serve_vx,
                              zero - _BALL_SPEED_Y], dim=1)
        ball = torch.where(serve[:, None], served, state.ball)
        in_play = state.in_play | serve

        # Ball motion (frozen while not in play) with wall bounces.
        bx = ball[:, 0] + torch.where(in_play, ball[:, 2], zero)
        by = ball[:, 1] + torch.where(in_play, ball[:, 3], zero)
        vx = torch.where((bx <= 1.0) | (bx >= _W - 2.0), -ball[:, 2],
                         ball[:, 2])
        bx = bx.clamp(1.0, _W - 2.0)
        vy = torch.where(by <= 1.0, -ball[:, 3], ball[:, 3])
        by = by.clamp(min=1.0)

        # Brick collision: the cell under the new ball position.
        cell_r, cell_c = _cells(by, bx)
        in_wall = in_play & (by >= _WALL_TOP) & (by < _WALL_BOT) & \
            (bx < _COLS * _BRICK_W)
        lanes = torch.arange(bx.shape[0], device=bx.device)
        hit_brick = in_wall & (state.bricks[lanes, cell_r, cell_c] > 0.5)
        rows = torch.arange(_ROWS, device=bx.device)[None, :, None]
        cols = torch.arange(_COLS, device=bx.device)[None, None, :]
        knocked = hit_brick[:, None, None] & (rows == cell_r[:, None, None]) \
            & (cols == cell_c[:, None, None])
        bricks = torch.where(knocked, torch.zeros_like(state.bricks),
                             state.bricks)
        vy = torch.where(hit_brick, -vy, vy)
        reward = hit_brick.float()

        # Paddle bounce with spin from the hit offset.
        hit_pad = in_play & (by >= _PAD_Y - 1.0) & (vy > 0) & \
            ((bx - pad_x).abs() <= _PAD_HALF + 1.0)
        spin = torch.where(hit_pad, (bx - pad_x) / _PAD_HALF * 0.8, zero)
        vy = torch.where(hit_pad, -vy, vy)
        vx = (vx + spin).clamp(-1.8, 1.8)
        by = torch.where(hit_pad, zero + (_PAD_Y - 1.0), by)

        # Ball lost below the paddle: lose a life, back to serve state.
        lost = in_play & (by >= _H - 2.0)
        lives = state.lives - lost.to(torch.int32)
        in_play = in_play & ~lost
        ball = torch.where(lost[:, None], _dead_ball(pad_x),
                           torch.stack([bx, by, vx, vy], dim=1))

        cleared = bricks.sum(dim=(1, 2)) <= 0.0
        t = state.t + 1
        terminated = (lives <= 0) | cleared
        truncated = (t >= self.max_steps) & ~terminated

        frame = _render(ball, pad_x, bricks, in_play)
        frames = torch.cat([state.frames[..., 1:], frame[..., None]], dim=-1)
        new_state = PixelBreakoutState(
            ball=ball, pad_x=pad_x, bricks=bricks, lives=lives,
            in_play=in_play, t=t, frames=frames)
        return new_state, frames, reward, terminated, truncated
