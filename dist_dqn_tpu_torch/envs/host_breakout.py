"""Host (numpy) PixelBreakout (the port's copy of
``dist_dqn_tpu/envs/host_breakout.py``): the numpy twin of the batched
``envs/pixel_breakout.py`` that the Ape-X actor processes step. Same
dynamics, action semantics (NOOP, FIRE, RIGHT, LEFT), fire-to-serve, lives,
brick wall and rasterization. Numpy only: actor processes import no torch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_H = _W = 84
_ROWS, _COLS = 6, 12
_BRICK_H, _BRICK_W = 3, 7
_WALL_TOP = 18.0
_WALL_BOT = _WALL_TOP + _ROWS * _BRICK_H
_PAD_Y = 78.0
_PAD_HALF = 4.0
_PAD_SPEED = 3.0
_BALL_SPEED_Y = 2.0
_LIVES = 5


class HostPixelBreakout:
    """Single-env numpy PixelBreakout with the AtariPreprocessing
    interface: reset(seed) -> obs; step(a) -> (obs, reward, terminated,
    truncated)."""

    num_actions = 4

    def __init__(self, max_steps: int = 2000, stack: int = 4):
        self.max_steps = max_steps
        self.stack = stack
        self._rng = np.random.default_rng(0)

    def _render(self) -> np.ndarray:
        r = np.arange(_H, dtype=np.float32)[:, None]
        c = np.arange(_W, dtype=np.float32)[None, :]
        cell_r = np.clip(((r - _WALL_TOP) // _BRICK_H).astype(np.int32),
                         0, _ROWS - 1)
        cell_c = np.clip((c // _BRICK_W).astype(np.int32), 0, _COLS - 1)
        in_wall = (r >= _WALL_TOP) & (r < _WALL_BOT)
        brick_m = in_wall & (self._bricks[cell_r, cell_c] > 0.5) \
            & (c < _COLS * _BRICK_W)
        bx, by = self._ball[0], self._ball[1]
        ball_m = self._in_play & (np.abs(r - by) <= 1.0) \
            & (np.abs(c - bx) <= 1.0)
        pad_m = (np.abs(r - _PAD_Y) <= 1.0) \
            & (np.abs(c - self._pad_x) <= _PAD_HALF)
        return (ball_m.astype(np.uint8) * 255
                | pad_m.astype(np.uint8) * 200
                | brick_m.astype(np.uint8) * 120)

    def _dead_ball(self) -> np.ndarray:
        return np.array([self._pad_x, _PAD_Y - 3.0, 0.0, 0.0], np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._pad_x = _W / 2.0
        self._bricks = np.ones((_ROWS, _COLS), np.float32)
        self._lives = _LIVES
        self._in_play = False
        self._ball = self._dead_ball()
        self._t = 0
        frame = self._render()
        self._frames = np.repeat(frame[:, :, None], self.stack, axis=2)
        return self._frames.copy()

    def step(self, action: int):
        a = min(max(int(action), 0), 3)
        dx = _PAD_SPEED if a == 2 else (-_PAD_SPEED if a == 3 else 0.0)
        self._pad_x = float(np.clip(self._pad_x + dx, _PAD_HALF,
                                    _W - 1.0 - _PAD_HALF))

        if not self._in_play and a == 1:   # FIRE serves
            vx = float(self._rng.uniform(-1.2, 1.2))
            self._ball = np.array([self._pad_x, _PAD_Y - 3.0, vx,
                                   -_BALL_SPEED_Y], np.float32)
            self._in_play = True

        reward = 0.0
        if self._in_play:
            bx = self._ball[0] + self._ball[2]
            by = self._ball[1] + self._ball[3]
            vx = -self._ball[2] if (bx <= 1.0 or bx >= _W - 2.0) \
                else self._ball[2]
            bx = float(np.clip(bx, 1.0, _W - 2.0))
            vy = -self._ball[3] if by <= 1.0 else self._ball[3]
            by = max(by, 1.0)

            if _WALL_TOP <= by < _WALL_BOT and bx < _COLS * _BRICK_W:
                cr = int(np.clip((by - _WALL_TOP) // _BRICK_H,
                                 0, _ROWS - 1))
                cc = int(np.clip(bx // _BRICK_W, 0, _COLS - 1))
                if self._bricks[cr, cc] > 0.5:
                    self._bricks[cr, cc] = 0.0
                    vy = -vy
                    reward = 1.0

            if by >= _PAD_Y - 1.0 and vy > 0 \
                    and abs(bx - self._pad_x) <= _PAD_HALF + 1.0:
                vy = -vy
                vx = float(np.clip(
                    vx + (bx - self._pad_x) / _PAD_HALF * 0.8, -1.8, 1.8))
                by = _PAD_Y - 1.0

            if by >= _H - 2.0:             # ball lost below the paddle
                self._lives -= 1
                self._in_play = False
                self._ball = self._dead_ball()
            else:
                self._ball = np.array([bx, by, vx, vy], np.float32)

        self._t += 1
        cleared = float(self._bricks.sum()) <= 0.0
        terminated = self._lives <= 0 or cleared
        truncated = self._t >= self.max_steps and not terminated
        frame = self._render()
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], frame[:, :, None]], axis=2)
        return self._frames.copy(), reward, terminated, truncated
