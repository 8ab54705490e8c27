"""Host (numpy) PixelPong (the port's copy of
``dist_dqn_tpu/envs/host_pong.py``): the numpy twin of the batched
``envs/pixel_pong.py`` that the Ape-X actor processes step. Same dynamics,
action semantics and rasterization; 84x84x4 uint8 frame stacks, the byte
layout ALE would produce. Numpy only: actor processes import no torch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_H = _W = 84
_PAD_HALF = 4
_AGENT_X = 78.0
_OPP_X = 4.0
_BALL_SPEED_X = 1.6
_PAD_SPEED = 2.0
_OPP_SPEED = 1.0
_WIN_SCORE = 5
_ACTION_DY = np.array([0.0, 0.0, -_PAD_SPEED, _PAD_SPEED,
                       -_PAD_SPEED, _PAD_SPEED], np.float32)


class HostPixelPong:
    """Single-env numpy PixelPong with the AtariPreprocessing interface:
    reset(seed) -> obs; step(a) -> (obs, reward, terminated, truncated)."""

    num_actions = 6

    def __init__(self, max_steps: int = 2000, stack: int = 4):
        self.max_steps = max_steps
        self.stack = stack
        self._rng = np.random.default_rng(0)

    def _render(self) -> np.ndarray:
        r = np.arange(_H, dtype=np.float32)[:, None]
        c = np.arange(_W, dtype=np.float32)[None, :]
        bx, by = self._ball[0], self._ball[1]
        ball_m = (np.abs(r - by) <= 1.0) & (np.abs(c - bx) <= 1.0)
        pad_m = (np.abs(r - self._pad_y) <= _PAD_HALF) \
            & (np.abs(c - _AGENT_X) <= 1.0)
        opp_m = (np.abs(r - self._opp_y) <= _PAD_HALF) \
            & (np.abs(c - _OPP_X) <= 1.0)
        return (ball_m.astype(np.uint8) * 255
                | pad_m.astype(np.uint8) * 200
                | opp_m.astype(np.uint8) * 200)

    def _serve(self, toward_agent: bool) -> np.ndarray:
        vy = self._rng.uniform(-1.0, 1.0)
        vx = _BALL_SPEED_X if toward_agent else -_BALL_SPEED_X
        return np.array([_W / 2.0, _H / 2.0, vx, vy], np.float32)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ball = self._serve(bool(self._rng.integers(0, 2)))
        self._pad_y = _H / 2.0
        self._opp_y = _H / 2.0
        self._score = [0, 0]
        self._t = 0
        frame = self._render()
        self._frames = np.repeat(frame[:, :, None], self.stack, axis=2)
        return self._frames.copy()

    def step(self, action: int):
        dy = _ACTION_DY[min(max(int(action), 0), 5)]
        self._pad_y = float(np.clip(self._pad_y + dy, _PAD_HALF,
                                    _H - 1 - _PAD_HALF))
        opp_dy = float(np.clip(self._ball[1] - self._opp_y, -_OPP_SPEED,
                               _OPP_SPEED))
        self._opp_y = float(np.clip(self._opp_y + opp_dy, _PAD_HALF,
                                    _H - 1 - _PAD_HALF))

        bx = self._ball[0] + self._ball[2]
        by = self._ball[1] + self._ball[3]
        vy = -self._ball[3] if (by <= 1.0 or by >= _H - 2.0) \
            else self._ball[3]
        by = float(np.clip(by, 1.0, _H - 2.0))
        vx = self._ball[2]

        hit_agent = (bx >= _AGENT_X - 1.0 and vx > 0
                     and abs(by - self._pad_y) <= _PAD_HALF + 1.0)
        hit_opp = (bx <= _OPP_X + 1.0 and vx < 0
                   and abs(by - self._opp_y) <= _PAD_HALF + 1.0)
        if hit_agent:
            vy += (by - self._pad_y) / _PAD_HALF * 0.8
            vx, bx = -vx, _AGENT_X - 1.0
        elif hit_opp:
            vy += (by - self._opp_y) / _PAD_HALF * 0.8
            vx, bx = -vx, _OPP_X + 1.0
        vy = float(np.clip(vy, -1.8, 1.8))

        agent_point = bx <= 1.0
        opp_point = bx >= _W - 2.0
        reward = 1.0 if agent_point else (-1.0 if opp_point else 0.0)
        if agent_point:
            self._score[0] += 1
        if opp_point:
            self._score[1] += 1
        if agent_point or opp_point:
            self._ball = self._serve(toward_agent=opp_point)
        else:
            self._ball = np.array([bx, by, vx, vy], np.float32)

        self._t += 1
        terminated = max(self._score) >= _WIN_SCORE
        truncated = self._t >= self.max_steps and not terminated
        frame = self._render()
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], frame[:, :, None]], axis=2)
        return self._frames.copy(), reward, terminated, truncated
