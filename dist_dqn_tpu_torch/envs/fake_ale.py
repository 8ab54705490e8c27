"""In-repo fake ALE (twin of ``dist_dqn_tpu/envs/fake_ale.py``): raw
210x160 RGB Atari-API envs for runs without ``ale-py``.

It fakes the layer the ``ale:<Game>`` adapter consumes: the gymnasium env
that ``gymnasium.make("<Game>NoFrameskip-v4")`` returns once ale-py has
registered itself, with raw 210x160x3 uint8 frames at one emulator frame
per ``step()`` and gymnasium's 5-tuple step API. Everything downstream
(``AtariPreprocessing``'s frame skip, max-pool, grayscale, 84x84 resize,
stacking, reward clipping and episodic life; ``HostVectorEnv``; actors;
assembler; replay) runs the code a real ALE install would.
``DQN_FAKE_ALE=1`` routes ``ale:`` names here (envs/gym_adapter.py), and
the route imports no gymnasium.

What it models, the axes on which Atari games differ:

  * minimal action sets of different sizes: Pong the 6-action set (NOOP
    FIRE UP DOWN UPFIRE DOWNFIRE), Breakout the 4-action set (NOOP FIRE
    RIGHT LEFT), as ale-py registers them with ``full_action_space=False``;
  * sticky actions (``repeat_action_probability``, the ALE rule): with
    probability p the env repeats the previous executed action;
  * lives: ``info["lives"]`` on every reset and step; Breakout has 5 lives
    and ends when they run out, Pong reports 0;
  * fire to serve: Breakout holds the ball until FIRE;
  * unclipped raw rewards: Breakout's bricks score 1/4/7 by row depth.

Not modelled: ROMs and their graphics, the full 18-action sets, modes and
difficulties, and ALE's frame pooling beyond what the preprocessing
applies. Pong's dynamics are the numpy Pong's (envs/host_pong.py), scaled
to the 210x160 court and slowed to per-emulator-frame speeds. Numpy only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_H, _W = 210, 160          # ALE raw frame geometry
_PAD_HALF = 10.0
_AGENT_X = 140.0
_OPP_X = 16.0
_BALL_SPEED_X = 0.9        # per raw frame; ~3.6/px per 4-skip decision
_PAD_SPEED = 1.2
_OPP_SPEED = 0.6
_WIN_SCORE = 5
# ALE minimal Pong action set: NOOP, FIRE, RIGHT(up), LEFT(down),
# RIGHTFIRE, LEFTFIRE.
_ACTION_DY = np.array([0.0, 0.0, -_PAD_SPEED, _PAD_SPEED,
                       -_PAD_SPEED, _PAD_SPEED], np.float32)


def _paint_box(img: np.ndarray, y: float, x: float, hy: float, hx: float,
               color) -> None:
    """Fill the integer-pixel set {(r, c): |r-y|<=hy and |c-x|<=hx},
    clipped to the frame — the slice form of a centered-box mask."""
    h, w = img.shape[:2]
    r0 = max(int(np.ceil(y - hy)), 0)
    r1 = min(int(np.floor(y + hy)), h - 1)
    c0 = max(int(np.ceil(x - hx)), 0)
    c1 = min(int(np.floor(x + hx)), w - 1)
    if r0 <= r1 and c0 <= c1:
        img[r0:r1 + 1, c0:c1 + 1] = color


class _DiscreteSpace:
    """The one attribute the adapter reads from gymnasium's action space."""

    def __init__(self, n: int):
        self.n = n

    def sample(self) -> int:
        return int(np.random.randint(self.n))


class _FakeALEBase:
    """Shared fake-emulator chassis: sticky actions, lives reporting,
    frame budget, gymnasium 5-tuple API."""

    metadata = {"render_modes": []}

    def __init__(self, game: str, num_actions: int, max_frames: int,
                 repeat_action_probability: float,
                 court_color=(0, 0, 0)):
        self.game = game
        self.max_frames = max_frames
        self.action_space = _DiscreteSpace(num_actions)
        self.repeat_action_probability = float(repeat_action_probability)
        self._rng = np.random.default_rng(0)
        self._last_action = 0
        self._lives = 0
        self._t = 0
        # Court template: np.full with a color TUPLE broadcasts
        # per-element (~200us); copying a prebuilt frame is ~3us, and
        # the renderer runs every emulator frame.
        self._court = np.empty((_H, _W, 3), np.uint8)
        self._court[:] = court_color

    # subclass hooks ---------------------------------------------------------
    def _reset_game(self) -> None:
        raise NotImplementedError

    def _step_game(self, action: int):
        """-> (reward, terminated). May decrement self._lives."""
        raise NotImplementedError

    def _frame(self) -> np.ndarray:
        raise NotImplementedError

    # gymnasium API ----------------------------------------------------------
    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._last_action = 0
        self._t = 0
        self._reset_game()
        return self._frame(), {"lives": self._lives}

    def step(self, action: int):
        action = min(max(int(action), 0), self.action_space.n - 1)
        # ALE sticky rule: with prob p the PREVIOUS executed action runs
        # and the incoming one is dropped (Machado et al. 2018).
        if self.repeat_action_probability > 0.0 and \
                self._rng.random() < self.repeat_action_probability:
            action = self._last_action
        self._last_action = action
        reward, terminated = self._step_game(action)
        self._t += 1
        truncated = self._t >= self.max_frames and not terminated
        return (self._frame(), float(reward), bool(terminated), truncated,
                {"lives": self._lives})

    def close(self):
        pass


class FakePongEnv(_FakeALEBase):
    """Pong-like: 6-action minimal set, no lives (info lives = 0)."""

    def __init__(self, game: str = "Pong", max_frames: int = 20_000,
                 repeat_action_probability: float = 0.0):
        super().__init__(game, 6, max_frames, repeat_action_probability,
                         court_color=(30, 60, 30))

    def _frame(self) -> np.ndarray:
        """Raw 210x160x3 uint8: dark court, light paddles, white ball.

        Sprites are rectangle SLICES, the exact integer-pixel set of the
        centered-box masks ``|r-y|<=hy & |c-x|<=hx`` (pinned by
        tests/test_fake_ale.py) — O(sprite) instead of O(image) per
        sprite, which matters because the emulator renders every raw
        frame and the host side of the Ape-X split is env-stepping-bound
        on a shared core (benchmarks/apex_split_bench.py)."""
        img = self._court.copy()
        bx, by = float(self._ball[0]), float(self._ball[1])
        _paint_box(img, by, bx, 2.0, 1.5, (236, 236, 236))
        _paint_box(img, self._pad_y, _AGENT_X, _PAD_HALF, 2.0,
                   (92, 186, 92))
        _paint_box(img, self._opp_y, _OPP_X, _PAD_HALF, 2.0,
                   (213, 130, 74))
        return img

    def _serve(self, toward_agent: bool) -> np.ndarray:
        vy = self._rng.uniform(-0.6, 0.6)
        vx = _BALL_SPEED_X if toward_agent else -_BALL_SPEED_X
        return np.array([_W / 2.0, _H / 2.0, vx, vy], np.float32)

    def _reset_game(self) -> None:
        self._ball = self._serve(bool(self._rng.integers(0, 2)))
        self._pad_y = _H / 2.0
        self._opp_y = _H / 2.0
        self._score = [0, 0]
        self._lives = 0   # real ALE Pong reports lives() == 0

    def _step_game(self, action: int):
        # Scalar clamps are python min/max: np.clip on python floats
        # costs ~8us per call through numpy's dispatch machinery, and
        # this runs several times per emulator frame on the actor hot
        # path (identical values either way).
        dy = float(_ACTION_DY[action])
        self._pad_y = min(max(self._pad_y + dy, _PAD_HALF),
                          _H - 1 - _PAD_HALF)
        opp_dy = min(max(float(self._ball[1]) - self._opp_y, -_OPP_SPEED),
                     _OPP_SPEED)
        self._opp_y = min(max(self._opp_y + opp_dy, _PAD_HALF),
                          _H - 1 - _PAD_HALF)

        bx = float(self._ball[0]) + float(self._ball[2])
        by = float(self._ball[1]) + float(self._ball[3])
        vy = -float(self._ball[3]) if (by <= 2.0 or by >= _H - 3.0) \
            else float(self._ball[3])
        by = min(max(by, 2.0), _H - 3.0)
        vx = float(self._ball[2])

        hit_agent = (bx >= _AGENT_X - 2.0 and vx > 0
                     and abs(by - self._pad_y) <= _PAD_HALF + 2.0)
        hit_opp = (bx <= _OPP_X + 2.0 and vx < 0
                   and abs(by - self._opp_y) <= _PAD_HALF + 2.0)
        if hit_agent:
            vy += (by - self._pad_y) / _PAD_HALF * 0.5
            vx, bx = -vx, _AGENT_X - 2.0
        elif hit_opp:
            vy += (by - self._opp_y) / _PAD_HALF * 0.5
            vx, bx = -vx, _OPP_X + 2.0
        vy = min(max(vy, -1.2), 1.2)

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
        return reward, max(self._score) >= _WIN_SCORE


_BK_PAD_Y = 195.0           # paddle row (near the bottom of the court)
_BK_PAD_HALF = 12.0
_BK_PAD_SPEED = 2.0
_BK_ROWS, _BK_COLS = 6, 16
_BK_BRICK_TOP = 60.0        # brick band: rows of height 6 starting here
_BK_BRICK_H = 6.0
# Real Breakout scores 1/1/4/4/7/7 by row depth (bottom row pair = 1).
_BK_ROW_REWARD = np.array([7, 7, 4, 4, 1, 1], np.float32)
_BK_ROW_COLOR = [(200, 72, 72), (198, 108, 58), (180, 122, 48),
                 (162, 162, 42), (72, 160, 72), (66, 72, 200)]
_BK_LIVES = 5


class FakeBreakoutEnv(_FakeALEBase):
    """Breakout-like: 4-action minimal set (NOOP FIRE RIGHT LEFT), 5
    lives with life-loss on a dropped ball, fire-to-serve, row-graded
    unclipped rewards."""

    def __init__(self, game: str = "Breakout", max_frames: int = 20_000,
                 repeat_action_probability: float = 0.0):
        super().__init__(game, 4, max_frames, repeat_action_probability,
                         court_color=(20, 20, 30))

    def _brick_rect(self, row: int, col: int):
        y0 = int(_BK_BRICK_TOP + row * _BK_BRICK_H)
        x0 = int(col * (_W / _BK_COLS))
        return (slice(y0, y0 + int(_BK_BRICK_H) - 1),
                slice(x0, x0 + int(_W / _BK_COLS) - 1))

    def _rebuild_wall(self) -> None:
        """Court + brick band cache: bricks change only on hits, so the
        wall is drawn incrementally (_knock_brick) instead of 96 python
        rect-fills per frame; _frame just copies this and adds the two
        moving sprites."""
        self._wall = self._court.copy()
        for row in range(_BK_ROWS):
            for col in range(_BK_COLS):
                if self._bricks[row, col]:
                    self._wall[self._brick_rect(row, col)] = \
                        _BK_ROW_COLOR[row]

    def _knock_brick(self, row: int, col: int) -> None:
        rect = self._brick_rect(row, col)
        self._wall[rect] = self._court[rect]  # one source of court color

    def _frame(self) -> np.ndarray:
        img = self._wall.copy()
        px = self._pad_x
        img[int(_BK_PAD_Y):int(_BK_PAD_Y) + 4,
            int(max(px - _BK_PAD_HALF, 0)):
            int(min(px + _BK_PAD_HALF, _W - 1))] = (200, 72, 72)
        bx, by = float(self._ball[0]), float(self._ball[1])
        img[int(max(by - 2, 0)):int(min(by + 2, _H - 1)),
            int(max(bx - 2, 0)):int(min(bx + 2, _W - 1))] = (236, 236, 236)
        return img

    def _reset_game(self) -> None:
        self._bricks = np.ones((_BK_ROWS, _BK_COLS), bool)
        self._rebuild_wall()
        self._pad_x = _W / 2.0
        self._lives = _BK_LIVES
        self._held = True          # ball on the paddle until FIRE
        self._ball = np.array([self._pad_x, _BK_PAD_Y - 4.0, 0.0, 0.0],
                              np.float32)

    def _serve(self) -> None:
        vx = self._rng.uniform(0.5, 0.9) * (1 if self._rng.random() < 0.5
                                            else -1)
        self._ball = np.array([self._pad_x, _BK_PAD_Y - 4.0, vx, -1.0],
                              np.float32)
        self._held = False

    def _step_game(self, action: int):
        # Minimal Breakout set: 0 NOOP, 1 FIRE, 2 RIGHT, 3 LEFT.
        dx = _BK_PAD_SPEED if action == 2 else \
            (-_BK_PAD_SPEED if action == 3 else 0.0)
        self._pad_x = min(max(self._pad_x + dx, _BK_PAD_HALF),
                          _W - 1 - _BK_PAD_HALF)
        if self._held:
            if action == 1:
                self._serve()
            else:
                self._ball[0] = self._pad_x  # ball rides the paddle
                return 0.0, False
        bx = float(self._ball[0] + self._ball[2])
        by = float(self._ball[1] + self._ball[3])
        vx, vy = float(self._ball[2]), float(self._ball[3])
        if bx <= 2.0 or bx >= _W - 3.0:
            vx = -vx
            bx = min(max(bx, 2.0), _W - 3.0)
        if by <= 2.0:
            vy, by = -vy, 2.0
        reward = 0.0
        # Brick collision at the ball's row/col in the brick band.
        row = int((by - _BK_BRICK_TOP) // _BK_BRICK_H)
        col = int(bx // (_W / _BK_COLS))
        if 0 <= row < _BK_ROWS and 0 <= col < _BK_COLS \
                and self._bricks[row, col]:
            self._bricks[row, col] = False
            self._knock_brick(row, col)
            reward = float(_BK_ROW_REWARD[row])
            vy = -vy
            if not self._bricks.any():      # level cleared: fresh wall
                self._bricks[:] = True
                self._rebuild_wall()
        # Paddle bounce (ball moving down through the paddle row).
        if vy > 0 and by >= _BK_PAD_Y - 2.0 \
                and abs(bx - self._pad_x) <= _BK_PAD_HALF + 2.0:
            vy = -vy
            vx += (bx - self._pad_x) / _BK_PAD_HALF * 0.6
            vx = min(max(vx, -1.5), 1.5)
            by = _BK_PAD_Y - 2.0
        terminated = False
        if by >= _H - 3.0:                  # dropped ball: life lost
            self._lives -= 1
            terminated = self._lives <= 0
            self._held = True
            self._ball = np.array([self._pad_x, _BK_PAD_Y - 4.0, 0.0, 0.0],
                                  np.float32)
        else:
            self._ball = np.array([bx, by, vx, vy], np.float32)
        return reward, terminated


_GAMES = {"Pong": FakePongEnv, "Breakout": FakeBreakoutEnv}


def FakeALEEnv(game: str = "Pong", max_frames: int = 20_000,
               repeat_action_probability: float = 0.0):
    """Factory with the ``ale:`` injection contract (gym_adapter.py):
    game name -> raw ALE-style env. Unknown games get Pong dynamics under
    the requested name (any ``ale:<Game>`` string must keep working)."""
    cls = _GAMES.get(game, FakePongEnv)
    return cls(game, max_frames=max_frames,
               repeat_action_probability=repeat_action_probability)
