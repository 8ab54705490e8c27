"""Host (CPU) environment adapters of the Ape-X actors (the port's copy of
``dist_dqn_tpu/envs/gym_adapter.py``): gymnasium vector envs, the Atari
pipeline, and the numpy pixel games.

The batched envs of this package run on the card inside the fused loop;
these are what the actor processes step on the host: ``"CartPole-v1"``
and other gymnasium names (gymnasium is imported only for them), ALE Atari
when ``ale-py`` is present or, with ``DQN_FAKE_ALE=1``, the in-repo fake
(``envs/fake_ale.py``), DM-Control pixels (``envs/dmc_adapter.py``),
``"pong"`` / ``"breakout"`` (the numpy twins of the pixel games),
``"synthstack"`` and the feeder specs (``actors/feeder.py``).

Atari preprocessing follows the Nature/ALE recipe: frame-skip with 2-frame
max-pooling, grayscale, 84x84 resize, 4-frame stacking, reward clipping, in
numpy, so actor processes import no torch.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


# Bilinear sample grids depend only on the source shape; this runs per
# emulator decision on the actor hot path, so they are cached (the
# resize itself is unchanged — identical indices/weights/arithmetic).
_RESIZE_GRIDS: dict = {}


def _resize_grid(h: int, w: int):
    grid = _RESIZE_GRIDS.get((h, w))
    if grid is None:
        ys = (np.arange(84) + 0.5) * h / 84 - 0.5
        xs = (np.arange(84) + 0.5) * w / 84 - 0.5
        y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        # float64 weights, exactly as the uncached version computed them
        # (f32 frame x f64 weight promotes to f64, and the truncation to
        # uint8 must keep seeing the same values).
        wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
        wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
        grid = (y0, y1, x0, x1, wy, wx, (1.0 - wx), (1.0 - wy))
        _RESIZE_GRIDS[(h, w)] = grid
    return grid


def _area_resize_84(frame: np.ndarray) -> np.ndarray:
    """Grayscale [H, W] -> [84, 84] by area averaging (pure numpy).

    Works for ALE's 210x160 frames via interpolation to a 84x multiple grid:
    we use simple bilinear sampling which is indistinguishable for training
    purposes and keeps the actor dependency-free.
    """
    h, w = frame.shape
    y0, y1, x0, x1, wy, wx, one_wx, one_wy = _resize_grid(h, w)
    f = frame.astype(np.float32)
    fy0, fy1 = f[y0], f[y1]
    top = fy0[:, x0] * one_wx + fy0[:, x1] * wx
    bot = fy1[:, x0] * one_wx + fy1[:, x1] * wx
    out = top * one_wy + bot * wy
    return out.astype(np.uint8)


# BT.601 luma weights as a float32 contraction: one BLAS matvec over
# the channel axis is ~4x faster than the broadcast multiply-add chain
# on the actor hot path. Precision note: float32 accumulation can land
# within 1 gray level of the float64 form before the uint8 truncation —
# sub-quantization noise, invisible to training and to the pipeline
# tests (real ALE's own grayscale differs more from these weights).
_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return frame
    return (frame.astype(np.float32) @ _GRAY_W).astype(np.uint8)


class AtariPreprocessing:
    """Single-env Atari pipeline: skip/max-pool/gray/resize/stack/clip,
    plus optional episodic-life termination.

    ``episodic_life=True`` implements the standard EpisodicLifeEnv
    semantics on top of the ``info["lives"]`` counter ale-py reports: a
    life loss is signaled to the agent as ``terminated`` (so value
    bootstrapping stops at the life boundary), but the underlying game
    is NOT reset — the next ``reset()`` continues the same game from the
    life boundary (via a NOOP step) until the real game-over, which does
    a full emulator reset. Games without lives (Pong reports 0) are
    unaffected.
    """

    def __init__(self, env, frame_skip: int = 4, stack: int = 4,
                 clip_rewards: bool = True, episodic_life: bool = False):
        self.env = env
        self.frame_skip = frame_skip
        self.stack = stack
        self.clip_rewards = clip_rewards
        self.episodic_life = episodic_life
        self._frames = np.zeros((84, 84, stack), np.uint8)
        self._lives = 0
        self._real_done = True   # first reset() is always a full reset

    @property
    def num_actions(self) -> int:
        return int(self.env.action_space.n)

    @property
    def frame_stack(self) -> int:
        """Frames stacked on the obs last axis — the dedup negotiation
        input. This adapter GUARANTEES the stream contract
        the dedup codec relies on: each step shifts the stack by one
        frame and a reset repeats the first frame (pinned by
        tests/test_torch_host_envs.py)."""
        return self.stack

    def _obs(self, frame: np.ndarray) -> np.ndarray:
        processed = _area_resize_84(_to_gray(frame))
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], processed[:, :, None]], axis=2)
        return self._frames.copy()

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if self.episodic_life and not self._real_done:
            # Life-loss boundary: continue the SAME game with a NOOP step
            # (full reset would let the agent farm easy starts).
            frame, _, term, trunc, info = self.env.step(0)
            if term or trunc:    # game actually ended on that step
                frame, info = self.env.reset(seed=seed)
        else:
            frame, info = self.env.reset(seed=seed)
        self._lives = int(info.get("lives", 0) or 0)
        self._real_done = False
        processed = _area_resize_84(_to_gray(np.asarray(frame)))
        self._frames = np.repeat(processed[:, :, None], self.stack, axis=2)
        return self._frames.copy()

    def step(self, action: int):
        total_r, terminated, truncated = 0.0, False, False
        info: dict = {}
        last_two: List[np.ndarray] = []
        for _ in range(self.frame_skip):
            frame, r, term, trunc, info = self.env.step(action)
            total_r += float(r)
            last_two.append(np.asarray(frame))
            last_two = last_two[-2:]
            terminated, truncated = term, trunc
            if term or trunc:
                break
        pooled = (np.maximum(*last_two) if len(last_two) == 2
                  else last_two[-1])
        if self.clip_rewards:
            total_r = float(np.clip(total_r, -1.0, 1.0))
        self._real_done = terminated or truncated
        if self.episodic_life:
            lives = int(info.get("lives", 0) or 0)
            if 0 < lives < self._lives and not terminated:
                terminated = True   # life lost: episode ends for the agent
            self._lives = lives
        return self._obs(pooled), total_r, terminated, truncated


class HostVectorEnv:
    """Synchronous vector of host envs with auto-reset, numpy in/out.

    Mirrors the batched envs' ``v_step`` contract (obs / next_obs / reward
    / terminated / truncated).
    """

    def __init__(self, make_fn, num_envs: int, seed: int = 0):
        self.envs = [make_fn() for _ in range(num_envs)]
        self.num_envs = num_envs
        self._seed = seed

    @property
    def num_actions(self) -> int:
        e = self.envs[0]
        return (e.num_actions if hasattr(e, "num_actions")
                else int(e.action_space.n))

    @property
    def frame_stack(self) -> int:
        """Per-env frame-stack depth, 0 when the underlying env does
        not declare one (dedup negotiation then stays off — the safe
        default for envs whose stream contract is unknown)."""
        return int(getattr(self.envs[0], "frame_stack", 0) or 0)

    def reset(self) -> np.ndarray:
        obs = [self._reset_one(e, self._seed + i)
               for i, e in enumerate(self.envs)]
        return np.stack(obs)

    @staticmethod
    def _reset_one(env, seed):
        out = env.reset(seed=seed)
        return out[0] if isinstance(out, tuple) else out

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        np.ndarray]:
        """Returns (obs, next_obs, reward, terminated, truncated); ``obs``
        is post-auto-reset, ``next_obs`` the true pre-reset successor."""
        obs_l, next_l, r_l, te_l, tr_l = [], [], [], [], []
        for env, a in zip(self.envs, actions):
            out = env.step(int(a))
            if len(out) == 5:  # raw gymnasium env
                nxt, r, term, trunc, _ = out
            else:              # AtariPreprocessing
                nxt, r, term, trunc = out
            nxt = np.asarray(nxt)
            if term or trunc:
                obs_l.append(self._reset_one(env, None))
            else:
                obs_l.append(nxt)
            next_l.append(nxt)
            r_l.append(r)
            te_l.append(term)
            tr_l.append(trunc)
        return (np.stack(obs_l), np.stack(next_l),
                np.asarray(r_l, np.float32), np.asarray(te_l),
                np.asarray(tr_l))


class SynthStackedEnv:
    """Tiny synthetic frame-stacked pixel env ("synthstack"): random
    8x8 uint8 frames stacked 4 deep with EXACTLY the AtariPreprocessing
    stream semantics — step shifts the stack by one novel frame, reset
    repeats a fresh frame. It gives the frame-dedup wire an end-to-end
    actor/service run without ale-py: real ``run_actor`` processes
    negotiate dedup
    against it and the service reconstructs stacks at append time.
    Rewards encode a trivial signal (+1 for action matching a frame
    parity bit) so learning-rate smoke assertions stay meaningful."""

    H = W = 8
    STACK = 4
    num_actions = 4
    frame_stack = STACK

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._frames = np.zeros((self.H, self.W, self.STACK), np.uint8)
        self._t = 0

    def _frame(self) -> np.ndarray:
        return self._rng.integers(0, 256, (self.H, self.W)
                                  ).astype(np.uint8)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        f = self._frame()
        self._frames = np.repeat(f[:, :, None], self.STACK, axis=2)
        self._t = 0
        return self._frames.copy(), {}

    def step(self, action):
        f = self._frame()
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], f[:, :, None]], axis=2)
        self._t += 1
        reward = float(int(action) % 2 == int(f[0, 0]) % 2)
        terminated = bool(self._rng.random() < 1 / 150.0)
        truncated = not terminated and self._t >= 400
        return self._frames.copy(), reward, terminated, truncated, {}


# The ale: factory override: a callable game_name -> raw ALE-style env,
# used instead of gymnasium.make when set (or when DQN_FAKE_ALE=1 selects
# the in-repo fake).
_ale_factory = None


def set_ale_factory(factory) -> None:
    """Install (or clear, with None) the ale: env factory override.

    Process-local: the actor processes use the multiprocessing "spawn"
    context and re-import this module, so an injected factory does not
    reach them; it is for single-process callers and adapter tests.
    """
    global _ale_factory
    _ale_factory = factory


def _resolve_ale_factory():
    if _ale_factory is not None:
        return _ale_factory
    import os

    if os.environ.get("DQN_FAKE_ALE") == "1":
        from dist_dqn_tpu_torch.envs.fake_ale import FakeALEEnv

        return FakeALEEnv
    return None


def is_pixel_env(name: str) -> bool:
    """True if ``make_host_env(name)`` yields image observations (CNN torso
    required), with the JAX package's name list."""
    return name in ("pong", "breakout", "feeder:pixel") \
        or name.startswith(("ale:", "dmc:"))


_ALE_MISSING = ("ALE Atari ({game}) needs ale-py, which is not in this "
                "offline image; use the synthetic pixel_pong env, set "
                "DQN_FAKE_ALE=1 for the in-repo fake, or install ale-py")


def make_host_env(name: str, num_envs: int, seed: int = 0,
                  for_eval: bool = False) -> HostVectorEnv:
    """Build a host vector env by name.

    ``"CartPole-v1"`` etc. -> plain gymnasium; ``"ale:<Game>"`` -> ALE with
    Atari preprocessing (requires ale-py, or ``DQN_FAKE_ALE=1`` for the
    in-repo fake; raises a clear error otherwise);
    ``"dmc:<domain>:<task>"`` -> DM-Control pixels with discretized torques
    (envs/dmc_adapter.py); ``"pong"`` / ``"breakout"`` -> the numpy pixel
    games (envs/host_pong.py, envs/host_breakout.py); ``"synthstack"`` ->
    the synthetic stacked env; ``"feeder:pixel"`` / ``"feeder:vector"`` ->
    the feeders' spec envs of random draws (actors/feeder.py).
    """
    if name.startswith("feeder:"):
        from dist_dqn_tpu_torch.actors.feeder import FeederSpecEnv

        return HostVectorEnv(lambda: FeederSpecEnv(name), num_envs,
                             seed=seed)

    if name == "synthstack":
        return HostVectorEnv(SynthStackedEnv, num_envs, seed=seed)

    if name == "pong":
        from dist_dqn_tpu_torch.envs.host_pong import HostPixelPong

        return HostVectorEnv(HostPixelPong, num_envs, seed=seed)

    if name == "breakout":
        from dist_dqn_tpu_torch.envs.host_breakout import HostPixelBreakout

        return HostVectorEnv(HostPixelBreakout, num_envs, seed=seed)

    if name.startswith("dmc:"):
        from dist_dqn_tpu_torch.envs.dmc_adapter import DMCPixelEnv

        parts = name.split(":", 2)
        if len(parts) != 3 or not all(parts[1:]):
            raise ValueError(
                f"DMC env name must be 'dmc:<domain>:<task>', got {name!r}")
        _, domain, task = parts

        def make_fn():
            return DMCPixelEnv(domain, task)

        return HostVectorEnv(make_fn, num_envs, seed=seed)

    if name.startswith("ale:"):
        game = name.split(":", 1)[1]

        def make_fn():
            # Sticky actions and episodic life ride the environment, so
            # they reach spawned actors. Eval envs keep whole-game
            # episodes and raw scores; sticky actions apply to both.
            import os

            sticky = float(os.environ.get("DQN_ALE_STICKY", "0") or 0.0)
            episodic = (os.environ.get("DQN_ALE_EPISODIC_LIFE") == "1"
                        and not for_eval)
            kwargs = ({"repeat_action_probability": sticky} if sticky
                      else {})
            factory = _resolve_ale_factory()
            if factory is not None:
                return AtariPreprocessing(factory(game, **kwargs),
                                          clip_rewards=not for_eval,
                                          episodic_life=episodic)
            try:
                import gymnasium
            except ImportError as e:
                raise NotImplementedError(_ALE_MISSING.format(game=game)) \
                    from e
            try:
                env = gymnasium.make(f"{game}NoFrameskip-v4", **kwargs)
            except gymnasium.error.Error as e:
                raise NotImplementedError(_ALE_MISSING.format(game=game)) \
                    from e
            return AtariPreprocessing(env, clip_rewards=not for_eval,
                                      episodic_life=episodic)
    else:
        import gymnasium

        def make_fn():
            return gymnasium.make(name)

    return HostVectorEnv(make_fn, num_envs, seed=seed)
