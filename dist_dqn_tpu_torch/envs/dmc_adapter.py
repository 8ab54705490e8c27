"""Host DM-Control pixel adapter (twin of
``dist_dqn_tpu/envs/dmc_adapter.py``).

Wraps a ``dm_control`` suite task as a discrete-action pixel env with the
Atari pipeline's interface (envs/gym_adapter.py), so the Ape-X actors step
MuJoCo pixels like ALE frames: grayscale, 84x84, 4-frame stacking.
Rendering uses MuJoCo's EGL backend; without a usable GL platform it raises
``NotImplementedError`` pointing at ``MUJOCO_GL``.

DQN needs discrete actions, so a continuous action space becomes the
{-1, 0, +1}^dim torque grid (3^dim actions, for tasks of at most 4
dimensions), the grid the on-device stand-in (envs/pixel_reacher.py) uses.
Numpy apart from ``dm_control``, which is imported only when an env is
built.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from dist_dqn_tpu_torch.envs.gym_adapter import _area_resize_84, _to_gray


class DMCPixelEnv:
    """Single dm_control task -> discrete-action 84x84x4 pixel env."""

    def __init__(self, domain: str, task: str, frame_skip: int = 4,
                 stack: int = 4, camera_id: int = 0):
        os.environ.setdefault("MUJOCO_GL", "egl")
        try:
            from dm_control import suite
        except ImportError as e:
            raise NotImplementedError(
                "dm_control is not installed; DMC pixel configs need it"
            ) from e
        except Exception as e:
            # On a box without a usable headless GL stack the import
            # itself dies DEEP inside PyOpenGL's EGL binding (an
            # AttributeError, not an ImportError) — translate it to the
            # documented capability error so callers/tests can gate on
            # it instead of crashing on an unrelated-looking traceback.
            raise NotImplementedError(
                "dm_control's render backend failed to import — no "
                "usable headless GL on this machine; set MUJOCO_GL=egl "
                "(or osmesa where available) on a box with GL "
                f"libraries. Original error: {type(e).__name__}: {e}"
            ) from e
        self.env = suite.load(domain, task)
        spec = self.env.action_spec()
        self._dim = int(np.prod(spec.shape))
        if self._dim > 4:
            raise ValueError(
                f"{domain}:{task} has a {self._dim}-dim action space; the "
                "3^dim discretization is only sensible for dim <= 4")
        # Action i -> per-dim torque in {-1, 0, +1}, scaled into the spec.
        grid = np.stack(np.meshgrid(*([np.array([-1.0, 0.0, 1.0])]
                                      * self._dim),
                                    indexing="ij"), -1).reshape(-1, self._dim)
        lo, hi = spec.minimum, spec.maximum
        self._actions = (lo + (grid + 1.0) / 2.0 * (hi - lo)).astype(
            np.float32)
        self.frame_skip = frame_skip
        self.stack = stack
        self.camera_id = camera_id
        self._frames = np.zeros((84, 84, stack), np.uint8)

    @property
    def num_actions(self) -> int:
        return len(self._actions)

    def _pixels(self) -> np.ndarray:
        try:
            frame = self.env.physics.render(height=84, width=84,
                                            camera_id=self.camera_id)
        except Exception as e:
            raise NotImplementedError(
                "MuJoCo headless rendering failed; set MUJOCO_GL=egl (or "
                "osmesa where available)") from e
        return _area_resize_84(_to_gray(frame)) if frame.shape[:2] != (84, 84) \
            else _to_gray(frame)

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.env.task.random.seed(seed)
        self.env.reset()
        frame = self._pixels()
        self._frames = np.repeat(frame[:, :, None], self.stack, axis=2)
        return self._frames.copy()

    def step(self, action: int):
        total_r, last_step = 0.0, None
        for _ in range(self.frame_skip):
            last_step = self.env.step(self._actions[int(action)])
            total_r += float(last_step.reward or 0.0)
            if last_step.last():
                break
        frame = self._pixels()
        self._frames = np.concatenate(
            [self._frames[:, :, 1:], frame[:, :, None]], axis=2)
        # DMC episode ends are time limits (discount == 1.0 -> truncation);
        # discount 0.0 would be a true terminal state.
        ended = last_step.last()
        terminated = bool(ended and last_step.discount == 0.0)
        truncated = bool(ended and not terminated)
        return self._frames.copy(), total_r, terminated, truncated
